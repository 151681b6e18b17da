// Exact forward of the multiresolution hash-grid encoder on Hopper (sm_90a).
//
//   out[m, l*C + c] = sum_k w[m, l, k] * table[row[m, l, k], c]     (0 for a point
//                                                                     outside [0, 1]^3)
//
// with, for each point m, level l and corner k of its cell (bit d of k: the corner's
// offset along dimension d), the corner's global table row and trilinear weight. The
// plain version is palettenerf_torch/ops/hashgrid_fast.py:_encode_plain, eager PyTorch
// that builds every corner's row and weight as its own [M, L] tensor (about 320 launches
// a pass) and stacks them before one gather. This kernel replaces no TPU kernel: the JAX
// package leaves that forward to XLA. It was added because the eager version held most
// of the device time of every path that runs the network.
//
// What bounds it on an H100: the gathers. The only traffic to device memory it must make
// is 12 bytes of coordinates in and 4 * L * C bytes of features out per point, plus
// 8 * L * 8 bytes of residuals (rows and weights) when a backward follows: 140 bytes a
// point at 16 levels x 2 (1164 with residuals). The 8 * L corner rows it reads per point
// come from the table (6,119,864 x 2 f32 = 49 MB at full width), which the 50 MB L2
// mostly holds. What the design does about it:
//
// 1. Nothing leaves registers: one thread computes one (point, level)'s cell, its 8
//    corners' rows and weights, gathers the 8 rows (one vector load each, all 8 in
//    flight) and accumulates them. Only the features, and with a backward the rows and
//    weights, are written.
// 2. One thread per (point, level), the level the fastest index: a warp holds 32 / L
//    points, its stores of features and residuals are one contiguous run, and its loads
//    spread over L levels of the table. The per-level constants are copied once per
//    block into shared memory.
// 3. A point outside the box gathers nothing (its features are zero).
//
// Tried on the card and dropped, because it was slower at every shape of the path (by
// 11-70%; PERF.md): a warp per level of 32 consecutive points, which groups the dense
// levels' gathers of neighbouring points but scatters the warp's stores.
//
// Bit for bit the plain version's result: the index arithmetic in uint32 (what the plain
// version's int64 arithmetic masked with 0xFFFFFFFF gives), every float operation rounded
// on its own with the _rn intrinsics, so that nothing is contracted into an FMA: pos = x *
// scale, then + 0.5 (0 with align_corners); the weight 1 * w_0 * w_1 * w_2 in dimension
// order, w_d = frac_d or 1 - frac_d; acc = 0, then acc + row_k * w_k for k = 0..7.
// Rows are in range by construction (each level's row is taken modulo its size in
// unsigned arithmetic, whatever the coordinates, NaN and inf included), so the kernel
// never reads outside the table and needs no refused-row counter.
//
// The caller (palettenerf_torch/ops/hashgrid_fast.py:encode_kernel) allocates every
// output, passes the per-level constants from the host (no upload) and launches on
// PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr int kDims = 3;
constexpr int kCorners = 1 << kDims;

// The hash's prime of dimension d (d is a constant once the loops are unrolled).
__device__ __forceinline__ uint32_t prime(int d) {
  return d == 0 ? 1u : d == 1 ? 2654435761u : 805459861u;
}

struct Levels {
  float scale[kMaxLevels];
  uint32_t size[kMaxLevels];
  uint32_t offset[kMaxLevels];
  uint32_t stride[kMaxLevels][kDims];  // 0 past the level's overflow
  uint32_t hashed;                     // bit l: level l hashes its corners
  int count;
};

// C floats of one table row, loaded as one word (two for C = 8).
template <int C>
struct alignas(C >= 4 ? 16 : 4 * C) Row {
  float v[C];
};

template <int C>
__global__ void __launch_bounds__(kThreads)
hashgrid_encode_kernel(const float* __restrict__ x, const float* __restrict__ table,
                       const __grid_constant__ Levels levels, float half, int64_t n_points,
                       float* __restrict__ out, int32_t* __restrict__ idx_out,
                       float* __restrict__ w_out, uint8_t* __restrict__ oob_out) {
  __shared__ Levels lv;
  {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(&levels);
    uint32_t* dst = reinterpret_cast<uint32_t*>(&lv);
    for (int i = threadIdx.x; i < (int)(sizeof(Levels) / 4); i += kThreads) dst[i] = src[i];
  }
  __syncthreads();
  const int L = lv.count;
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;  // (point, level)
  if (g >= n_points * L) return;
  const int64_t m = g / L;
  const int l = (int)(g - m * L);

  float xd[kDims];
  bool oob = false;
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    xd[d] = x[m * kDims + d];
    oob |= xd[d] < 0.0f || xd[d] > 1.0f;
  }
  const float scale = lv.scale[l];
  uint32_t p0[kDims];
  float frac[kDims], rest[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    const float pos = __fadd_rn(__fmul_rn(xd[d], scale), half);
    const float cell = floorf(pos);
    // as the plain version's int64 cast (saturating, NaN to 0), then its low 32 bits
    p0[d] = (uint32_t)(long long)cell;
    frac[d] = __fsub_rn(pos, cell);
    rest[d] = __fsub_rn(1.0f, frac[d]);
  }
  const uint32_t size = lv.size[l], offset = lv.offset[l];
  const bool hashed = (lv.hashed >> l) & 1u;

  int32_t row[kCorners];
  float w[kCorners];
#pragma unroll
  for (int k = 0; k < kCorners; ++k) {
    uint32_t lin = 0, h = 0;
    float wk = 1.0f;
#pragma unroll
    for (int d = 0; d < kDims; ++d) {
      const uint32_t bit = (k >> d) & 1;
      const uint32_t p = p0[d] + bit;
      lin += p * lv.stride[l][d];
      h ^= p * prime(d);
      wk = __fmul_rn(wk, bit ? frac[d] : rest[d]);
    }
    row[k] = (int32_t)((hashed ? h : lin) % size + offset);
    w[k] = wk;
  }

  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  if (!oob) {
    Row<C> r[kCorners];
#pragma unroll
    for (int k = 0; k < kCorners; ++k)
      r[k] = *(reinterpret_cast<const Row<C>*>(table) + row[k]);
#pragma unroll
    for (int k = 0; k < kCorners; ++k)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = __fadd_rn(acc[c], __fmul_rn(r[k].v[c], w[k]));
  }
  Row<C> o;
#pragma unroll
  for (int c = 0; c < C; ++c) o.v[c] = acc[c];
  reinterpret_cast<Row<C>*>(out)[g] = o;

  if (idx_out != nullptr) {
    int4* ip = reinterpret_cast<int4*>(idx_out + g * kCorners);
    float4* wp = reinterpret_cast<float4*>(w_out + g * kCorners);
    ip[0] = make_int4(row[0], row[1], row[2], row[3]);
    ip[1] = make_int4(row[4], row[5], row[6], row[7]);
    wp[0] = make_float4(w[0], w[1], w[2], w[3]);
    wp[1] = make_float4(w[4], w[5], w[6], w[7]);
    if (l == 0) oob_out[m] = oob;
  }
}

template <int C>
int launch(const float* x, const float* table, const Levels& levels, float half,
           int64_t n_points, float* out, int32_t* idx, float* w, uint8_t* oob,
           cudaStream_t s) {
  const int64_t blocks = (n_points * levels.count + kThreads - 1) / kThreads;
  hashgrid_encode_kernel<C><<<(unsigned int)blocks, kThreads, 0, s>>>(
      x, table, levels, half, n_points, out, idx, w, oob);
  return (int)cudaGetLastError();
}

}  // namespace

// x [n_points, 3] f32; table [total_rows, channels] f32; per level l < n_levels: its
// scale (f32), table size, first row, strides [n_levels, 3] (0 past the overflow) and
// hashed (0 or 1). half: 0.5, or 0 with align_corners. out [n_points, n_levels *
// channels] f32. idx [n_points, n_levels, 8] int32, w (the same, f32) and oob
// [n_points] uint8: all three or none (no residuals). Every pointer is aligned to the
// word the kernel moves (a row of `channels` floats, at most 16 bytes). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int hashgrid_encode(const void* x, const void* table, long long total_rows,
                               int channels, int n_levels, const float* scales,
                               const long long* sizes, const long long* offsets,
                               const long long* strides, const int* hashed, float half,
                               long long n_points, void* out, void* idx, void* w, void* oob,
                               void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || total_rows < 1 || total_rows > INT32_MAX ||
      n_points < 0 || (idx == nullptr) != (w == nullptr) || (idx == nullptr) != (oob == nullptr))
    return (int)cudaErrorInvalidValue;
  Levels levels = {};
  levels.count = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    if (sizes[l] < 1 || offsets[l] < 0 || offsets[l] + sizes[l] > total_rows)
      return (int)cudaErrorInvalidValue;
    levels.scale[l] = scales[l];
    levels.size[l] = (uint32_t)sizes[l];
    levels.offset[l] = (uint32_t)offsets[l];
    for (int d = 0; d < kDims; ++d) levels.stride[l][d] = (uint32_t)strides[l * kDims + d];
    if (hashed[l]) levels.hashed |= 1u << l;
  }
  if (n_points == 0) return 0;
  const float* xp = (const float*)x;
  const float* tp = (const float*)table;
  float* op = (float*)out;
  int32_t* ip = (int32_t*)idx;
  float* wp = (float*)w;
  uint8_t* bp = (uint8_t*)oob;
  cudaStream_t s = (cudaStream_t)stream;
  switch (channels) {
    case 1: return launch<1>(xp, tp, levels, half, n_points, op, ip, wp, bp, s);
    case 2: return launch<2>(xp, tp, levels, half, n_points, op, ip, wp, bp, s);
    case 4: return launch<4>(xp, tp, levels, half, n_points, op, ip, wp, bp, s);
    case 8: return launch<8>(xp, tp, levels, half, n_points, op, ip, wp, bp, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
