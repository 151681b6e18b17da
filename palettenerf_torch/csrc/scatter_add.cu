// Dense scatter-add for the hash-grid backward on Hopper (sm_90a).
//
//   out[idx[u], c] += vals[u, c]      u < n_updates, c < channels
//
// Replaces the Pallas TPU kernel palettenerf_tpu/ops/pallas_scatter.py:tile_scatter_add.
// That kernel sorts the update stream and accumulates it with one-hot MXU matmuls per
// 4096-row tile because scatters are slow on the TPU. None of that carries over: a
// radix sort of the 33.5 M (row, value) pairs of one train step would by itself cost
// several times what this whole kernel takes on an H100, so nothing is sorted here.
//
// What bounds it on an H100: first the atomic units in L2 and the lines L2 loses, then
// bytes. The bytes are one read of the stream, U * (4 + 2C) (int32 row + C bf16 values),
// plus the f32 output, total_rows * C * 4: 317 MB on the train path (U = 33,554,432,
// C = 2, 6,119,864 rows), 0.095 ms at 3.35 TB/s. A kernel that sends one scalar
// atomicAdd per value takes ten times that, because every atomic is resolved in L2, one
// after the other per address: the count of atomics, and the chains of them that hit
// one row, set the pace. What the design does about it, each step timed on the card:
//
// 1. One vector atomic per update row. The kernels are specialised on C = 1, 2, 4, 8:
//    the C bf16 values of a row are loaded as one word and added with one
//    atomicAdd(float2*) / atomicAdd(float4*) (red.global.add.v2/v4.f32 on sm_90)
//    instead of C scalar ones.
// 2. An update whose values are all zero is dropped (adding it changes nothing). The
//    trainer's padded sample slots (rays that left the occupied cells early) all sit at
//    one point and carry zero cotangents: a long same-address chain that does no work,
//    and most of the stream of a trained field. What is left of such a stream is bound
//    by its loads, so each thread keeps a batch of them in flight.
// 3. One part of the table at a time (scatter_add_columns). The hash-grid backward hands
//    over [points, period] rows: period = levels * corners, column = level * corners + corner.
//    The table (49 MB on the train path) does not stay in the 50 MB L2 while 268 MB of
//    stream pass through it, and an atomic on a line that L2 has lost costs a 32-byte
//    read and a 32-byte write-back of device memory. So one thread owns one column and
//    walks kWalk consecutive points of it, a warp's 32 threads read 32 neighbouring
//    columns of a point (whole 128-byte lines of idx and vals), and the warps are ordered
//    by group of 32 columns (4 levels of 8 corners) first, by chunk of points second: at
//    any moment the atomics fall into a few levels' rows (<= 16 MB), which L2 keeps.
//
// Tried on the card and dropped, because it bought nothing on either stream once steps
// 2 and 3 were in: summing, in registers before the atomic, the run of equal rows that
// neighbouring samples of a ray give one column (they share a grid cell on the coarse
// levels).
//
// Without a period (scatter_add_rows) steps 1 and 2 apply alone. Any other C takes
// scatter_add_scalar, which keeps the first design (one thread per row, a run-time
// channel loop, scalar atomics) and is the yardstick the others are timed against.
//
// idx and vals are read once and go through the cache as streaming loads
// (ld.global.cs), so that they displace as little of the table as can be.
//
// A row outside [0, total_rows) is never written: the kernel adds one to *fault
// instead. The caller (palettenerf_torch/ops/scatter.py) zero-fills `out`, owns the
// fault counter, reads it where the host synchronises anyway, and launches on
// PyTorch's current stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWalk = 16;  // consecutive points one thread of scatter_add_columns walks

// Blocks that fill the current device once for `kernel`: resident blocks per SM x SMs.
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int blocks = sms * per_sm;
  return blocks > 0 ? blocks : 1;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// The C bf16 values of update u, loaded as one word and widened to f32.
template <int C>
__device__ __forceinline__ void load_vals(const __nv_bfloat16* __restrict__ vals, int64_t u,
                                          float (&v)[C]) {
  if constexpr (C == 1) {
    v[0] = bf16_bits_to_float(__ldcs(reinterpret_cast<const unsigned short*>(vals) + u));
  } else if constexpr (C == 2) {
    const unsigned int w = __ldcs(reinterpret_cast<const unsigned int*>(vals) + u);
    v[0] = bf16_bits_to_float(w & 0xffffu);
    v[1] = __uint_as_float(w & 0xffff0000u);
  } else if constexpr (C == 4) {
    const uint2 w = __ldcs(reinterpret_cast<const uint2*>(vals) + u);
    v[0] = bf16_bits_to_float(w.x & 0xffffu);
    v[1] = __uint_as_float(w.x & 0xffff0000u);
    v[2] = bf16_bits_to_float(w.y & 0xffffu);
    v[3] = __uint_as_float(w.y & 0xffff0000u);
  } else {
    static_assert(C == 8, "vector loads exist for C = 1, 2, 4, 8");
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(vals) + u);
    const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = bf16_bits_to_float(words[i] & 0xffffu);
      v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
    }
  }
}

template <int C>
__device__ __forceinline__ bool any_nonzero(const float (&v)[C]) {
  bool nz = false;
#pragma unroll
  for (int c = 0; c < C; ++c) nz |= (v[c] != 0.0f);
  return nz;
}

// out[row, :] += v as one vector atomic (two for C = 8). `row` is in range.
template <int C>
__device__ __forceinline__ void add_row(float* __restrict__ out, int row, const float (&v)[C]) {
  if constexpr (C == 1) {
    atomicAdd(out + row, v[0]);
  } else if constexpr (C == 2) {
    atomicAdd(reinterpret_cast<float2*>(out) + row, make_float2(v[0], v[1]));
  } else if constexpr (C == 4) {
    atomicAdd(reinterpret_cast<float4*>(out) + row, make_float4(v[0], v[1], v[2], v[3]));
  } else {
    float4* o = reinterpret_cast<float4*>(out) + 2 * (int64_t)row;
    atomicAdd(o, make_float4(v[0], v[1], v[2], v[3]));
    atomicAdd(o + 1, make_float4(v[4], v[5], v[6], v[7]));
  }
}

__device__ __forceinline__ bool row_in_range(int row, int total_rows) {
  return (unsigned int)row < (unsigned int)total_rows;
}

// First design, any channel count: one thread per update row, one scalar atomic per value.
__global__ void __launch_bounds__(kThreads)
scatter_add_scalar(const int32_t* __restrict__ idx, const __nv_bfloat16* __restrict__ vals,
                   float* __restrict__ out, int64_t n_updates, int channels, int total_rows,
                   int* __restrict__ fault) {
  const int64_t step = (int64_t)blockDim.x * gridDim.x;
  for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; u < n_updates; u += step) {
    const int row = idx[u];
    if (!row_in_range(row, total_rows)) {
      atomicAdd(fault, 1);
      continue;
    }
    const __nv_bfloat16* v = vals + u * channels;
    float* o = out + (int64_t)row * channels;
    for (int c = 0; c < channels; ++c) atomicAdd(o + c, __bfloat162float(v[c]));
  }
}

template <int C>
__device__ __forceinline__ void emit_row(float* __restrict__ out, int row, const float (&v)[C],
                                         int total_rows, int* __restrict__ fault) {
  if (!row_in_range(row, total_rows)) {
    atomicAdd(fault, 1);
  } else if (any_nonzero<C>(v)) {
    add_row<C>(out, row, v);
  }
}

// One thread per update row, one vector atomic per nonzero row; four rows in flight.
template <int C>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows(const int32_t* __restrict__ idx, const __nv_bfloat16* __restrict__ vals,
                 float* __restrict__ out, int64_t n_updates, int total_rows,
                 int* __restrict__ fault) {
  constexpr int kInFlight = 4;
  const int64_t step = (int64_t)blockDim.x * gridDim.x;
  int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; u + (kInFlight - 1) * step < n_updates; u += kInFlight * step) {
    int row[kInFlight];
    float v[kInFlight][C];
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) {
      row[k] = __ldcs(idx + u + k * step);
      load_vals<C>(vals, u + k * step, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kInFlight; ++k) emit_row<C>(out, row[k], v[k], total_rows, fault);
  }
  for (; u < n_updates; u += step) {
    float v[C];
    load_vals<C>(vals, u, v);
    emit_row<C>(out, __ldcs(idx + u), v, total_rows, fault);
  }
}

// idx, vals seen as [n_points, period]: thread (chunk, column) walks points
// [chunk * kWalk, (chunk + 1) * kWalk) of its column, one vector atomic per nonzero row.
// Neighbouring threads hold neighbouring columns of the same points; warps are ordered
// by group of 32 columns first, by chunk second.
template <int C>
__global__ void __launch_bounds__(kThreads)
scatter_add_columns(const int32_t* __restrict__ idx, const __nv_bfloat16* __restrict__ vals,
                    float* __restrict__ out, int64_t n_points, int period, int total_rows,
                    int* __restrict__ fault) {
  constexpr int kBatch = C == 8 ? 4 : 8;  // loads in flight per thread
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_chunks = (n_points + kWalk - 1) / kWalk;
  const int64_t warp = g >> 5;
  const int64_t group = warp / n_chunks;
  const int64_t chunk = warp - group * n_chunks;
  const int col = (int)group * 32 + (int)(g & 31);
  if (col >= period) return;
  const int64_t p_begin = chunk * kWalk;
  if (p_begin >= n_points) return;
  const int64_t p_end = p_begin + kWalk < n_points ? p_begin + kWalk : n_points;

  for (int64_t p = p_begin; p < p_end; p += kBatch) {
    int row[kBatch];
    float v[kBatch][C];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      // past the end the last point is loaded again (and not used): the loads carry no
      // condition, so all of a batch are in flight at once
      const int64_t u = (p + k < p_end ? p + k : p_end - 1) * period + col;
      row[k] = __ldcs(idx + u);
      load_vals<C>(vals, u, v[k]);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (p + k < p_end) emit_row<C>(out, row[k], v[k], total_rows, fault);
  }
}

template <int C>
void launch_rows(const int32_t* idx, const __nv_bfloat16* vals, float* out, int64_t n,
                 int total_rows, int* fault, cudaStream_t s) {
  const int resident = resident_blocks(scatter_add_rows<C>);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  scatter_add_rows<C><<<(unsigned int)blocks, kThreads, 0, s>>>(idx, vals, out, n, total_rows,
                                                                fault);
}

template <int C>
void launch_columns(const int32_t* idx, const __nv_bfloat16* vals, float* out, int64_t n,
                    int period, int total_rows, int* fault, cudaStream_t s) {
  const int64_t n_points = n / period;
  const int64_t chunks = (n_points + kWalk - 1) / kWalk;
  const int64_t threads = chunks * ((period + 31) / 32) * 32;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  scatter_add_columns<C><<<(unsigned int)blocks, kThreads, 0, s>>>(idx, vals, out, n_points,
                                                                   period, total_rows, fault);
}

// Calls launcher<C>(...) for the run-time `channels`, one of 1, 2, 4, 8.
#define FOR_CHANNELS(launcher, ...)            \
  switch (channels) {                          \
    case 1: launcher<1>(__VA_ARGS__); break;   \
    case 2: launcher<2>(__VA_ARGS__); break;   \
    case 4: launcher<4>(__VA_ARGS__); break;   \
    default: launcher<8>(__VA_ARGS__); break;  \
  }

}  // namespace

// The kernel follows the arguments: period > 0 walks the columns, period 0 takes one
// vector atomic per row in the stream's order, channels other than 1, 2, 4, 8 scalar
// atomics. `scalar` != 0 forces the scalar kernel (the yardstick the rest is timed against).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int scatter_add_bf16(const void* idx_, const void* vals_, void* out_,
                                long long n_updates, int channels, long long total_rows_,
                                long long period_, int scalar, void* fault_,
                                void* stream) {
  if (n_updates <= 0) return 0;
  if (channels < 1 || total_rows_ < 1 || total_rows_ > INT32_MAX || period_ < 0 ||
      period_ > INT32_MAX || (period_ > 0 && n_updates % period_ != 0))
    return (int)cudaErrorInvalidValue;
  const int32_t* idx = (const int32_t*)idx_;
  const __nv_bfloat16* vals = (const __nv_bfloat16*)vals_;
  float* out = (float*)out_;
  int* fault = (int*)fault_;
  const int total_rows = (int)total_rows_;
  const int period = (int)period_;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vector = channels == 1 || channels == 2 || channels == 4 || channels == 8;
  if (scalar || !vector) {
    const int resident = resident_blocks(scatter_add_scalar);
    int64_t blocks = (n_updates + kThreads - 1) / kThreads;
    if (blocks > resident) blocks = resident;
    scatter_add_scalar<<<(unsigned int)blocks, kThreads, 0, s>>>(idx, vals, out, n_updates,
                                                                 channels, total_rows, fault);
  } else if (period == 0) {
    FOR_CHANNELS(launch_rows, idx, vals, out, n_updates, total_rows, fault, s);
  } else {
    FOR_CHANNELS(launch_columns, idx, vals, out, n_updates, period, total_rows, fault, s);
  }
  return (int)cudaGetLastError();
}
