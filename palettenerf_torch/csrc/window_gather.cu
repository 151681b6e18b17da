// Window gather on Hopper (sm_90a):
//
//   out[i, j] = W[r[i, j], c[i, j]]      W [rows <= 32, 128], r, c, out [M8, 128]
//
// Replaces the Pallas TPU kernel palettenerf_tpu/ops/pallas_window_gather.py:window_gather.
// Mosaic has no general VMEM gather, so that kernel composes one from per-window-row
// lane gathers and selects over (8, 128) vregs. On this card shared memory takes any
// address, so the whole window is staged once per block and each output element is one
// shared-memory load.
//
// What bounds it on an H100: bytes. Each output element reads its int32 r and c and
// writes one element: M8 * 128 * (4 + 4 + sizeof W) bytes, plus the window read once
// (rows * 128 * sizeof W). At M8 = 65,536 with f32 that is ~100.7 MB, 0.030 ms at
// 3.35 TB/s. The window itself (<= 16 KiB) lives in shared memory. Nothing can be
// saved on the bytes, so the design is about how they are asked for:
//
// - 16 bytes per request. A thread takes four consecutive outputs per step: one int4
//   load of r, one of c, four shared-memory reads, one 16-byte store (8 bytes for
//   bf16). n = M8 * 128 is always a multiple of four.
// - Two such groups in flight per thread, so four 16-byte loads are outstanding
//   before the first shared-memory read.
// - Streaming loads and stores (ld.global.cs / st.global.cs): every byte is touched
//   once, so nothing should stay in the caches.
// - Few, large blocks (512 threads, as many as are resident on the card at once), so
//   that the window is staged ~500 times, not once per 256 outputs, with 16-byte copies.
//
// Elements are copied as raw bits (4-byte words for f32, 2-byte words for bf16), so the
// result equals W[r, c] exactly.
//
// An index outside the window (r not in [0, rows), c not in [0, 128)) is never used as
// an address: its output element is written as zero bits and the kernel adds one to
// *fault. The caller (palettenerf_torch/ops/window_gather.py) checks shapes, dtypes and
// 16-byte alignment, owns the fault counter, and launches on PyTorch's current stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxRows = 32;
constexpr int kThreads = 512;

template <typename T>
__device__ __forceinline__ T pick(const T* __restrict__ ws, unsigned int rows, int r, int c,
                                  int* __restrict__ fault) {
  if ((unsigned int)r < rows && (unsigned int)c < (unsigned int)kLanes) return ws[r * kLanes + c];
  atomicAdd(fault, 1);
  return (T)0;
}

__device__ __forceinline__ void store4(uint32_t* out, int64_t group, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  __stcs(reinterpret_cast<uint4*>(out) + group, make_uint4(a, b, c, d));
}

__device__ __forceinline__ void store4(uint16_t* out, int64_t group, uint16_t a, uint16_t b,
                                       uint16_t c, uint16_t d) {
  __stcs(reinterpret_cast<uint2*>(out) + group,
         make_uint2((uint32_t)a | ((uint32_t)b << 16), (uint32_t)c | ((uint32_t)d << 16)));
}

template <typename T>
__device__ __forceinline__ void gather4(const T* __restrict__ ws, unsigned int rows, int4 r,
                                        int4 c, T* __restrict__ out, int64_t group,
                                        int* __restrict__ fault) {
  store4(out, group, pick(ws, rows, r.x, c.x, fault), pick(ws, rows, r.y, c.y, fault),
         pick(ws, rows, r.z, c.z, fault), pick(ws, rows, r.w, c.w, fault));
}

// n4: number of groups of four outputs.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_gather_kernel(const T* __restrict__ w, int rows, const int4* __restrict__ r,
                     const int4* __restrict__ c, T* __restrict__ out, int64_t n4,
                     int* __restrict__ fault) {
  __shared__ __align__(16) T ws[kMaxRows * kLanes];
  const int n16 = rows * kLanes * (int)sizeof(T) / 16;
  for (int i = threadIdx.x; i < n16; i += blockDim.x)
    reinterpret_cast<uint4*>(ws)[i] = reinterpret_cast<const uint4*>(w)[i];
  __syncthreads();
  const int64_t step = (int64_t)blockDim.x * gridDim.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + step < n4; i += 2 * step) {
    const int4 r0 = __ldcs(r + i), c0 = __ldcs(c + i);
    const int4 r1 = __ldcs(r + i + step), c1 = __ldcs(c + i + step);
    gather4<T>(ws, rows, r0, c0, out, i, fault);
    gather4<T>(ws, rows, r1, c1, out, i + step, fault);
  }
  if (i < n4) gather4<T>(ws, rows, __ldcs(r + i), __ldcs(c + i), out, i, fault);
}

// Blocks that fill the current device once: resident blocks per SM x SMs.
template <typename T>
int resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, window_gather_kernel<T>, kThreads, 0);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

template <typename T>
int launch(const void* w, int rows, const void* r, const void* c, void* out, int64_t n4,
           int* fault, cudaStream_t s) {
  const int resident = resident_blocks<T>();
  // each thread takes two groups per step
  int64_t blocks = (n4 + 2 * kThreads - 1) / (2 * kThreads);
  if (blocks > resident) blocks = resident;
  window_gather_kernel<T><<<(unsigned int)blocks, kThreads, 0, s>>>(
      (const T*)w, rows, (const int4*)r, (const int4*)c, (T*)out, n4, fault);
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 4 (f32) or 2 (bf16); n: number of outputs, a multiple of 4; w, r, c and
// out 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
extern "C" int window_gather(const void* w, int rows, int elem_bytes, const void* r,
                             const void* c, void* out, long long n, void* fault,
                             void* stream) {
  if (rows < 1 || rows > kMaxRows || n % 4 != 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) return launch<uint32_t>(w, rows, r, c, out, n / 4, (int*)fault, s);
  if (elem_bytes == 2) return launch<uint16_t>(w, rows, r, c, out, n / 4, (int*)fault, s);
  return (int)cudaErrorInvalidValue;
}
