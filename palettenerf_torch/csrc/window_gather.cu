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
// 3.35 TB/s. The window itself (<= 16 KiB) lives in shared memory.
//
// This first design: a grid-stride loop, one output element per thread per step, with
// coalesced 4-byte reads of r and c. Elements are copied as raw bits (4-byte words for
// f32, 2-byte words for bf16), so the result equals W[r, c] exactly. Vectorised int4
// loads and several outputs per thread are for a later change.
//
// The caller (palettenerf_torch/ops/window_gather.py) checks shapes, dtypes and that
// every r lies in [0, rows) and every c in [0, 128), and launches on PyTorch's current
// stream.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kLanes = 128;
constexpr int kMaxRows = 32;

template <typename T>
__global__ void window_gather_kernel(const T* __restrict__ w, int rows,
                                     const int32_t* __restrict__ r,
                                     const int32_t* __restrict__ c,
                                     T* __restrict__ out, int64_t n) {
  __shared__ T ws[kMaxRows * kLanes];
  for (int i = threadIdx.x; i < rows * kLanes; i += blockDim.x) ws[i] = w[i];
  __syncthreads();
  const int64_t step = (int64_t)blockDim.x * gridDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    out[i] = ws[r[i] * kLanes + c[i]];
  }
}

// elem_bytes: 4 (f32) or 2 (bf16). Returns the cudaError_t of the launch (0 on success).
extern "C" int window_gather(const void* w, int rows, int elem_bytes, const void* r,
                             const void* c, void* out, long long n, void* stream) {
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long max_blocks = 132LL * 8;  // 8 x 256 threads fill each of 132 SMs
  if (blocks > max_blocks) blocks = max_blocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 4) {
    window_gather_kernel<uint32_t><<<(unsigned int)blocks, threads, 0, s>>>(
        (const uint32_t*)w, rows, (const int32_t*)r, (const int32_t*)c, (uint32_t*)out,
        (int64_t)n);
  } else if (elem_bytes == 2) {
    window_gather_kernel<uint16_t><<<(unsigned int)blocks, threads, 0, s>>>(
        (const uint16_t*)w, rows, (const int32_t*)r, (const int32_t*)c, (uint16_t*)out,
        (int64_t)n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
