// Row RMSNorm (forward) for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces rmsnorm_pallas of src/repro/kernels/rmsnorm.py (pallas_call at
// :28), reached through repro.kernels.ops.rmsnorm.  For every row of x (R, D)
//     y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// in float32 from float32 or bf16 x (scale float32), written in x's dtype.
// Any R >= 1 and 1 <= D <= 8192; x and y contiguous.
//
// What bounds it on an H100 SXM (data-sheet rates, 700 W): each element is
// read once and written once, with ~5 operations on it, far under the ~20
// float32 operations per byte the card can do: bytes bound it ((1024, 4096)
// bf16: 16.8 MB, ~0.005 ms at 3.35 TB/s).
//
// Design (simple and right first): one block of 256 threads per row.  A
// thread loads the row's elements tid, tid + 256, ... (coalesced) into
// registers, so the row is read from memory once; its sum of squares is
// reduced in a fixed order: in the thread, then over the warp with xor
// shuffles, then over the 8 warps' partials in shared memory, which every
// thread adds in the same order.  Deterministic, no atomics.  Built with
// -fmad=false and without fast math, so the products round as the plain
// version's do; only the sum of squares has another order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8192;
constexpr int kPer = kMaxD / kThreads;  // elements of a row per thread, at most

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int D, float eps) {
  __shared__ float partial[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * D;
  float v[kPer];
  float ss = 0.0f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    v[k] = i < D ? load(x + base + i) : 0.0f;
    ss += v[k] * v[k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += partial[w];
  const float r = rsqrtf(total / static_cast<float>(D) + eps);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (i < D) store(out + base + i, v[k] * r * (1.0f + scale[i]));
  }
}

}  // namespace

// C entry point: launches the kernel on `stream` (PyTorch's current stream)
// on `device` and returns cudaGetLastError() as an int (0 = launched).  The
// wrapper (kernels/rmsnorm.py) has checked shapes, dtypes and contiguity:
// 1 <= R <= 2**31 - 1, 1 <= D <= 8192, scale float32 of length D.
extern "C" int rmsnorm_launch(const void* x, const float* scale, void* out, int R,
                              int D, float eps, int is_bf16, int device, void* stream) {
  cudaSetDevice(device);
  if (D < 1 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    rmsnorm_kernel<__nv_bfloat16><<<R, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), scale, static_cast<__nv_bfloat16*>(out), D, eps);
  else
    rmsnorm_kernel<float><<<R, kThreads, 0, s>>>(static_cast<const float*>(x), scale,
                                                 static_cast<float*>(out), D, eps);
  return static_cast<int>(cudaGetLastError());
}
