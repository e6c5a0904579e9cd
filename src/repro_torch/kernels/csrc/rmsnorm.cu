// Row RMSNorm (forward) for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces rmsnorm_pallas of src/repro/kernels/rmsnorm.py (pallas_call at
// :28), reached through repro.kernels.ops.rmsnorm.  For every row of x (R, D)
//     y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
// in float32 from float32 or bf16 x (scale float32), written in x's dtype.
// Any R >= 1 and D >= 1; x and y contiguous.
//
// What bounds it on an H100 SXM (data-sheet rates, 700 W): each element is
// read once and written once, with ~5 operations on it, far under the ~20
// float32 operations per byte the card can do: bytes bound it ((1024, 4096)
// bf16: 16.8 MB, ~0.005 ms at 3.35 TB/s).  To come near that rate the card
// needs many loads in flight and few instructions per byte.
//
// Design: a row is read by a group of WPR warps (1, 2, 4 or 8: the fewest
// that give each lane one vector), each thread holding VPT vectors of it in
// registers, so a block of 8 warps takes 8 / WPR rows at a time and a step
// is small enough that the steps spread evenly over the grid.  Loads and
// stores are 16 bytes a thread (8 bf16 or 4 float32) where D is a multiple
// of that and x and y start on 16-byte boundaries, else one element; the
// row's ragged end is masked.  The grid is the SM count times the blocks an
// SM holds, and each block walks the rows with that stride; (1 + scale) is
// computed once per block into shared memory (D floats), which keeps the
// registers few and the blocks per SM many.  The sum of squares is reduced
// in a fixed order: in the thread, over the warp with xor shuffles, then
// over the group's warps in shared memory in warp order.  Deterministic, no
// atomics.  That shape holds a row in registers and (1 + scale) in shared
// memory, up to D = 8192.  Wider rows take a second shape, rmsnorm_wide_kernel:
// a block of 256 threads per row (the grid walking the rows), which sums the
// squares over the row in a fixed order (each thread a strided run of
// vectors, then the warp, then the warps in order) and reads the row a
// second time (mostly from L2) to write it; (1 + scale) is formed per element.
// Built with -fmad=false and without fast math, so the products round as the
// plain version's do; only the sum of squares has another order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8192;

// VEC consecutive elements as float32, and back
template <int VEC>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = p[e];
  }
}

template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // element 2e in the low half; bf16 -> float32 is exact
      v[2 * e] = __uint_as_float(words[e] << 16);
      v[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = __bfloat162float(p[e]);
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = v[e];
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 8) {
    uint32_t words[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      words[e] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(words[0], words[1], words[2], words[3]);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) p[e] = __float2bfloat16_rn(v[e]);
  }
}

// WPR warps per row, at most VPT vectors of VEC elements per thread
template <typename T, int VEC, int WPR, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int R, int D, float eps) {
  constexpr int kGroupThreads = 32 * WPR;   // threads on one row
  constexpr int kRowsPerStep = kWarps / WPR;
  __shared__ float partial[2][kWarps];      // double-buffered by step parity
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = warp / WPR;               // which of the step's rows
  const int t = (warp % WPR) * 32 + lane;   // thread within the row's group
  const int nvec = D / VEC;                 // VEC divides D

  extern __shared__ float gs[];             // (1 + scale), D values
  for (int c = threadIdx.x; c < D; c += kThreads) gs[c] = 1.0f + scale[c];
  __syncthreads();

  int parity = 0;
  for (int row0 = blockIdx.x * kRowsPerStep; row0 < R;
       row0 += gridDim.x * kRowsPerStep, parity ^= 1) {
    const int row = row0 + grp;
    const bool on = row < R;
    const T* xr = x + static_cast<int64_t>(row) * D;
    float v[VPT][VEC];
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = t + i * kGroupThreads;
      if (on && j < nvec) {
        load<VEC>(xr + j * VEC, v[i]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[i][e] = 0.0f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += v[i][e] * v[i][e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if constexpr (WPR > 1) {
      if (lane == 0) partial[parity][warp] = ss;
      __syncthreads();
      ss = 0.0f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) ss += partial[parity][grp * WPR + w];
    }
    if (!on) continue;
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    T* yr = out + static_cast<int64_t>(row) * D;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int j = t + i * kGroupThreads;
      if (j < nvec) {
        float y[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) y[e] = v[i][e] * r * gs[j * VEC + e];
        store<VEC>(yr + j * VEC, y);
      }
    }
  }
}

template <typename T, int VEC, int WPR, int VPT>
int launch_wpr(const void* x, const float* scale, void* out, int R, int D, float eps,
               int device, cudaStream_t s) {
  auto kern = rmsnorm_kernel<T, VEC, WPR, VPT>;
  const int smem = D * static_cast<int>(sizeof(float));  // (1 + scale)
  // blocks an SM holds with the largest D's shared memory; the same on
  // every H100, so worked out once
  static int per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                        kMaxD * static_cast<int>(sizeof(float)));
  int sms = 0;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kRowsPerStep = kWarps / WPR;
  const int64_t steps = (static_cast<int64_t>(R) + kRowsPerStep - 1) / kRowsPerStep;
  const int grid = static_cast<int>(steps < sms * per_sm ? steps : sms * per_sm);
  kern<<<grid, kThreads, smem, s>>>(static_cast<const T*>(x), scale, static_cast<T*>(out), R, D,
                                    eps);
  return static_cast<int>(cudaGetLastError());
}

// The shape of the work from D: the fewest warps per row (up to 8) that give
// each lane one vector, then the fewest vectors per thread that cover the
// row, so that a block step is small and the steps spread evenly over the
// grid.
template <typename T, int VEC>
int launch_vec(const void* x, const float* scale, void* out, int R, int D, float eps,
               int device, cudaStream_t s) {
  const int nvec = D / VEC;
  const int warps = (nvec + 31) / 32;
  if (warps <= 1) return launch_wpr<T, VEC, 1, 1>(x, scale, out, R, D, eps, device, s);
  if (warps <= 2) return launch_wpr<T, VEC, 2, 1>(x, scale, out, R, D, eps, device, s);
  if (warps <= 4) return launch_wpr<T, VEC, 4, 1>(x, scale, out, R, D, eps, device, s);
  const int vpt = (nvec + kThreads - 1) / kThreads;
  if (vpt <= 1) return launch_wpr<T, VEC, 8, 1>(x, scale, out, R, D, eps, device, s);
  if (vpt <= 2) return launch_wpr<T, VEC, 8, 2>(x, scale, out, R, D, eps, device, s);
  if (vpt <= 4) return launch_wpr<T, VEC, 8, 4>(x, scale, out, R, D, eps, device, s);
  if (vpt <= 8) return launch_wpr<T, VEC, 8, 8>(x, scale, out, R, D, eps, device, s);
  if constexpr (VEC == 1) {
    if (vpt <= 16) return launch_wpr<T, 1, 8, 16>(x, scale, out, R, D, eps, device, s);
    return launch_wpr<T, 1, 8, 32>(x, scale, out, R, D, eps, device, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_dtype(const void* x, const float* scale, void* out, int R, int D, float eps,
                 int device, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 && D % kVec == 0;
  if (aligned) return launch_vec<T, kVec>(x, scale, out, R, D, eps, device, s);
  return launch_vec<T, 1>(x, scale, out, R, D, eps, device, s);
}

// One row per block step, any D: two passes over the row, VEC elements a
// load.  The sum is each thread's (in its order), then the warp's xor tree,
// then the warps' in warp order: fixed.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_wide_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ out, int R, int D, float eps) {
  __shared__ float partial[kWarps];
  __shared__ float total;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nvec = D / VEC;                 // VEC divides D
  for (int row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + static_cast<int64_t>(row) * D;
    float ss = 0.0f;
    for (int j = threadIdx.x; j < nvec; j += kThreads) {
      float v[VEC];
      load<VEC>(xr + static_cast<int64_t>(j) * VEC, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss += v[e] * v[e];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += partial[w];
      total = t;
    }
    __syncthreads();
    const float r = rsqrtf(total / static_cast<float>(D) + eps);
    T* yr = out + static_cast<int64_t>(row) * D;
    for (int j = threadIdx.x; j < nvec; j += kThreads) {
      float v[VEC], g[VEC], y[VEC];
      load<VEC>(xr + static_cast<int64_t>(j) * VEC, v);
      load<VEC>(scale + static_cast<int64_t>(j) * VEC, g);
#pragma unroll
      for (int e = 0; e < VEC; ++e) y[e] = v[e] * r * (1.0f + g[e]);
      store<VEC>(yr + static_cast<int64_t>(j) * VEC, y);
    }
    __syncthreads();  // partial and total are free for the next row
  }
}

template <typename T>
int launch_wide(const void* x, const float* scale, void* out, int R, int D, float eps,
                int device, cudaStream_t s) {
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = R < sms * 8 ? R : sms * 8;
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(scale) % 16 == 0 && D % kVec == 0;
  if (aligned)
    rmsnorm_wide_kernel<T, kVec><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(out), R, D, eps);
  else
    rmsnorm_wide_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(out), R, D, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point: launches the kernel on `stream` (PyTorch's current stream)
// on `device` and returns a CUDA error code as an int (0 = launched).  The
// wrapper (kernels/rmsnorm.py) has checked shapes, dtypes and contiguity:
// 1 <= R <= 2**31 - 1, 1 <= D <= 2**31 - 1, scale float32 of length D.  D >
// 8192 takes the wide shape.
extern "C" int rmsnorm_launch(const void* x, const float* scale, void* out, int R,
                              int D, float eps, int is_bf16, int device, void* stream) {
  cudaSetDevice(device);
  if (R < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kMaxD) {
    if (is_bf16) return launch_wide<__nv_bfloat16>(x, scale, out, R, D, eps, device, s);
    return launch_wide<float>(x, scale, out, R, D, eps, device, s);
  }
  if (is_bf16) return launch_dtype<__nv_bfloat16>(x, scale, out, R, D, eps, device, s);
  return launch_dtype<float>(x, scale, out, R, D, eps, device, s);
}
