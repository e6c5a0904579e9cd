// Mamba-1 selective scan (forward) for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces selective_scan_pallas of src/repro/kernels/selective_scan.py
// (pallas_call at :72), reached from repro.models.ssm.mamba_mix on every
// prefill whose length and d_inner are multiples of 64 with use_pallas.  For
// every batch row b, channel d and state s it runs, in order over t,
//     h_t = exp(dt_t * A[d, s]) * h_{t-1} + (dt_t * u_t) * B_t[s]
//     y_t = sum_s h_t * C_t[s] + D[d] * u_t
// in float32 from float32 or bf16 u, dt, B, C (A and D float32), with h_0 = 0,
// and writes y in u's dtype.  The (B, S, di, n) state never reaches memory: it
// lives in registers for the whole sequence.
//
// Layouts: u, dt and out (B, S, di); B and C (B, S, n); A (di, n); D (di,);
// all contiguous.  Any S >= 1, di >= 1 and 1 <= n <= 64.
//
// What bounds it on an H100 SXM (data-sheet rates, 700 W): at the served
// shape (B=1, di=8192, n=16, S=1024, float32) it reads u and dt and writes y,
// 3 * S * di * 4 bytes (~100 MB, ~0.03 ms at 3.35 TB/s), and does one expf
// (10 SASS instructions) and 6 multiplies and adds per (t, d, s), ~134 M
// triples: ~2.2 G instructions, ~0.065 ms at the issue rate of 33.5 T
// lane-instructions/s.  So instructions bound it, and the design keeps every
// lane of the card busy on them.
//
// Design (simple and right first).  The sequential sequence axis of the TPU
// grid becomes a loop over time inside the block; the block's channels run
// in parallel.  Lanes go over (channel, state): L lanes per channel (L = 4, 8
// or 16, the power of two nearest above n, at most 16), each lane owning R
// states s = lane + r * L (R = 1, 2 or 4 for n up to 64); y_t is reduced over
// a channel's L lanes with warp shuffles (xor, a fixed order).  At the served
// shape that is 131,072 threads in 1024 blocks of 128, ~7.8 blocks on each of
// the 132 SMs: one thread per channel would give 8,192 threads, ~2 warps per
// SM, far too few to hide the latency of the dependent expf/multiply chain.
// Every kTT time steps the block stages its channels' u and dt and the
// steps' B and C (which all its channels read) in shared memory with
// coalesced loads, runs the steps from there, and writes y back from shared
// memory.  Channels past di and states past n compute on zeros (dA = 1,
// B = C = 0) and are not stored.  Built with -fmad=false and without fast
// math, so exp, the multiplies and the adds round as the plain version's do;
// only the sum over s has another order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kTT = 32;        // time steps staged per tile

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T, int L, int R>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ A, const float* __restrict__ D,
                      T* __restrict__ out, int S, int di, int n) {
  constexpr int kCh = kThreads / L;  // channels per block
  constexpr int kNS = L * R;         // staged states per step (n padded)
  __shared__ float su[kTT][kCh];
  __shared__ float sdt[kTT][kCh];
  __shared__ float sy[kTT][kCh];
  __shared__ float sB[kTT][kNS];
  __shared__ float sC[kTT][kNS];

  const int b = blockIdx.y;
  const int c = threadIdx.x / L, lane = threadIdx.x % L;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + c;
  const bool live = d < di;

  float a[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = lane + r * L;
    a[r] = (live && s < n) ? A[static_cast<int64_t>(d) * n + s] : 0.0f;
    h[r] = 0.0f;
  }
  const float Dd = live ? D[d] : 0.0f;
  const int64_t row0 = static_cast<int64_t>(b) * S;

  for (int t0 = 0; t0 < S; t0 += kTT) {
    const int tt = min(kTT, S - t0);
    __syncthreads();  // the previous tile's y is written out
    for (int i = threadIdx.x; i < kTT * kCh; i += kThreads) {
      const int t = i / kCh, cc = i % kCh;
      float uu = 0.0f, dd = 0.0f;
      if (t < tt && d0 + cc < di) {
        const int64_t idx = (row0 + t0 + t) * di + d0 + cc;
        uu = load(u + idx);
        dd = load(dt + idx);
      }
      su[t][cc] = uu;
      sdt[t][cc] = dd;
    }
    for (int i = threadIdx.x; i < kTT * kNS; i += kThreads) {
      const int t = i / kNS, s = i % kNS;
      float bb = 0.0f, cv = 0.0f;
      if (t < tt && s < n) {
        const int64_t idx = (row0 + t0 + t) * n + s;
        bb = load(Bm + idx);
        cv = load(Cm + idx);
      }
      sB[t][s] = bb;
      sC[t][s] = cv;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < tt; ++t) {
      const float ut = su[t][c], dtt = sdt[t][c];
      const float dtu = dtt * ut;
      float part = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = lane + r * L;
        const float dA = expf(dtt * a[r]);
        h[r] = dA * h[r] + dtu * sB[t][s];
        part += h[r] * sC[t][s];
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane == 0) sy[t][c] = part + Dd * ut;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < kTT * kCh; i += kThreads) {
      const int t = i / kCh, cc = i % kCh;
      if (t < tt && d0 + cc < di)
        store(out + (row0 + t0 + t) * di + d0 + cc, sy[t][cc]);
    }
  }
}

template <typename T, int L, int R>
int launch_lr(const void* u, const void* dt, const void* Bm, const void* Cm,
              const float* A, const float* D, void* out, int B, int S, int di,
              int n, cudaStream_t stream) {
  constexpr int kCh = kThreads / L;
  const dim3 grid((di + kCh - 1) / kCh, B);
  selective_scan_kernel<T, L, R><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), A, D, static_cast<T*>(out), S, di, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* u, const void* dt, const void* Bm, const void* Cm,
                 const float* A, const float* D, void* out, int B, int S, int di,
                 int n, cudaStream_t stream) {
  if (n <= 4) return launch_lr<T, 4, 1>(u, dt, Bm, Cm, A, D, out, B, S, di, n, stream);
  if (n <= 8) return launch_lr<T, 8, 1>(u, dt, Bm, Cm, A, D, out, B, S, di, n, stream);
  if (n <= 16) return launch_lr<T, 16, 1>(u, dt, Bm, Cm, A, D, out, B, S, di, n, stream);
  if (n <= 32) return launch_lr<T, 16, 2>(u, dt, Bm, Cm, A, D, out, B, S, di, n, stream);
  if (n <= 64) return launch_lr<T, 16, 4>(u, dt, Bm, Cm, A, D, out, B, S, di, n, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Instruction-count probes, never launched.  They differ only in expf(), so
// the difference of their shortest SASS paths (cuobjdump -sass) is the fewest
// instructions one lane spends on one IEEE expf; chip_smoke.py reads it for
// the scan's operation bound.
extern "C" __global__ void ss_probe_exp(float* out, const float* x) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = expf(x[i]);
}

extern "C" __global__ void ss_probe_base(float* out, const float* x) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = x[i];
}

// C entry point: launches the kernel on `stream` (PyTorch's current stream)
// on `device` and returns cudaGetLastError() as an int (0 = launched).  The
// wrapper (kernels/selective_scan.py) has checked shapes, dtypes and
// contiguity: u, dt, B, C of one dtype (bf16 when is_bf16), A and D float32,
// B <= 65535, 1 <= n <= 64.
extern "C" int selective_scan_launch(const void* u, const void* dt, const void* Bm,
                                     const void* Cm, const float* A, const float* D,
                                     void* out, int B, int S, int di, int n,
                                     int is_bf16, int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dtype<__nv_bfloat16>(u, dt, Bm, Cm, A, D, out, B, S, di, n, s);
  return launch_dtype<float>(u, dt, Bm, Cm, A, D, out, B, S, di, n, s);
}
