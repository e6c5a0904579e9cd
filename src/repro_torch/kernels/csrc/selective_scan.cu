// Mamba-1 selective scan (forward) for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces selective_scan_pallas of src/repro/kernels/selective_scan.py
// (pallas_call at :72), reached from repro.models.ssm.mamba_mix on every
// prefill whose length and d_inner are multiples of 64 with use_pallas.  For
// every batch row b, channel d and state s it runs, in order over t,
//     h_t = exp(dt_t * A[d, s]) * h_{t-1} + (dt_t * u_t) * B_t[s]
//     y_t = sum_s h_t * C_t[s] + D[d] * u_t
// in float32 from float32 or bf16 u, dt, B, C (A and D float32), with h_0 = 0,
// and writes y in u's dtype and, when asked, the final state h_S (B, di, n) in
// float32: the state a decode continues from, which the model would otherwise
// recompute with a plain scan over the whole prompt.  The (B, S, di, n) state
// never reaches memory: it lives in registers for the whole sequence.
//
// Layouts: u, dt and out (B, S, di); B and C (B, S, n); A (di, n); D (di,);
// h_last (B, di, n); all contiguous.  Any B, S, di, n >= 1.
//
// What bounds it on an H100 SXM (data-sheet rates, 700 W): at the served
// shape (B=1, di=8192, n=16, S=1024, float32) it reads u and dt and writes y,
// 3 * S * di * 4 bytes (~100 MB, ~0.03 ms at 3.35 TB/s), and does one expf
// (10 SASS instructions) and 6 multiplies and adds per (t, d, s), ~134 M
// triples: ~2.2 G instructions, ~0.065 ms at the issue rate of 33.5 T
// lane-instructions/s.  So instruction issue bounds it.  With one thread per
// 4 (channel, state) pairs the card holds only ~8 warps per SM at B=1, so
// what the design must fight besides the instruction count is latency: a
// warp has to find an independent instruction nearly every cycle.
//
// Design.  The sequential sequence axis of the TPU grid becomes a loop over
// time inside the block; channels and states run in parallel.  A channel's
// states are spread over L lanes of a warp, R consecutive states each (n =
// 16 is served by L = 4, R = 4, the fastest of L = 2, 4, 8 in chip_smoke.py's
// A/B).  Per step a lane reads (u_t, dt_t) once for its R states as one
// 8-byte pair, forms dt * u once, reads its R values of B_t and C_t as 16-byte
// vectors (broadcasts: every channel of the block reads the same step), and
// runs R independent expf/multiply chains; step t + 1's operands are loaded
// while step t computes.  The lane stores its partial sum of y_t (two
// accumulators over r) to shared memory, and the channel's L partials are
// added in lane order when the tile is written back: no shuffle sits on the
// per-step chain, and each lane spends 4 shared-memory instructions per step
// on its R states.  u, dt, B and C are staged through shared memory in tiles
// of TT steps (64 where two such blocks still fit an SM), double-buffered:
// each thread's global loads of tile k + 1 are issued into registers before
// tile k's steps and written to the other buffer after them, so they are in
// flight while the tile computes (register staging rather than cp.async,
// which cannot copy a 2-byte bf16 element or an unaligned ragged row), with
// one __syncthreads per tile and index arithmetic in shifts (every thread
// keeps one column of the tile).  y of a tile is written back one tile later,
// coalesced.  Steps past S compute on zeros (dA = exp(0) = 1, dt * u * B = 0,
// so h is left exactly as it was), which keeps the step loop's trip count a
// constant; channels past di and states past n compute on zeros and are not
// stored.  More than 64 states are split into groups of 64 over grid.y, each
// writing its partial y to a scratch buffer that a second pass sums in group
// order (fixed order, no atomics).  B x channel blocks go on grid.x.  Built
// with -fmad=false and without fast math, so exp, the multiplies and the
// adds round as the plain version's do, and so does every h (the final state
// included); only the sum over s has another order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kGroup = 64;     // most states one block holds (L * R)

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// R consecutive floats of shared memory, 16- or 8-byte aligned when R is a
// multiple of 4 or 2
template <int R>
__device__ __forceinline__ void lds(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R / 4; ++i) {
      const float4 w = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = w.x; v[4 * i + 1] = w.y; v[4 * i + 2] = w.z; v[4 * i + 3] = w.w;
    }
  } else if constexpr (R % 2 == 0) {
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      const float2 w = reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = w.x; v[2 * i + 1] = w.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = p[i];
  }
}

// Shared memory of one block, in floats: (u, dt) pairs, B and C, each
// double-buffered per tile of TT steps, and the lanes' partial sums of y.
template <int L, int R, int TT>
struct Tile {
  static constexpr int kCh = kThreads / L;    // channels per block
  static constexpr int kG = L * R;            // states per block
  static constexpr int kTT = TT;              // time steps per tile
  static constexpr int kUD = kTT * kCh * 2;   // (u, dt) of one tile
  static constexpr int kBC = kTT * kG;        // B (or C) of one tile
  static constexpr int kP = kTT * kThreads;   // partial y of one tile, a value per lane
  static constexpr int kFloats = 2 * (kUD + 2 * kBC + kP);
  static constexpr int kBytes = kFloats * 4;
};

// L lanes per channel, R states per lane, TT steps per tile.  kPartial:
// write the group's y without D u to part[group] (a second pass sums the
// groups); else y to out.
template <typename T, int L, int R, int TT, bool kPartial>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const T* __restrict__ Bm, const T* __restrict__ Cm,
                      const float* __restrict__ A, const float* __restrict__ D,
                      T* __restrict__ out, float* __restrict__ part,
                      float* __restrict__ h_last, int S, int di, int n, int nblk,
                      int64_t plane) {
  using Tl = Tile<L, R, TT>;
  constexpr int kCh = Tl::kCh, kG = Tl::kG, kTT = Tl::kTT;
  constexpr int kPU = kTT * kCh / kThreads;     // (u, dt) pairs a thread stages
  constexpr int kPB = kTT * kG / kThreads;      // B (and C) values a thread stages
  static_assert(kG <= kGroup && kPB >= 1 && (kTT * kG) % kThreads == 0, "tile shape");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float2* sud = reinterpret_cast<float2*>(smem);          // [2][kTT][kCh] (u, dt)
  float* sB = smem + 2 * Tl::kUD;                           // [2][kTT][kG]
  float* sC = sB + 2 * Tl::kBC;                             // [2][kTT][kG]
  float* sp = sC + 2 * Tl::kBC;                             // [2][kTT][kThreads]

  const unsigned tid = threadIdx.x;
  const int b = blockIdx.x / nblk;
  const int d0 = (blockIdx.x - b * nblk) * kCh;
  const int g0 = blockIdx.y * kG;               // the group's first state
  const int c = tid / L, lane = tid % L;        // this lane's channel and place in it
  const int d = d0 + c;
  const bool live = d < di;
  const int64_t row0 = static_cast<int64_t>(b) * S;

  float a[R], h[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = g0 + lane * R + r;
    a[r] = (live && s < n) ? A[static_cast<int64_t>(d) * n + s] : 0.0f;
    h[r] = 0.0f;
  }

  // Each thread stages one column of a tile: channel uc at steps ut + j *
  // kUStep (u, dt; and y at write-back) and state bs at steps bt + j * kBStep
  // (B, C).
  constexpr int kUStep = kThreads / kCh, kBStep = kThreads / kG;
  const int uc = tid % kCh, ut = tid / kCh;
  const int bs = tid % kG, bt = tid / kG;
  const bool u_on = d0 + uc < di, b_on = g0 + bs < n;
  const float Du = u_on ? D[d0 + uc] : 0.0f;
  float pu[kPU], pdt[kPU], pb[kPB], pc[kPB];

  auto fetch = [&](int t0) {
    const int64_t ui = (row0 + t0 + ut) * di + d0 + uc;
#pragma unroll
    for (int j = 0; j < kPU; ++j) {
      const bool ok = u_on && t0 + ut + j * kUStep < S;
      const int64_t i = ui + static_cast<int64_t>(j) * kUStep * di;
      pu[j] = ok ? load(u + i) : 0.0f;
      pdt[j] = ok ? load(dt + i) : 0.0f;
    }
    const int64_t bi = (row0 + t0 + bt) * n + g0 + bs;
#pragma unroll
    for (int j = 0; j < kPB; ++j) {
      const bool ok = b_on && t0 + bt + j * kBStep < S;
      const int64_t i = bi + static_cast<int64_t>(j) * kBStep * n;
      pb[j] = ok ? load(Bm + i) : 0.0f;
      pc[j] = ok ? load(Cm + i) : 0.0f;
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kPU; ++j)
      sud[(buf * kTT + ut + j * kUStep) * kCh + uc] = make_float2(pu[j], pdt[j]);
#pragma unroll
    for (int j = 0; j < kPB; ++j) {
      sB[(buf * kTT + bt + j * kBStep) * kG + bs] = pb[j];
      sC[(buf * kTT + bt + j * kBStep) * kG + bs] = pc[j];
    }
  };
  // y of a tile: the channel's L partial sums in lane order, then D u
  auto write_back = [&](int t0, int buf) {
    if (!u_on) return;
    const int64_t yi = (row0 + t0 + ut) * di + d0 + uc;
#pragma unroll
    for (int j = 0; j < kPU; ++j) {
      const int t = ut + j * kUStep;
      if (t0 + t >= S) break;
      float p[L];
      lds<L>(sp + (buf * kTT + t) * kThreads + uc * L, p);
      float y = p[0];
#pragma unroll
      for (int l = 1; l < L; ++l) y += p[l];
      const int64_t i = yi + static_cast<int64_t>(j) * kUStep * di;
      if constexpr (kPartial)
        part[blockIdx.y * plane + i] = y;
      else
        store(out + i, y + Du * sud[(buf * kTT + t) * kCh + uc].x);
    }
  };

  const int tiles = (S + kTT - 1) / kTT;
  fetch(0);
  stage(0);
  __syncthreads();
  for (int k = 0; k < tiles; ++k) {
    const int cur = k & 1;
    if (k + 1 < tiles) fetch((k + 1) * kTT);    // in flight during this tile's steps
    if (k > 0) write_back((k - 1) * kTT, cur ^ 1);
    const float2* ud = sud + cur * kTT * kCh + c;
    const float* bp = sB + cur * Tl::kBC + lane * R;
    const float* cp = sC + cur * Tl::kBC + lane * R;
    float* pp = sp + cur * Tl::kP + tid;
    // step t computes while step t + 1's operands load (two partial sums
    // over r shorten the chain of adds)
    float2 x = ud[0];                               // (u_t, dt_t) of this channel
    float bv[R], cv[R];
    lds<R>(bp, bv);
    lds<R>(cp, cv);
#pragma unroll 4
    for (int t = 0; t < kTT; ++t) {
      const int tn = t + 1 < kTT ? t + 1 : t;
      const float2 xn = ud[tn * kCh];
      float bn[R], cn[R];
      lds<R>(bp + tn * kG, bn);
      lds<R>(cp + tn * kG, cn);
      const float dtu = x.y * x.x;
      float y0 = 0.0f, y1 = 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float dA = expf(x.y * a[r]);
        h[r] = dA * h[r] + dtu * bv[r];
        if (r % 2) y1 += h[r] * cv[r]; else y0 += h[r] * cv[r];
      }
      pp[t * kThreads] = y0 + y1;
      x = xn;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bv[r] = bn[r];
        cv[r] = cn[r];
      }
    }
    if (k + 1 < tiles) stage(cur ^ 1);
    __syncthreads();  // the next tile is staged, this one's partial sums are complete
  }
  write_back((tiles - 1) * kTT, (tiles - 1) & 1);

  if (h_last != nullptr && live) {
    float* hp = h_last + (static_cast<int64_t>(b) * di + d) * n + g0 + lane * R;
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (g0 + lane * R + r < n) hp[r] = h[r];
  }
}

// y = sum over groups of part (in group order) + D u, in u's dtype
template <typename T>
__global__ void __launch_bounds__(256)
scan_sum_kernel(const float* __restrict__ part, const T* __restrict__ u,
                const float* __restrict__ D, T* __restrict__ out, int groups,
                int64_t plane, int di) {
  for (int64_t i = blockIdx.x * 256ll + threadIdx.x; i < plane; i += 256ll * gridDim.x) {
    float y = part[i];
    for (int g = 1; g < groups; ++g) y += part[g * plane + i];
    store(out + i, y + D[i % di] * load(u + i));
  }
}

template <typename T, int L, int R, int TT>
int launch_lr(const void* u, const void* dt, const void* Bm, const void* Cm,
              const float* A, const float* D, void* out, float* part, float* h_last,
              int B, int S, int di, int n, cudaStream_t stream) {
  constexpr int kCh = kThreads / L;
  const int nblk = (di + kCh - 1) / kCh;
  const int groups = (n + L * R - 1) / (L * R);
  const int64_t blocks = static_cast<int64_t>(B) * nblk;
  if (blocks > 0x7fffffff || groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks), groups);
  const int64_t plane = static_cast<int64_t>(B) * S * di;
  const T* ut = static_cast<const T*>(u);
  constexpr int kSmem = Tile<L, R, TT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(selective_scan_kernel<T, L, R, TT, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(selective_scan_kernel<T, L, R, TT, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups == 1) {
    selective_scan_kernel<T, L, R, TT, false><<<grid, kThreads, kSmem, stream>>>(
        ut, static_cast<const T*>(dt), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
        A, D, static_cast<T*>(out), nullptr, h_last, S, di, n, nblk, plane);
    return static_cast<int>(cudaGetLastError());
  }
  if (part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  selective_scan_kernel<T, L, R, TT, true><<<grid, kThreads, kSmem, stream>>>(
      ut, static_cast<const T*>(dt), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      A, D, nullptr, part, h_last, S, di, n, nblk, plane);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t want = (plane + 255) / 256;
  const unsigned sum_grid = static_cast<unsigned>(want < (1 << 20) ? want : (1 << 20));
  scan_sum_kernel<T><<<sum_grid, 256, 0, stream>>>(part, ut, D, static_cast<T*>(out), groups,
                                                    plane, di);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* u, const void* dt, const void* Bm, const void* Cm,
                 const float* A, const float* D, void* out, float* part, float* h_last,
                 int B, int S, int di, int n, int lanes, cudaStream_t stream) {
// Tiles of 64 steps where two blocks of that size fit an SM (112 KB each at
// 4 lanes x 4 states), else 32: fewer barriers per step, the same occupancy.
#define SS_LAUNCH(L, R, TT) \
  launch_lr<T, L, R, TT>(u, dt, Bm, Cm, A, D, out, part, h_last, B, S, di, n, stream)
  if (n <= 4) return SS_LAUNCH(4, 1, 64);
  if (n <= 8) return SS_LAUNCH(4, 2, 64);
  if (n <= 16) {
    if (lanes == 2) return SS_LAUNCH(2, 8, 32);
    if (lanes == 4) return SS_LAUNCH(4, 4, 64);
    if (lanes == 8) return SS_LAUNCH(8, 2, 32);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 32) return SS_LAUNCH(4, 8, 32);
  return SS_LAUNCH(8, 8, 32);  // groups of 64 states beyond 64
#undef SS_LAUNCH
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

// C entry point: launches the scan on `stream` (PyTorch's current stream) on
// `device` (and, for n > 64, the pass that sums the groups' partial y) and
// returns cudaGetLastError() as an int (0 = launched).  The wrapper
// (kernels/selective_scan.py) has checked shapes, dtypes and contiguity: u,
// dt, B, C of one dtype (bf16 when is_bf16), A and D float32, B, S, di, n >=
// 1.  `part` is float32 scratch of ceil(n / 64) * B * S * di values when n >
// 64 (else unused); `h_last` is null or (B, di, n) float32.  `lanes` (2, 4 or
// 8) picks the template for 8 < n <= 16.
extern "C" int selective_scan_launch(const void* u, const void* dt, const void* Bm,
                                     const void* Cm, const float* A, const float* D,
                                     void* out, float* part, float* h_last, int B, int S,
                                     int di, int n, int lanes, int is_bf16, int device,
                                     void* stream) {
  cudaSetDevice(device);
  if (B < 1 || S < 1 || di < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dtype<__nv_bfloat16>(u, dt, Bm, Cm, A, D, out, part, h_last, B, S, di, n,
                                       lanes, s);
  return launch_dtype<float>(u, dt, Bm, Cm, A, D, out, part, h_last, B, S, di, n, lanes, s);
}
