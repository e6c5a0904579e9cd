// Flash attention (forward) for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces flash_attention_pallas of src/repro/kernels/flash_attention.py
// (pallas_call at :111), reached from repro.models.attention._flash_kernel_call
// on every prefill whose length is a multiple of 64.  For every (batch, query
// head, query row) it computes
//     softmax_j( mask( softcap( (q * 1/sqrt(hd)) . k_j ) ) ) . v
// in float32 from float32 or bf16 inputs, as the Pallas kernel does: q scaled
// before the product, softcap c*tanh(s/c) before the mask, causal (rel >= 0)
// and window (rel < window) masks on absolute positions (query and key rows
// both start at 0), masked logits at -1e30 (not -inf), and acc / max(l, 1e-30).
// Key tiles in which no (row, key) pair is live are skipped, as the Pallas
// kernel skips its key blocks.
//
// Layouts are the model's: q and out (B, Sq, H, hd), k and v (B, Sk, KV, hd),
// all contiguous.  A query head h reads KV head h / (H / KV) in place; no
// repeated copy of k and v is made (the Pallas wrapper makes one).
//
// What bounds it on an H100: at the serving shape (B=1, H=40, KV=8, hd=128,
// bf16, causal) it does ~2*S^2*hd*H operations on 2*S*hd*(H+KV)*2 bytes, 850
// operations per byte at S=2048: far above the card's ~295 bf16 tensor-core
// operations per byte, so the bound is operations.  The Pallas kernel's
// arithmetic is float32 end to end, and a bf16 tensor-core product would round
// q*scale and the probabilities to bf16.  This first version keeps float32 and
// runs on the float32 pipes (67 TFLOP/s, not the tensor cores' 989): the
// kernel cannot come near the bf16 bound, and its time is written beside it.
//
// Design (simple and right first): one block of 256 threads per (batch*head,
// 64-row query tile); the sequential key-block axis of the TPU grid becomes a
// loop over 64-row key tiles inside the block, up to the causal and window
// limits.  The scaled q tile stays in shared memory (transposed, float32) for
// the whole loop; each key tile's k (transposed) and v are staged through
// shared memory as float32.  Thread (ty, tx) of the 16 x 16 grid owns a 4 x 4
// block of the score tile (rows 4*ty.., keys 4*tx..) and, in the product with
// v, the same 4 rows times hd/16 output columns, so the running max,
// denominator and accumulator of its rows live in its registers; a row's max
// and sum are reduced across the 16 tx lanes with warp shuffles.  The
// probabilities go through shared memory (transposed, in the k tile's place)
// to the product with v.  Products use fmaf explicitly: the library is built
// with -fmad=false for the ZO kernels, and these sums have another order than
// the plain version's anyway.  Blocks of the longest causal rows launch first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // 16 x 16: a 4 x 4 block of scores each
constexpr int kLd = kTile + 4;  // row of a transposed tile in shared memory
constexpr float kMasked = -1e30f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 16 bytes of T as float32: 4 floats, or 8 bf16 (element 0 in the low half
// of each word; bf16 -> float32 is exact, its bits in the top half).
__device__ __forceinline__ void unpack(const uint4& w, float* x, float) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void unpack(const uint4& w, float* x, __nv_bfloat16) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    x[2 * e] = __uint_as_float(words[e] << 16);
    x[2 * e + 1] = __uint_as_float(words[e] & 0xffff0000u);
  }
}

// kTile rows of HD values (row stride `ld` elements) into shared memory as
// float32 times `scale`: transposed (dst[d * kLd + r]) or not (dst[r * HD + d]).
// 16-byte loads; the caller guarantees 16-byte aligned rows.
template <int HD, bool kTranspose, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int64_t ld, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowChunks = HD / kVec;
  for (int c = threadIdx.x; c < kTile * kRowChunks; c += kThreads) {
    const int r = c / kRowChunks;
    const int d0 = (c % kRowChunks) * kVec;
    float vals[kVec];
    unpack(*reinterpret_cast<const uint4*>(src + r * ld + d0), vals, T());
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float x = vals[e] * scale;
      if (kTranspose)
        dst[(d0 + e) * kLd + r] = x;
      else
        dst[r * HD + d0 + e] = x;
    }
  }
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr size_t smem_bytes(int hd) {
  // q^T [hd][kLd], k^T [hd][kLd] (also p^T [kTile][kLd]), v [kTile][hd]
  return sizeof(float) * (static_cast<size_t>(hd) * kLd +
                          static_cast<size_t>(hd > kTile ? hd : kTile) * kLd +
                          static_cast<size_t>(kTile) * hd);
}

// window < 0: no window; softcap <= 0: no soft-capping
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
                 int H, int KV, int causal, int window, float softcap, float scale) {
  constexpr int kCols = HD / 16;  // output columns per thread: tx + 16 * c
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + HD * kLd;
  float* vs = ks + (HD > kTile ? HD : kTile) * kLd;
  float* ps = ks;  // p^T takes k^T's place once the scores are made

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int64_t q_ld = static_cast<int64_t>(H) * HD;
  const int64_t kv_ld = static_cast<int64_t>(KV) * HD;
  const T* kb = k + static_cast<int64_t>(b) * Sk * kv_ld + kvh * HD;
  const T* vb = v + static_cast<int64_t>(b) * Sk * kv_ld + kvh * HD;

  load_tile<HD, true>(qs, q + (static_cast<int64_t>(b) * Sq + q0) * q_ld + h * HD,
                      q_ld, scale);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kMasked;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  for (int k0 = 0; k0 < Sk; k0 += kTile) {
    // a key tile is live iff some (row, key) pair of the two tiles passes
    if (causal && k0 > q0 + kTile - 1) break;
    if (window >= 0 && q0 - (k0 + kTile - 1) >= window) continue;
    __syncthreads();  // the previous tile's reads of p^T and v are done
    load_tile<HD, true>(ks, kb + k0 * kv_ld, kv_ld, 1.0f);
    load_tile<HD, false>(vs, vb + k0 * kv_ld, kv_ld, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qs + d * kLd + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(ks + d * kLd + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qa[r], ka[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = q0 + ty * 4 + r;
      float mx = kMasked;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[r][c];
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        const int rel = i - (k0 + tx * 4 + c);
        const bool live = (!causal || rel >= 0) && (window < 0 || rel < window);
        x = live ? x : kMasked;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[r], row_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + row_sum(sum);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
    }

    __syncthreads();  // every read of k^T is done before p^T overwrites it
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(ps + (tx * 4 + c) * kLd + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + j * kLd + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[j * HD + c * 16 + tx];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pa[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = out + (static_cast<int64_t>(b) * Sq + q0 + ty * 4 + r) * q_ld + h * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(orow + c * 16 + tx, acc[r][c] / denom);
  }
}

template <int HD, typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int KV, int causal, int window,
              float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(HD);
  auto kern = flash_fwd_kernel<HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Sq / kTile, B * H);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, KV, causal, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dtype(const void* q, const void* k, const void* v, void* out, int B,
                 int Sq, int Sk, int H, int KV, int hd, int causal, int window,
                 float softcap, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<32, T>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, stream);
    case 64: return launch_hd<64, T>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, stream);
    case 96: return launch_hd<96, T>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, stream);
    case 128: return launch_hd<128, T>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, stream);
    case 256: return launch_hd<256, T>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point: launches the kernel on `stream` (PyTorch's current stream)
// on `device` and returns cudaGetLastError() as an int (0 = launched).  The
// wrapper (kernels/flash_attention.py) has checked shapes, dtypes, alignment:
// Sq and Sk multiples of 64, H a multiple of KV, hd in {32, 64, 96, 128, 256}.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, int B, int Sq, int Sk, int H,
                                      int KV, int hd, int is_bf16, int causal,
                                      int window, float softcap, float scale,
                                      int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_dtype<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, KV, hd, causal,
                                       window, softcap, scale, s);
  return launch_dtype<float>(q, k, v, out, B, Sq, Sk, H, KV, hd, causal, window,
                             softcap, scale, s);
}
