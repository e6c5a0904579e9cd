// Flash attention (forward) for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces flash_attention_pallas of src/repro/kernels/flash_attention.py
// (pallas_call at :111), reached from repro.models.attention._flash_kernel_call
// on every prefill whose length is a multiple of 64.  For every (batch, query
// head, query row) it computes
//     softmax_j( mask( softcap( (q . k_j) / sqrt(hd) ) ) ) . v
// in float32, as the Pallas kernel does: softcap c*tanh(s/c) before the mask,
// causal (rel >= 0) and window (rel < window) masks on absolute positions
// (query and key rows both start at 0), masked logits at -1e30 (not -inf),
// and acc / max(l, 1e-30).  Key tiles in which no (row, key) pair is live are
// skipped, as the Pallas kernel skips its key blocks, and the blocks of the
// longest causal rows launch first.
//
// Layouts are the model's: q and out (B, Sq, H, hd), k and v (B, Sk, KV, hd),
// all contiguous.  A query head h reads KV head h / (H / KV) in place; no
// repeated copy of k and v is made (the Pallas wrapper makes one).
//
// What bounds it on an H100: at the serving shape (B=1, H=40, KV=8, hd=128,
// bf16, causal) it does ~2*S^2*hd*H operations on 2*S*hd*(H+KV)*2 bytes, 850
// operations per byte at S=2048: far above the card's ~295 bf16 tensor-core
// operations per byte, so the bound is operations.  In float32 the same
// holds on the tensor cores' TF32 rate (495 TFLOP/s) at three products for
// one, 3 * 4 hd operations per live pair.
//
// Two kernels, one per input type (kernels/flash_attention.py's variant()),
// both on the tensor cores; batch*head goes on grid.x, which takes up to
// 2^31 - 1 of them, and the sequential key-block axis of the TPU grid
// becomes a loop over key tiles inside the block, up to the causal and
// window limits.
//
// bf16 -> tc::flash_fwd_wgmma_kernel.  A block owns 128 query rows of one
// head: warpgroup 0 is the producer, whose one thread brings the Q tile once
// and then K and V tiles through a ring of 3 stages (2 at hd=256) in shared
// memory with TMA (cp.async.bulk.tensor, 128-, 64- or 32-byte swizzle by the
// width of a row, an mbarrier per stage); warpgroups 1 and 2 each compute 64
// of the rows (setmaxnreg: 24 registers for the producer, 240 for them).  S
// = Q K^T is wgmma bf16 -> float32 with both operands in shared memory; the
// softmax runs in float32 registers (scale after the product, softcap, mask,
// running max, exp in base 2, and l summed from the unrounded p); O += P V
// takes P from registers and V from shared memory (N-major, the transpose
// bit).  A bf16 P would round each probability to 8 bits, which the
// one-bf16-ulp check on the output rejects, so P is split into hi = bf16(p)
// and lo = bf16(p - hi) and both are multiplied by V into one float32 O: 6 hd
// operations per live pair instead of 4, with p's error down to ~2^-16 of p.
// Each warpgroup overlaps the previous tile's P.V with this tile's softmax,
// and the two take turns on the tensor cores.  The rows of a tile that lie
// past Sq (Sq a multiple of 64, the tile 128) are computed on zeros and not
// stored; key rows past Sk read as zeros and are masked.
//
// float32 -> tf32::flash_fwd_tf32x3_kernel.  One TF32 product keeps 11 bits
// of each operand, far from float32's check (1e-5 of the largest output plus
// 1e-5 of the element), so every operand x is split into hi = tf32(x) and lo
// = tf32(x - hi), rounded to nearest (cvt.rna), and each product is three
// wgmma m64nNk8 TF32 products: S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi (the
// last two as one product of Q_hi with K_hi and K_lo stacked, which reads
// Q_hi once for both) and O += P_lo V_hi + P_hi V_lo + P_hi V_hi (lo*lo is
// below float32's rounding; two products are not enough).  TF32 has no
// transpose bit, so both shared operands are K-major: K as it lies, V
// transposed.  A block owns 64 query
// rows of one head: warpgroup 0 loads Q once and then each key tile of K and
// V from global memory, splits it into hi and lo and stores it in the
// swizzled K-major layout wgmma reads (V^T with the keys of each group of 8
// in the order 0, 2, 4, 6, 1, 3, 5, 7, which lets P go from the S
// accumulator to the A fragment with no shuffle), through 2 stages of
// shared memory; stage j holds K_j and V_{j-1}, the operands of the
// consumer's step j.  Warpgroup 1 computes: it issues S_j and P_{j-1}.V_{j-1}
// together, runs the softmax of tile j (as the bf16 kernel's) while the
// tensor cores do the second, and splits P in registers.  The tensor cores
// add into an accumulator with truncation, so each tile's P.V goes into a
// fresh accumulator and O takes it with rounded float32 adds.  Shared memory
// sets the key tile: Q's hi and lo take 512 hd bytes, a stage 16 hd bytes a
// key (64 keys at hd <= 80, 32 at 96 and 128, 8 at 256).  Shared memory's
// bandwidth is what holds it: at hd = 128 a key tile moves ~224 KiB through
// it (the products' reads of Q, K and V^T, the split's stores), against ~1500
// cycles of tensor work.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// --------------------------------------------------------------------------- //
// bf16 on the tensor cores
// --------------------------------------------------------------------------- //
namespace tc {

constexpr int kRows = 128;     // query rows per block: two consumer warpgroups of 64
constexpr int kThreads = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr float kMasked = -1e30f;

// The per-head-width constants.  kBN: key rows per tile (64 at hd=256, where O
// alone takes 128 registers a thread).  kSW: the swizzle span of a tile row in
// bytes, the widest of 128, 64 and 32 that divides a row of hd bf16 values
// (hd = 32 and 96 take 64, hd = 80, a 160-byte row, takes 32), so that a tile
// is kChunks column chunks of kCW values.  kNP: output columns per P.V
// instruction (wgmma's N: hd itself up to 128 where it is a multiple of 64 or
// 16 columns short of one, which m64n80k16 takes at hd = 80).
template <int HD>
struct Cfg {
  static constexpr int kBN = HD > 128 ? 64 : 128;
  static constexpr int kSW = HD % 64 == 0 ? 128 : (HD % 32 == 0 ? 64 : 32);
  static constexpr int kCW = kSW / 2;
  static constexpr int kChunks = HD / kCW;
  static constexpr int kKS = kCW / 16;  // k16 steps per chunk
  static constexpr int kNP = HD > 128 ? 128 : (HD % 64 == 0 ? HD : (HD % 32 == 0 ? 32 : HD));
  static_assert(HD % kCW == 0 && HD % kNP == 0 && kNP % kCW == 0, "head width");
  static constexpr int kStages = HD > 128 ? 2 : 3;  // K and V tiles in flight
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kKVBytes + 64;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of parity `parity` has completed; a wait of more than
// ~2^34 clocks (seconds) is a fault of the pipeline and traps, so that it
// fails the launch instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  long long start = 0;
  for (int polls = 0;; ++polls) {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// one box of the 3-d tensor map at (c0, c1, c2) into shared memory; completes
// its bytes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1: 128 B, 2: 64 B, 3: 32 B)
template <int SW>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  static_assert(SW == 128 || SW == 64 || SW == 32, "swizzle");
  constexpr uint64_t kLayout = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (kLayout << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N = 0>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of an accumulator above the wait
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

#define FA_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),          \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N float32, N/2 a thread) = [d +] A (64 x 16, shared, K-major) .
// B (N x 16, shared, K-major); acc = 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int acc);
// d += A (64 x 16 bf16 in registers, 4 words a thread) . B (16 x N, shared,
// N-major: the transpose bit)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, "
      "0, 0; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0; "
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, "
      "%65, p, 1, 1, 0, 0; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24),
        FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %21, 0; "
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, "
      "%20, p, 1, 1, 1; }"
      : FA_D8(0), FA_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %37, 0; "
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, "
      "%35}, %36, p, 1, 1, 1; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %45, 0; "
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, {%40, %41, %42, %43}, %44, p, 1, 1, 1; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %69, 0; "
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, "
      "%5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, "
      "%51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, "
      "%65, %66, %67}, %68, p, 1, 1, 1; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24),
        FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
// (hi, lo) bf16 pairs of two float32 values: hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact), element 0 in the low half, as wgmma's A fragment wants
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// S = Q K^T of one warpgroup's 64 rows and one key tile, issued (not waited)
template <int HD>
__device__ __forceinline__ void issue_s(float (&sc)[Cfg<HD>::kBN / 2], uint32_t q_base,
                                        uint32_t k_base) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % C::kKS) * 32;
    wgmma_ss<C::kBN>(sc, desc<C::kSW>(q_base + (kk / C::kKS) * kRows * C::kSW + off, 16, 8 * C::kSW),
                     desc<C::kSW>(k_base + (kk / C::kKS) * C::kBN * C::kSW + off, 16, 8 * C::kSW),
                     kk > 0);
  }
}

// O += P_hi V + P_lo V, issued (not waited).  V's tile is N-major (hd
// contiguous): its column chunks are kBN * kSW bytes apart (LBO), its 8-key
// groups 8 * kSW (SBO).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2],
                                         const uint32_t (&hi)[Cfg<HD>::kBN / 16][4],
                                         const uint32_t (&lo)[Cfg<HD>::kBN / 16][4],
                                         uint32_t v_base) {
  using C = Cfg<HD>;
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int kk = 0; kk < C::kBN / 16; ++kk)
#pragma unroll
      for (int pc = 0; pc < HD / C::kNP; ++pc)
        wgmma_rs<C::kNP>(o + pc * C::kNP / 2, half ? lo[kk] : hi[kk],
                         desc<C::kSW>(v_base + pc * (C::kNP / C::kCW) * C::kBN * C::kSW +
                                          kk * 16 * C::kSW,
                                      C::kBN * C::kSW, 8 * C::kSW));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) reg_fence(r[j]);
}

// The softmax works in base 2: the wrapper's scale and softcap come
// multiplied by log2(e), so s * scale is the logit times log2(e), and
// exp(a - b) = 2^(a' - b').  2^x is one instruction of the special-function
// unit (relative error ~2^-22, subnormal results flushed to zero); expf is ten.
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile in float32: scale, softcap, mask,
// running max (m0, m1 for rows r0, r0 + 8), p = 2^(s - m), l from the
// unrounded p (this thread's columns; the quad's four partial sums are added
// at the end), and the rows' alpha (a0, a1).  Element j of sc is row r0 + 8
// ((j / 2) % 2), key k0 + 8 (j / 4) + c0 + j % 2.  kMask: the tile has dead
// pairs; kCap: soft-capping.  On a tile with neither (most of them) the max
// is taken on the raw products (the scale is positive) and p = 2^(s * scale
// - m) is one multiply-add.
template <int kBN, bool kMask, bool kCap>
__device__ __forceinline__ void softmax(float (&sc)[kBN / 2], float& m0, float& m1, float& l0,
                                        float& l1, float& a0, float& a1, int r0, int key0,
                                        int Sk, int causal, int window, float softcap,
                                        float scale) {
  constexpr bool kRaw = !kMask && !kCap;
  float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) {
    float x = kRaw ? sc[j] : sc[j] * scale;
    if (kCap) x = softcap * tanhf(x / softcap);
    if (kMask) {
      const int key = key0 + 8 * (j / 4) + j % 2;
      const int rel = r0 + 8 * ((j / 2) % 2) - key;
      const bool ok = (!causal || rel >= 0) && (window < 0 || rel < window) && key < Sk;
      x = ok ? x : kMasked;
    }
    sc[j] = x;
    if ((j / 2) % 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
  }
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
  }
  const float n0 = fmaxf(m0, kRaw ? mx0 * scale : mx0);
  const float n1 = fmaxf(m1, kRaw ? mx1 * scale : mx1);
  a0 = exp2_(m0 - n0);
  a1 = exp2_(m1 - n1);
  m0 = n0;
  m1 = n1;
  float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) {
    const bool second = (j / 2) % 2;
    const float n = second ? n1 : n0;
    sc[j] = exp2_(kRaw ? fmaf(sc[j], scale, -n) : sc[j] - n);
    if (second) s1 += sc[j]; else s0 += sc[j];
  }
  l0 = l0 * a0 + s0;
  l1 = l1 * a1 + s1;
}

// the softmax with its mask and soft-capping decided once per tile
template <int kBN>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 2], float& m0, float& m1,
                                             float& l0, float& l1, float& a0, float& a1,
                                             bool mask, int r0, int key0, int Sk, int causal,
                                             int window, float softcap, float scale) {
  if (softcap > 0.0f) {
    if (mask)
      softmax<kBN, true, true>(sc, m0, m1, l0, l1, a0, a1, r0, key0, Sk, causal, window,
                               softcap, scale);
    else
      softmax<kBN, false, true>(sc, m0, m1, l0, l1, a0, a1, r0, key0, Sk, causal, window,
                                softcap, scale);
  } else {
    if (mask)
      softmax<kBN, true, false>(sc, m0, m1, l0, l1, a0, a1, r0, key0, Sk, causal, window,
                                softcap, scale);
    else
      softmax<kBN, false, false>(sc, m0, m1, l0, l1, a0, a1, r0, key0, Sk, causal, window,
                                 softcap, scale);
  }
}

// O rescaled by the rows' alpha, and P split into bf16 halves in wgmma's
// A-fragment layout
template <int HD>
__device__ __forceinline__ void rescale_split(const float (&sc)[Cfg<HD>::kBN / 2],
                                              float (&o)[HD / 2],
                                              uint32_t (&hi)[Cfg<HD>::kBN / 16][4],
                                              uint32_t (&lo)[Cfg<HD>::kBN / 16][4], float a0,
                                              float a1) {
#pragma unroll
  for (int j = 0; j < HD / 2; ++j) o[j] *= (j / 2) % 2 ? a1 : a0;
#pragma unroll
  for (int kk = 0; kk < Cfg<HD>::kBN / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], hi[kk][e], lo[kk][e]);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// window < 0: no window; softcap <= 0: no soft-capping
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
                       int Sq, int Sk, int H, int KV, int causal, int window, float softcap,
                       float scale) {
  using C = Cfg<HD>;
  constexpr int kBN = C::kBN, kSW = C::kSW, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ks = qs + C::kQBytes;              // [stage][chunk][kBN rows][kSW bytes]
  uint8_t* vs = ks + kStages * C::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * C::kKVBytes);
  uint64_t* full = q_full + 1;                // K and V of a stage have arrived
  uint64_t* empty = full + kStages;           // the 8 consumer warps are done with it

  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // longest causal rows first
  const int q_end = min(q0 + kRows, Sq);
  // key tiles [t0, t1): those with a live pair for some row of the block
  const int k_hi = causal ? min(Sk, q_end) : Sk;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_lo / kBN, n = max(0, (k_hi + kBN - 1) / kBN - t0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < C::kChunks; ++c)
        tma_load(qs + c * kRows * kSW, &tq, q_full, h * HD + c * C::kCW, q0, b);
      for (int i = 0; i < n; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * C::kKVBytes);
        for (int c = 0; c < C::kChunks; ++c) {
          const int off = s * C::kKVBytes + c * kBN * kSW;
          tma_load(ks + off, &tk, &full[s], kvh * HD + c * C::kCW, (t0 + i) * kBN, b);
          tma_load(vs + off, &tv, &full[s], kvh * HD + c * C::kCW, (t0 + i) * kBN, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup w owns query rows q0 + 64 w .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int w = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128, lane = tid % 32;
  const int rw_lo = q0 + 64 * w, rw_hi = rw_lo + 63;
  const bool rows_valid = rw_lo < Sq;          // Sq is a multiple of 64
  const int r0 = rw_lo + 16 * (tid / 32) + lane / 4;   // this thread's rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);                        // and columns c0, c0 + 1 of each 8
  const uint32_t q_base = smem_u32(qs) + 64 * w * kSW;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float sc[kBN / 2];
  uint32_t hi[kBN / 16][4], lo[kBN / 16][4];
  float m0 = kMasked, m1 = kMasked, l0 = 0.0f, l1 = 0.0f;
  mbar_wait(q_full, 0);

  // whether every pair of the key tile at k0 is live for this warpgroup's
  // rows (no mask needed)
  auto all_live = [&](int k0) {
    return (!causal || k0 + kBN - 1 <= rw_lo) && (window < 0 || rw_hi - k0 < window) &&
           k0 + kBN <= Sk;
  };

  // P.V of tile i - 1 runs on the tensor cores while the softmax of tile i
  // runs: S_i and P_{i-1}.V are issued as two groups, the softmax waits for
  // the first only, and O is rescaled and P_i split once the second is done.
  // The two warpgroups take turns to issue (named barriers 1 and 2, one
  // turn each per tile, warpgroup 0 first), so that one's products queue on
  // the tensor cores while the other runs its softmax.  A stage is released
  // after its P.V, one tile later.  Every tile of the
  // block's range is computed for both warpgroups, so that no wgmma sits on
  // a path that differs between them (ptxas would serialize them all); a
  // tile with no live pair for a row adds nothing to it (p = 0 once a live
  // key has set the row's max; before that, alpha = 0 wipes what it added).
  if (n > 0) {
    float a0, a1;
    if (w == 1) named_arrive(1);     // warpgroup 0 goes first
    mbar_wait(&full[0], 0);
    named_sync(1 + w);
    wg_fence();
    issue_s<HD>(sc, q_base, smem_u32(ks));
    wg_commit();
    named_arrive(2 - w);
    wg_wait();
    fence_regs(sc);
    softmax_tile<kBN>(sc, m0, m1, l0, l1, a0, a1, !all_live(t0 * kBN), r0, t0 * kBN + c0, Sk,
                      causal, window, softcap, scale);
    rescale_split<HD>(sc, o, hi, lo, a0, a1);
    for (int i = 1; i < n; ++i) {
      const int s = i % kStages, sp = (i - 1) % kStages, k0 = (t0 + i) * kBN;
      mbar_wait(&full[s], (i / kStages) & 1);
      named_sync(1 + w);
      wg_fence();
      issue_s<HD>(sc, q_base, smem_u32(ks + s * C::kKVBytes));
      wg_commit();
      issue_pv<HD>(o, hi, lo, smem_u32(vs + sp * C::kKVBytes));
      wg_commit();
      named_arrive(2 - w);
      wg_wait<1>();
      fence_regs(sc);
      softmax_tile<kBN>(sc, m0, m1, l0, l1, a0, a1, !all_live(k0), r0, k0 + c0, Sk, causal,
                        window, softcap, scale);
      wg_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sp]);
      rescale_split<HD>(sc, o, hi, lo, a0, a1);
    }
    named_sync(1 + w);
    wg_fence();
    issue_pv<HD>(o, hi, lo, smem_u32(vs + ((n - 1) % kStages) * C::kKVBytes));
    wg_commit();
    if (w == 0) named_arrive(2);
    wg_wait();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[(n - 1) % kStages]);
  }

  if (!rows_valid) return;
#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int64_t ld = static_cast<int64_t>(H) * HD;
  __nv_bfloat16* row0 = out + (static_cast<int64_t>(b) * Sq + r0) * ld + h * HD + c0;
  __nv_bfloat16* row1 = row0 + 8 * ld;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(row0 + 8 * j) =
        __floats2bfloat162_rn(o[4 * j] / d0, o[4 * j + 1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(row1 + 8 * j) =
        __floats2bfloat162_rn(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, heads * hd) bf16 as a 3-d map whose box is `box_rows` rows of one
// kCW-column chunk; rows past S read as zeros
template <int HD>
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int B, int S,
                int heads, int box_rows) {
  using C = Cfg<HD>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(heads) * HD,
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * 2 * dims[1]};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(C::kCW),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                C::kSW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                              : (C::kSW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B),
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
              int H, int KV, int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  using C = Cfg<HD>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tq, tk, tv;
  if (!tensor_map<HD>(&tq, encode, q, B, Sq, H, kRows) ||
      !tensor_map<HD>(&tk, encode, k, B, Sk, KV, C::kBN) ||
      !tensor_map<HD>(&tv, encode, v, B, Sk, KV, C::kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_fwd_wgmma_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  kern<<<grid, kThreads, C::kSmem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq,
                                              Sk, H, KV, causal, window, softcap * kLog2e,
                                              scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// --------------------------------------------------------------------------- //
// float32 on the tensor cores: each product as three TF32 products
// --------------------------------------------------------------------------- //
namespace tf32 {

using tc::desc;
using tc::fence_regs;
using tc::kLog2e;
using tc::kMasked;
using tc::mbar_arrive;
using tc::mbar_init;
using tc::mbar_wait;
using tc::smem_u32;
using tc::softmax_tile;
using tc::wg_commit;
using tc::wg_fence;
using tc::wg_wait;

constexpr int kRows = 64;      // query rows per block: one consumer warpgroup
constexpr int kThreads = 256;  // warpgroup 0 splits the tiles, warpgroup 1 computes

// The per-head-width constants.  kBN: key rows per tile, as many as shared
// memory holds in two stages beside Q (Q alone, hi and lo, is 512 hd bytes:
// 128 KiB at hd = 256).  kSW: the swizzle span of a row of Q and K (hd
// floats), the widest of 128, 64 and 32 bytes that divides it (hd = 80, a
// 320-byte row, takes 64), so that a tile is HD / kCW column chunks of kCW
// floats, kKS k8 steps each.  kVSW: the same for a row of V^T (kBN keys).
// kNP: output columns per P.V instruction.
template <int HD>
struct Cfg {
  static constexpr int kBN = HD > 128 ? 8 : (HD > 80 ? 32 : 64);
  static constexpr int kSW = HD * 4 % 128 == 0 ? 128 : (HD * 4 % 64 == 0 ? 64 : 32);
  static constexpr int kCW = kSW / 4;
  static constexpr int kKS = kCW / 8;
  static constexpr int kVSW = kBN * 4 >= 128 ? 128 : kBN * 4;
  static constexpr int kVCW = kVSW / 4;
  static constexpr int kVKS = kVCW / 8;
  static constexpr int kNP = HD > 128 ? 128 : HD;
  static constexpr int kStages = 2;
  static constexpr int kQBytes = kRows * HD * 4;    // Q_hi; Q_lo as much again
  static constexpr int kKVBytes = kBN * HD * 4;     // each of K_hi, K_lo, V_hi^T, V_lo^T
  static constexpr int kStageBytes = 4 * kKVBytes;
  static constexpr int kSmem = 1024 + 2 * kQBytes + kStages * kStageBytes + 64;
  static_assert(HD % kCW == 0 && kBN % kVCW == 0 && HD % kNP == 0 && kKVBytes % 1024 == 0,
                "head width");
};

// d (64 x N float32, N/2 a thread) = [d +] A (64 x 8 tf32, shared, K-major) .
// B (N x 8 tf32, shared, K-major); acc = 0 overwrites d.  TF32 has no
// transpose bit: both operands are K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int acc);
// d = [d +] A (64 x 8 tf32 in registers, 4 words a thread) . B (N x 8, shared,
// K-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t b, int acc);

template <>
__device__ __forceinline__ void wgmma_ss<8>(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %6, 0; "
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, %4, %5, p, "
      "1, 1; }"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<16>(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %10, 0; "
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7}, %8, %9, p, 1, 1; }"
      : FA_D8(0)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %18, 0; "
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1; }"
      : FA_D8(0), FA_D8(8)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %34, 0; "
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %66, 0; "
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %21, 0; "
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1; }"
      : FA_D8(0), FA_D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %37, 0; "
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, "
      "1; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %45, 0; "
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39}, {%40, %41, %42, %43}, %44, p, 1, 1; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %53, 0; "
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, "
      "%7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, "
      "1; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t b, int acc) {
  asm volatile(
      "{ .reg .pred p; setp.ne.b32 p, %69, 0; "
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, "
      "%6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, "
      "%23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, "
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, "
      "1; }"
      : FA_D8(0), FA_D8(8), FA_D8(16), FA_D8(24), FA_D8(32), FA_D8(40), FA_D8(48), FA_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}
#undef FA_D8

__device__ __forceinline__ uint32_t tf32_bits(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest (ties away):
// x - hi is exact, and hi + lo is x within ~2^-22 of x
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
}

__device__ __forceinline__ float lane_of(const float4& x, int e) {
  return e == 0 ? x.x : (e == 1 ? x.y : (e == 2 ? x.z : x.w));
}

// the byte offset of `off` in a tile of SW-byte rows, as TMA and wgmma lay it
// out: 16-byte units XOR the row within the swizzle's period (the tile starts
// on a 1024-byte boundary)
template <int SW>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (SW / 16 - 1)) << 4);
}

// what the splitting warpgroup's writes must pass before wgmma (the async
// proxy) reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// R rows of HD floats (row stride ld): thread t of the splitting warpgroup
// loads float4 unit u = t + 128 i (row u / (HD / 4)) and stores its hi and
// lo halves K-major, as wgmma reads A and B: [chunk][2R rows, hi then
// lo][kSW bytes]
template <int HD, int R>
struct RowTile {
  using C = Cfg<HD>;
  static constexpr int kUnits = R * HD / 4, kPer = (kUnits + 127) / 128;
  float4 x[kPer];

  __device__ __forceinline__ static bool live(int u) { return kUnits % 128 == 0 || u < kUnits; }

  __device__ __forceinline__ static void store(uint8_t* dst, int u, const float4& x) {
    const int r = u / (HD / 4), col = u % (HD / 4) * 4;
    uint4 hi, lo;
    split4(x, hi, lo);
    const uint32_t off = col / C::kCW * 2 * R * C::kSW + r * C::kSW + col % C::kCW * 4;
    *reinterpret_cast<uint4*>(dst + swizzle<C::kSW>(off)) = hi;
    *reinterpret_cast<uint4*>(dst + swizzle<C::kSW>(off + R * C::kSW)) = lo;
  }

  __device__ __forceinline__ static const float4* at(const float* src, int64_t ld, int u) {
    return reinterpret_cast<const float4*>(src + u / (HD / 4) * ld + u % (HD / 4) * 4);
  }

  __device__ __forceinline__ void load(const float* __restrict__ src, int64_t ld, int t) {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (live(t + 128 * i)) x[i] = __ldg(at(src, ld, t + 128 * i));
  }

  __device__ __forceinline__ void store(uint8_t* dst, int t) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (live(t + 128 * i)) store(dst, t + 128 * i, x[i]);
  }
};

// A key tile of V, split and transposed for the B operand of P.V (keys are
// its K): V_hi^T at dst, V_lo^T kKVBytes further, each [chunk of kVCW
// keys][HD rows][kVSW bytes], with the keys of each group of 8 in the order
// 0, 2, 4, 6, 1, 3, 5, 7 (see split_p).  Unit u: the four keys 8 g + e + {0,
// 2, 4, 6} (quad q = u % kQuads = 2 g + e), which land side by side at
// position 4 q, at columns 4 (u / kQuads) .. + 3: one 16-byte store per
// column.  The quad varies fastest, so that the 8 stores of a wavefront
// meet 8 quads of one row, 8 distinct 16-byte units at kBN >= 32 (columns
// fastest, they met 2: a 4-way bank conflict on every store).
template <int HD>
struct VTile {
  using C = Cfg<HD>;
  static constexpr int kQuads = C::kBN / 4;
  static constexpr int kUnits = kQuads * (HD / 4), kPer = (kUnits + 127) / 128;
  float4 x[kPer][4];

  __device__ __forceinline__ static bool live(int u) { return kUnits % 128 == 0 || u < kUnits; }

  __device__ __forceinline__ void load(const float* __restrict__ src, int64_t ld, int t) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = t + 128 * i;
      if (!live(u)) continue;
      const int quad = u % kQuads, key = 8 * (quad / 2) + quad % 2, col = u / kQuads * 4;
#pragma unroll
      for (int m = 0; m < 4; ++m)
        x[i][m] = __ldg(reinterpret_cast<const float4*>(src + (key + 2 * m) * ld + col));
    }
  }

  __device__ __forceinline__ void store(uint8_t* dst, int t) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int u = t + 128 * i;
      if (!live(u)) continue;
      const int pos = 4 * (u % kQuads), col = u / kQuads * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint4 hi, lo;
        split4(make_float4(lane_of(x[i][0], e), lane_of(x[i][1], e), lane_of(x[i][2], e),
                           lane_of(x[i][3], e)),
               hi, lo);
        const uint32_t off = swizzle<C::kVSW>(pos / C::kVCW * HD * C::kVSW +
                                              (col + e) * C::kVSW + pos % C::kVCW * 4);
        *reinterpret_cast<uint4*>(dst + off) = hi;
        *reinterpret_cast<uint4*>(dst + C::kKVBytes + off) = lo;
      }
    }
  }
};

// S = Q K^T of the block's 64 rows and one key tile, issued (not waited),
// into acc (64 x 2 kBN, zeroed first): the n = 2 kBN product of Q_hi with
// K_hi and K_lo stacked (they lie so in the stage, rows 0 .. kBN - 1 and kBN
// .. 2 kBN - 1 of each chunk) gives Q_hi K_hi in columns 0 .. kBN - 1 and
// Q_hi K_lo in kBN .. 2 kBN - 1, one read of Q_hi for both; Q_lo K_hi goes
// into the first half, first.  S is the sum of the halves (sum_halves).
template <int HD>
__device__ __forceinline__ void issue_s(float (&acc)[Cfg<HD>::kBN], uint32_t q, uint32_t k) {
  using C = Cfg<HD>;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const uint32_t off = kk % C::kKS * 32;
      const uint64_t a = desc<C::kSW>(
          q + kk / C::kKS * 2 * kRows * C::kSW + off + (t == 0 ? kRows * C::kSW : 0), 16,
          8 * C::kSW);
      const uint64_t b =
          desc<C::kSW>(k + kk / C::kKS * 2 * C::kBN * C::kSW + off, 16, 8 * C::kSW);
      if (t == 0)
        wgmma_ss<C::kBN>(acc, a, b, 1);
      else
        wgmma_ss<2 * C::kBN>(acc, a, b, 1);
    }
}

// S (the first half of acc) = the two halves' sum
template <int kBN>
__device__ __forceinline__ float (&sum_halves(float (&acc)[kBN]))[kBN / 2] {
#pragma unroll
  for (int j = 0; j < kBN / 2; ++j) acc[j] += acc[j + kBN / 2];
  return *reinterpret_cast<float(*)[kBN / 2]>(acc);
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) r[j] = 0.0f;
}

// P.V of output columns g kNP .. + kNP - 1 into pv, which it overwrites,
// issued (not waited): P_lo V_hi + P_hi V_lo + P_hi V_hi.  v: V_hi^T, V_lo^T
// kKVBytes further.  A fresh accumulator per tile: the tensor cores add
// into an accumulator with truncation, so that O summed in place over
// thousands of keys drifts towards zero, past the float32 check on long
// rows without a causal mask; pv sums 3 kBN / 8 products and O takes it
// with rounded float32 adds.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&pv)[Cfg<HD>::kNP / 2],
                                         const uint32_t (&hi)[Cfg<HD>::kBN / 8][4],
                                         const uint32_t (&lo)[Cfg<HD>::kBN / 8][4], uint32_t v,
                                         int g) {
  using C = Cfg<HD>;
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int kk = 0; kk < C::kBN / 8; ++kk)
      wgmma_rs<C::kNP>(pv, t == 0 ? lo[kk] : hi[kk],
                       desc<C::kVSW>(v + (t == 1 ? C::kKVBytes : 0) + kk / C::kVKS * HD * C::kVSW +
                                         g * C::kNP * C::kVSW + kk % C::kVKS * 32,
                                     16, 8 * C::kVSW),
                       t > 0 || kk > 0);
}

// P (the first half of acc, once the softmax has run on it) split into
// TF32 halves in wgmma's A-fragment layout.  For k8 step kk a
// thread holds A columns c and c + 4 (c = lane % 4) of rows r0 and r0 + 8,
// and of S the keys 8 kk + 2c and 2c + 1: V^T stores the keys of each group
// of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7, so that column c meets key 2c and
// column c + 4 key 2c + 1, and P needs no shuffle.  Fragment words: (r0, c),
// (r0 + 8, c), (r0, c + 4), (r0 + 8, c + 4).
template <int HD>
__device__ __forceinline__ void split_p(const float (&acc)[Cfg<HD>::kBN],
                                        uint32_t (&hi)[Cfg<HD>::kBN / 8][4],
                                        uint32_t (&lo)[Cfg<HD>::kBN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < Cfg<HD>::kBN / 8; ++kk) {
    split(acc[4 * kk], hi[kk][0], lo[kk][0]);
    split(acc[4 * kk + 2], hi[kk][1], lo[kk][1]);
    split(acc[4 * kk + 1], hi[kk][2], lo[kk][2]);
    split(acc[4 * kk + 3], hi[kk][3], lo[kk][3]);
  }
}

// Finish P.V of one tile, whose column group 0 is in flight into pv: O's
// columns of each group += pv, times the rows' alpha (a0, a1), issuing the
// next group (hd = 256 has two) once pv is free.
template <int HD>
__device__ __forceinline__ void finish_pv(float (&o)[HD / 2], float (&pv)[Cfg<HD>::kNP / 2],
                                          const uint32_t (&hi)[Cfg<HD>::kBN / 8][4],
                                          const uint32_t (&lo)[Cfg<HD>::kBN / 8][4], uint32_t v,
                                          float a0, float a1) {
  constexpr int kNP = Cfg<HD>::kNP;
#pragma unroll
  for (int g = 0; g < HD / kNP; ++g) {
    if (g > 0) {
      wg_fence();
      issue_pv<HD>(pv, hi, lo, v, g);
      wg_commit();
    }
    wg_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int j = 0; j < kNP / 2; ++j)
      o[g * kNP / 2 + j] = (o[g * kNP / 2 + j] + pv[j]) * ((j / 2) % 2 ? a1 : a0);
  }
}

// window < 0: no window; softcap <= 0: no soft-capping
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, int Sq, int Sk,
                        int H, int KV, int causal, int window, float softcap, float scale) {
  using C = Cfg<HD>;
  constexpr int kBN = C::kBN, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* stages = qs + 2 * C::kQBytes;   // [stage][K hi/lo, V_hi^T, V_lo^T]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(stages + kStages * C::kStageBytes);
  uint64_t* full = q_full + 1;             // a stage is split and stored
  uint64_t* empty = full + kStages;        // the 4 consumer warps are done with it

  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // longest causal rows first
  // key tiles [t0, t0 + n): those with a live pair for some row of the block
  const int k_hi = causal ? min(Sk, q0 + kRows) : Sk;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_lo / kBN, n = max(0, (k_hi + kBN - 1) / kBN - t0);
  const int64_t q_ld = static_cast<int64_t>(H) * HD, kv_ld = static_cast<int64_t>(KV) * HD;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 128);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // the splitting warpgroup: Q once, then stage j holds K_j (j < n) and
    // V_{j-1} (j > 0), the operands of the consumer's step j, so that a
    // step frees the whole stage it read
    const int t = threadIdx.x;
    using QTile = RowTile<HD, kRows>;
    const float* qb = q + (static_cast<int64_t>(b) * Sq + q0) * q_ld + h * HD;
#pragma unroll 4
    for (int u = t; u < QTile::kUnits; u += 128) QTile::store(qs, u, __ldg(QTile::at(qb, q_ld, u)));
    fence_proxy_async();
    mbar_arrive(q_full);
    const float* kb = k + static_cast<int64_t>(b) * Sk * kv_ld + kvh * HD;
    const float* vb = v + static_cast<int64_t>(b) * Sk * kv_ld + kvh * HD;
    RowTile<HD, kBN> kt;
    VTile<HD> vt;
    for (int j = 0; n > 0 && j <= n; ++j) {
      const int s = j % kStages;
      uint8_t* st = stages + s * C::kStageBytes;
      if (j < n) kt.load(kb + static_cast<int64_t>(t0 + j) * kBN * kv_ld, kv_ld, t);
      if (j > 0) vt.load(vb + static_cast<int64_t>(t0 + j - 1) * kBN * kv_ld, kv_ld, t);
      mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
      if (j < n) kt.store(st, t);
      if (j > 0) vt.store(st + 2 * C::kKVBytes, t);
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // the consumer warpgroup: rows q0 .. q0 + 63
  const int tid = threadIdx.x - 128, lane = tid % 32;
  const int r0 = q0 + 16 * (tid / 32) + lane / 4;   // this thread's rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);                    // and columns c0, c0 + 1 of each 8
  uint32_t q_base = smem_u32(qs);
  const uint32_t s_base = smem_u32(stages);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float acc[kBN], pv[C::kNP / 2];
  uint32_t hi[kBN / 8][4], lo[kBN / 8][4];
  float m0 = kMasked, m1 = kMasked, l0 = 0.0f, l1 = 0.0f;
  mbar_wait(q_full, 0);

  // whether every pair of the key tile at k0 is live for the block's rows
  auto all_live = [&](int k0) {
    return (!causal || k0 + kBN - 1 <= q0) && (window < 0 || q0 + kRows - 1 - k0 < window) &&
           k0 + kBN <= Sk;
  };

  // Step j issues S_j and P_{j-1}.V_{j-1} as two groups; the softmax of
  // tile j waits for the first only and runs while the tensor cores do the
  // second; O takes P_{j-1}.V_{j-1} and the rows' alpha and P_j is split
  // once both are done, and the stage goes back to the splitter.
  if (n > 0) {
    float a0, a1;
    mbar_wait(&full[0], 0);
    zero(acc);
    wg_fence();
    issue_s<HD>(acc, q_base, s_base);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[0]);
    softmax_tile<kBN>(sum_halves(acc), m0, m1, l0, l1, a0, a1, !all_live(t0 * kBN), r0,
                      t0 * kBN + c0, Sk, causal, window, softcap, scale);
    split_p<HD>(acc, hi, lo);
    for (int j = 1; j < n; ++j) {
      const int s = j % kStages, k0 = (t0 + j) * kBN;
      const uint32_t st = s_base + s * C::kStageBytes;
      // recomputed each step: held across steps, Q's descriptors would take
      // a register per product and k8 step
      asm volatile("" : "+r"(q_base));
      mbar_wait(&full[s], (j / kStages) & 1);
      zero(acc);
      wg_fence();
      issue_s<HD>(acc, q_base, st);
      wg_commit();
      issue_pv<HD>(pv, hi, lo, st + 2 * C::kKVBytes, 0);
      wg_commit();
      wg_wait<1>();
      fence_regs(acc);
      softmax_tile<kBN>(sum_halves(acc), m0, m1, l0, l1, a0, a1, !all_live(k0), r0, k0 + c0,
                        Sk, causal, window, softcap, scale);
      finish_pv<HD>(o, pv, hi, lo, st + 2 * C::kKVBytes, a0, a1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      split_p<HD>(acc, hi, lo);
    }
    const uint32_t st = s_base + n % kStages * C::kStageBytes;
    mbar_wait(&full[n % kStages], (n / kStages) & 1);
    wg_fence();
    issue_pv<HD>(pv, hi, lo, st + 2 * C::kKVBytes, 0);
    wg_commit();
    finish_pv<HD>(o, pv, hi, lo, st + 2 * C::kKVBytes, 1.0f, 1.0f);
  }

#pragma unroll
  for (int x = 1; x < 4; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float* row0 = out + (static_cast<int64_t>(b) * Sq + r0) * q_ld + h * HD + c0;
  float* row1 = row0 + 8 * q_ld;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<float2*>(row0 + 8 * j) = make_float2(o[4 * j] / d0, o[4 * j + 1] / d0);
    *reinterpret_cast<float2*>(row1 + 8 * j) = make_float2(o[4 * j + 2] / d1, o[4 * j + 3] / d1);
  }
}

template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,
              int H, int KV, int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  using C = Cfg<HD>;
  auto kern = flash_fwd_tf32x3_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, Sq / kRows);
  kern<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Sk, H, KV, causal, window, softcap * kLog2e,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32

// C entry points: each launches its kernel on `stream` (PyTorch's current
// stream) on `device` and returns a CUDA error code as an int (0 =
// launched).  The wrapper (kernels/flash_attention.py) has checked shapes,
// dtypes, alignment: Sq and Sk multiples of 64, H a multiple of KV, hd in
// {32, 64, 80, 96, 128, 256}.
#define FA_DISPATCH(NS)                                                                  \
  switch (hd) {                                                                          \
    case 32: return NS::launch_hd<32>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,    \
                                      softcap, scale, s);                                \
    case 64: return NS::launch_hd<64>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,    \
                                      softcap, scale, s);                                \
    case 80: return NS::launch_hd<80>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,    \
                                      softcap, scale, s);                                \
    case 96: return NS::launch_hd<96>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,    \
                                      softcap, scale, s);                                \
    case 128: return NS::launch_hd<128>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,  \
                                        softcap, scale, s);                              \
    case 256: return NS::launch_hd<256>(q, k, v, out, B, Sq, Sk, H, KV, causal, window,  \
                                        softcap, scale, s);                              \
    default: return static_cast<int>(cudaErrorInvalidValue);                             \
  }

// float32 q, k, v, out; pointers 16-byte aligned
extern "C" int flash_attention_tf32x3_launch(const void* q, const void* k, const void* v,
                                             void* out, int B, int Sq, int Sk, int H, int KV,
                                             int hd, int causal, int window, float softcap,
                                             float scale, int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(tf32)
}

// bf16 q, k, v, out; pointers 16-byte aligned
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* out, int B, int Sq, int Sk, int H, int KV,
                                            int hd, int causal, int window, float softcap,
                                            float scale, int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(tc)
}
