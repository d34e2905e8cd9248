// Block-wise online-softmax attention (flash attention) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention: q (B, S, H, D),
// k, v (B, S, KV, D) in one float dtype → o (B, S, H, D) in that dtype. Head h
// reads KV head h / (H / KV) (GQA). Masks: key position < S; causal: pos_q >=
// pos_k; window > 0: pos_q - pos_k < window. Arithmetic is the Pallas kernel's,
// in f32: s = scale·(q·k), m_new = max(m, rowmax s), p = exp(s - m_new), corr =
// exp(m - m_new), l = l·corr + Σp, acc = acc·corr + p·v, o = acc / max(l,
// 1e-30), rounded once to q's dtype. Masked scores are the finite -1e30, never
// -inf. A key tile is skipped only where no row of the block can see it (the
// reference's causal `break` and window `continue`), so the live tiles are one
// contiguous range.
//
// What bounds it on an H100: operations, 4·D flops per unmasked (q, k) pair
// per head against a few bytes per pair. Two forward bodies, both on wgmma:
//
// * bf16 / fp16 (flash_fwd_kernel): Hopper's TMA, mbarriers and wgmma, warp
//   specialised. A block owns 128 query rows of one head: warpgroup 0 loads
//   (one thread issues every TMA copy, then the warpgroup gives its registers
//   up with setmaxnreg), warpgroups 1 and 2 compute 64 rows each with 240
//   registers a thread. Q arrives once; the live key tiles of 128 keys (K and
//   V) stream through a ring of full / empty mbarriers, 3 stages at D 128
//   (224 KB of shared memory with Q) and 4 below; TMA fills zeros past S.
//   Tiles use the 128-byte swizzle from D 64 up (a D 128 row in two column
//   blocks), below D 64 the row's own width. S = Q·Kᵀ is a wgmma m64n128k16
//   per 16 of D with both operands in shared memory. The online softmax runs
//   in the accumulator's own layout (two quad shuffles a row), in base 2: p =
//   2^(scale·log2e·s − scale·log2e·m), one FFMA and one ex2.approx each; a
//   row that has seen only masked keys keeps m = -1e30 and takes p = 0 on
//   them, where the reference takes p = 1 and wipes it at its first real key
//   (corr = 0): both leave l and acc at that key's terms. The mask is tested
//   only on tiles that cross S, the diagonal or the window's edge for some
//   row of the block. P stays at the reference's f32 precision: P_hi =
//   round(P), P_lo = round(P − P_hi), both 16-bit, go back as wgmma's A
//   operand from registers (the accumulator's layout is the A fragment's),
//   and O += P_hi·V + P_lo·V with V read MN-major from the very tile that
//   arrived: 3 products of 2·D flops per pair where the bound counts 2, so
//   the floor is 1.5× the bound at the full wgmma rate (SDPA rounds P once
//   and sits 14× over the one-rounding gate, so its time is out of reach).
//   Overlap: each warpgroup issues S(j) and P(j−1)·V(j−1) together and runs
//   softmax(j) under its own P(j−1)·V(j−1); the two warpgroups also
//   ping-pong on two named barriers (each issues its products only after the
//   other issued its own), so one's softmax runs under the other's products.
//   Every branch between a wgmma and its wait depends on the block alone: one
//   that differed between the warpgroups made ptxas serialise the wgmmas
//   (C7518), 9–20% slower on an H100. O stays in f32 registers and is
//   rounded once at the end; lse (m·scale + log l) is written when asked.
//   Blocks launch heaviest causal tile first across a chunk of heads (whole
//   KV groups whose K and V fit in 24 MB, chosen by the wrapper:
//   flash_attention.py ForwardLaunch.chunk), chunk after chunk, so K and V are
//   read from HBM about once: 132 blocks of as many heads evicted them from
//   the 50 MB L2 and made a multi-head layer re-read them (moonshot, 16 KV
//   heads: −15% on an H100).
// * f32 (flash_fwd_f32_kernel): the same machinery, with every f32 operand
//   carried as three bf16 terms, x = x_hi + x_mid + x_lo (each the rounded
//   residue of the last; fused_topk_score.cu's split), so the products run
//   on wgmma at the bf16 rate and stay exact in f32. bf16 and not TF32:
//   wgmma reads an MN-major (transposed) B, as P·V needs V, only in 16 bits,
//   and 3×TF32 keeps fewer bits. S = Q·Kᵀ and O += P·V each sum six
//   products: hi·hi, hi·mid, mid·hi, hi·lo, lo·hi, mid·mid (prod_a /
//   prod_b). What the other three add is below an f32 rounding: with the
//   six the emulation in tests/test_torch_ops.py stays within 2e-6 of the
//   attention in f64, and dropping any one of the 2^-16 products costs
//   over 5× that, in the 2e-5 contract's range. The emulation sums in f32
//   to nearest, so it bounds the split and the products only: on an H100
//   (probes/flash_f32_gates.py, "isolate") the body's error against f64
//   attention is the plain version's with one key tile and grows with
//   the tiles, and with V = 1 (O = Σ P's terms × 1, exact but for the
//   sums) o falls short of 1 by 1.3e-6 on average at S 2,048 (9e-8 at S
//   64): wgmma's own f32 accumulation, not the products kept, makes most
//   of the 3e-6–6e-6 it reads against the plain version. So 12 products
//   of 2·D flops a pair where the bound counts 4·D: the floor is 6× the
//   bound at the wgmma rate. Shared memory decides the rest: three terms of
//   a 128-key K and V tile take 192 KB a stage at D 128, so
//   (a) one small pass (flash_split3_kernel) writes K and V as rows of
//       three terms (3·D bf16), which TMA loads as three 16-bit tiles;
//   (b) the key tile is 64, a stage K's and V's three terms (96 KB at D
//       128: 2 stages; 4 below);
//   (c) Q·scale (pre-scaled, as the reference scales q) is read once and
//       split into its terms in registers, wgmma's A operand (96 registers
//       at D 128); P is split in registers as the 16-bit body splits it.
//   With Q's registers a warpgroup cannot hold S(j) and P(j−1) at once, so
//   it runs S, softmax, P·V in turn and the other warpgroup's products run
//   under its softmax (no ping-pong barriers). The softmax is the 16-bit
//   body's, with p = 2^((s − m)·log2 e) (the difference first: exact where
//   it matters) on pre-scaled scores.
//
// The backward (flash_attention_backward) replaces no Pallas kernel: the
// reference differentiates its jnp path. From the forward's o and row lse it
// recomputes P = exp(scale·S − lse), takes Dvec = rowsum(dO∘O) and dS = P ∘
// (dP − Dvec), and returns dQ = scale·dS·K, dK = scale·dSᵀ·Q, dV = Pᵀ·dO, f32
// sums rounded once, no float atomics (every element summed in a fixed order):
//
// * bf16 / fp16: two kernels built on Hopper's TMA, mbarriers and wgmma, the
//   same shape each: warpgroup 0 loads (one thread issues every TMA copy, then
//   the warpgroup gives its registers up with setmaxnreg), warpgroups 1 and 2
//   compute (240 registers a thread), 64 rows each. flash_bwd_dkdv_kernel owns
//   128 keys of one KV head: K and V arrive once; Q, dO, lse·log2 e and Dvec
//   tiles of 64 queries of every query head of the group stream through a
//   3-stage ring (full / empty mbarriers), over the contiguous live range.
//   Each warpgroup computes Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (wgmma m64n64k16, both
//   operands from shared memory), Pᵀ = 2^(Sᵀ·scale·log2 e − lse·log2 e) with
//   ex2.approx.ftz, dSᵀ, then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ as A
//   from registers (the accumulator's layout is the A fragment's) and dO, Q as
//   B read MN-major (transposed) from the very tiles the first products read
//   K-major. flash_bwd_dq_kernel owns 128 query rows of one head and streams
//   the live 64-key K and V tiles (heaviest causal blocks first): S = Q·Kᵀ,
//   dP = dO·Vᵀ, dQ += dS·K with K read MN-major. Tiles use the 128-byte
//   swizzle (a D 64 row is one 128-byte atom, a D 128 row two column blocks);
//   below D 64 the row's own width. A warpgroup skips a step none of its
//   pairs can see. P and dS are split into a rounded part and a rounded
//   residue (two 16-bit products each) as in the forward: rounded once, the
//   16-bit gradients miss their one-rounding gate by 5–14× in bf16
//   (measured). In all, 10 products of 2·D flops per unmasked pair where the
//   bound counts 5: S and dP twice, dV, dK and dQ split. A row-dot kernel
//   first writes Dvec and lse·log2 e in rows padded to a multiple of 4 (TMA
//   boxes start 16-byte aligned).
// * f32 (flash_bwd_dkdv_f32_kernel, flash_bwd_dq_f32_kernel): the 16-bit
//   kernels' shape with every operand in three bf16 terms, as the f32 forward
//   carries them. A pass (flash_split3_kernel) writes q·scale, k, v and dO as
//   rows of 3·D bf16 into the launch's scratch (12·B·S·(H + KV)·D bytes), which
//   TMA loads as 16-bit tiles; P and dS are split in registers (split3 on the
//   accumulator, whose layout is the A fragment's). S, dP, dV, dK and dQ each
//   sum the forward's six products (prod_a / prod_b): 42 products of 2·D flops
//   a pair where the bound counts 10·D, so the floor is 8.4× the bound at the
//   wgmma rate. The emulation in tests/test_torch_autograd.py decided it: with
//   six each the gradients hold the CPU tests' f32 contract (1e-5 + 1e-5·|g|)
//   against jax.vjp and against the backward in f64 (0.07–0.11 of it, the
//   plain f32 backward 0.10–0.12); against the formulas in f64 on the same
//   f32 operands the six miss by < 1e-6, and dropping any one 2^-16 product
//   of any of the five costs over 10× that; the three products down to the
//   2^-8 terms would hold the card's gate (FLASH_BWD_REL) 8× over but miss
//   the f32 contract 2.3–2.9×. Shared
//   memory decides the tiles (b32_rows / b32_tile / b32_stages): a block keeps
//   its own two operands' three terms resident (dK/dV: K and V; dQ: Q·scale
//   and dO) and streams the other two's through the ring. From D 64 down it
//   keeps 128 rows and its two consumer warpgroups own 64 each and read every
//   64-row tile, as the 16-bit kernels do (192 KB at D 64: two stages). At D
//   128 the three terms of 128 resident rows of two operands alone take 192
//   KB, so a block keeps 64 rows, both warpgroups own all of them and take
//   alternate 32-row tiles (two 48 KB stages), and warpgroup 1's sums are added
//   to warpgroup 0's through shared memory at the end, a fixed order. P =
//   2^((S·scale − lse)·log2 e), the difference first as the f32 forward takes
//   it, with the rows' lse (not times log2 e) in the padded layout. A
//   warpgroup runs S and dP, then P and dS, then dV and dK (or dQ) in turn:
//   the other warpgroup's products run under its exponentials and splits.
//   Blocks launch a head's blocks in a row, heaviest causal block first, so
//   the blocks in flight stream a few heads' tiles from the L2.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Helpers of the wgmma kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// (x, y) → a pair of 16-bit values, x in the low half, rounded to nearest
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16, float x, float y, float2* back) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  if (back) *back = make_float2(__low2float(v), __high2float(v));
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack2(__half, float x, float y, float2* back) {
  const __half2 v = __floats2half2_rn(x, y);
  if (back) *back = make_float2(__low2float(v), __high2float(v));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// P's pair (x, y) → its rounded part and the rounded residue
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  float2 h;
  hi = pack2(T(), x, y, &h);
  lo = pack2(T(), x - h.x, y - h.y, nullptr);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}


// ---------------------------------------------------------------------------
// Backward: dQ, dK, dV from q, k, v, o, dO and the forward's row lse
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Dvec[b, h, s] = Σ_d dO[b, s, h, d]·O[b, s, h, d] in f32, rows S4 apart, the padding
// s in [S, S4) written 0. With lse_copy, also lse written into that padded layout (times
// log2 e in 16 bits): the kernels load both by TMA, whose boxes start 16-byte aligned, and
// take P = 2^(S·scale·log2 e − lse·log2 e) in 16 bits, 2^((S·scale − lse)·log2 e) in f32.
// 16-bit rows: D/8 lanes a row, 16 bytes each; f32: a warp a row.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ dvec,
                        float* __restrict__ lse_copy, int B, int S, int H, int D, int S4) {
  const int lpr = sizeof(T) == 2 ? D / 8 : 32;
  const long rows = long(B) * S * H;
  const long r = (long(blockIdx.x) * blockDim.x + threadIdx.x) / lpr;
  const int part = threadIdx.x % lpr;
  float acc = 0.f;
  if (r < rows) {
    if constexpr (sizeof(T) == 2) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + size_t(r) * D + part * 8);
      const uint4 g = *reinterpret_cast<const uint4*>(dout + size_t(r) * D + part * 8);
      const T* av = reinterpret_cast<const T*>(&a);
      const T* gv = reinterpret_cast<const T*>(&g);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(to_f32(av[i]), to_f32(gv[i]), acc);
    } else {
      for (int c = part; c < D; c += 32) acc = fmaf(to_f32(o[size_t(r) * D + c]),
                                                    to_f32(dout[size_t(r) * D + c]), acc);
    }
  }
  for (int off = lpr / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && part == 0) {
    const int h = int(r % H), s = int((r / H) % S), b = int(r / (long(H) * S));
    const size_t at = (size_t(b) * H + h) * S4 + s;
    dvec[at] = acc;
    if (lse_copy)
      lse_copy[at] = lse[(size_t(b) * H + h) * S + s] * (sizeof(T) == 2 ? kLog2e : 1.f);
    // the row's padding is read by the TMA boxes: zero, so that a masked P (0) times
    // dP − Dvec stays 0 whatever the scratch held before
    for (int p = S; s == S - 1 && p < S4; ++p) {
      dvec[at + p - s] = 0.f;
      if (lse_copy) lse_copy[at + p - s] = 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Hopper building blocks of the wgmma kernels: mbarriers, TMA, named barriers, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// arrive, and expect `bytes` more from the copies that complete on this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// one box of a tensor map → shared memory; its bytes complete on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap& map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3), "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap& map, int c0,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2}], [%3];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0),
         "r"(smem_addr(bar)) : "memory");
}

template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// named barrier `id` over the two consumer warpgroups (256 threads): wait, or arrive where
// pred is nonzero (a predicate, not a branch)
__device__ __forceinline__ void bar_sync256(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive256(int id, int pred) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p bar.arrive %0, 256;\n}\n"
               :: "r"(id), "r"(pred) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {   // all but the newest group done
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// 2^x, flushing subnormal results to 0 (one MUFU.EX2; P below 2^-126 adds nothing)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// keeps the compiler from moving accesses of an accumulator across the asynchronous products
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// keeps an A operand in its registers until the products that read it are waited for
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r]) :: "memory");
}

// wgmma's shared-memory matrix descriptor: start address, leading and stride byte offsets,
// swizzle mode (1: 128-byte rows, 2: 64-byte, 3: 32-byte)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint32_t mode) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) | uint64_t((lbo >> 4) & 0x3FFF) << 16 |
         uint64_t((sbo >> 4) & 0x3FFF) << 32 | uint64_t(mode) << 62;
}

#define FA_R8 "{%0, %1, %2, %3, %4, %5, %6, %7}"
#define FA_R16 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define FA_R32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FA_R64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define FA_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_D8(i) FA_D4(i), FA_D4(i + 4)
#define FA_D16(i) FA_D8(i), FA_D8(i + 8)
#define FA_D32(i) FA_D16(i), FA_D16(i + 16)
#define FA_D64 FA_D32(0), FA_D32(32)
#define FA_A "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3])
#define FA_WGMMA(T, TY)                                                                      \
  /* d (64×N, f32) = A·B + (acc ? d : 0), A (64×16) and B (16×N) read from shared memory, */ \
  /* K-major */                                                                              \
  __device__ __forceinline__ void wgmma_ss(T, float (&d)[16], uint64_t da, uint64_t db,      \
                                           int acc) {                                        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " FA_R16         \
                 ", %16, %17, p, 1, 1, 0, 0;\n}\n"                                           \
                 : FA_D16(0) : "l"(da), "l"(db), "r"(acc));                                  \
  }                                                                                          \
  __device__ __forceinline__ void wgmma_ss(T, float (&d)[32], uint64_t da, uint64_t db,      \
                                           int acc) {                                        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " FA_R32         \
                 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                           \
                 : FA_D32(0) : "l"(da), "l"(db), "r"(acc));                                  \
  }                                                                                          \
  __device__ __forceinline__ void wgmma_ss(T, float (&d)[64], uint64_t da, uint64_t db,      \
                                           int acc) {                                        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " FA_R64        \
                 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                                           \
                 : FA_D64 : "l"(da), "l"(db), "r"(acc));                                     \
  }                                                                                          \
  /* d (64×N, f32) += A·B, A (64×16) from registers, B (16×N) MN-major (transposed) */      \
  __device__ __forceinline__ void wgmma_rs_t(T, float (&d)[8], const uint32_t (&a)[4],       \
                                             uint64_t db) {                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                                \
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " FA_R8          \
                 ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                               \
                 : FA_D8(0) : FA_A, "l"(db), "r"(1));                                        \
  }                                                                                          \
  __device__ __forceinline__ void wgmma_rs_t(T, float (&d)[16], const uint32_t (&a)[4],      \
                                             uint64_t db) {                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " FA_R16         \
                 ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                             \
                 : FA_D16(0) : FA_A, "l"(db), "r"(1));                                       \
  }                                                                                          \
  __device__ __forceinline__ void wgmma_rs_t(T, float (&d)[32], const uint32_t (&a)[4],      \
                                             uint64_t db) {                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " FA_R32         \
                 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                             \
                 : FA_D32(0) : FA_A, "l"(db), "r"(1));                                       \
  }                                                                                          \
  __device__ __forceinline__ void wgmma_rs_t(T, float (&d)[64], const uint32_t (&a)[4],      \
                                             uint64_t db) {                                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " FA_R64        \
                 ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                             \
                 : FA_D64 : FA_A, "l"(db), "r"(1));                                          \
  }
FA_WGMMA(__nv_bfloat16, "bf16")
FA_WGMMA(__half, "f16")
// d (64×64, f32) = A·B + (acc ? d : 0), A (64×16 bf16) from registers, B (16×64) K-major
__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_R32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
               : FA_D32(0) : FA_A, "l"(db), "r"(acc));
}
#undef FA_WGMMA
#undef FA_A
#undef FA_D64
#undef FA_D32
#undef FA_D16
#undef FA_D8
#undef FA_D4
#undef FA_R64
#undef FA_R32
#undef FA_R16
#undef FA_R8

// A 16-bit tile of rows × D in shared memory, as TMA writes it and wgmma reads it: D cut
// into NH column blocks of SW bytes (the 128-byte swizzle from D 64 up, the row's own width
// below), each block rows × SW bytes, swizzled in 8-row atoms.
template <int D>
struct Tile16 {
  static constexpr int SW = D * 2 < 128 ? D * 2 : 128;
  static constexpr int NH = D * 2 / SW;
  static constexpr int KPB = SW / 32;             // 16-deep k-steps per column block
  static constexpr uint32_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static constexpr int BYTES64 = 64 * D * 2;      // a 64-row tile
};

// K-major operand (rows are M or N, D is the product's depth): 64 rows from row r0 of a
// `rows`-row tile, k-step kk (16 values of D)
template <int D>
__device__ __forceinline__ uint64_t desc_k(const unsigned char* tile, int rows, int r0, int kk) {
  using L = Tile16<D>;
  return gmma_desc(tile + ((kk / L::KPB) * rows + r0) * L::SW + (kk % L::KPB) * 32, 16,
                   8 * L::SW, L::MODE);
}
// MN-major B (rows are the depth, D is N): k-step j (rows 16j..16j+15) of a `rows`-row
// tile; N crosses column blocks `rows`·SW bytes apart
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const unsigned char* tile, int rows, int j) {
  using L = Tile16<D>;
  return gmma_desc(tile + j * 16 * L::SW, rows * L::SW, 8 * L::SW, L::MODE);
}

constexpr int BWD_THREADS = 384;       // a producer warpgroup, two consumer warpgroups
constexpr int BWD_STAGES = 3;          // the ring of streamed tiles
constexpr int BWD_CONSUMERS = 256;       // arrivals that free a stage: every consumer thread

template <int D>
constexpr size_t dkdv_smem_bytes() {   // K, V (128 rows); per stage Q, dO (64 rows), lse, Dvec
  return 1024 + 4 * size_t(Tile16<D>::BYTES64) +
         BWD_STAGES * (2 * size_t(Tile16<D>::BYTES64) + 1024) + 128;
}
template <int D>
constexpr size_t dq_smem_bytes() {     // Q, dO (128 rows); per stage K, V (64 rows)
  return 1024 + 4 * size_t(Tile16<D>::BYTES64) + BWD_STAGES * 2 * size_t(Tile16<D>::BYTES64) +
         128;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

__device__ __forceinline__ bool visible(int pq, int pk, int S, int causal, int window) {
  bool ok = pq < S && pk < S;
  if (causal) ok = ok && pq >= pk;
  if (window > 0) ok = ok && pq - pk < window;
  return ok;
}

// P's (or dS's) 64 × N f32 accumulator → the A operands of N/16 16-deep k-steps, each
// value split into its rounded part and rounded residue (f32 precision)
template <typename T, int N>
__device__ __forceinline__ void split_a(const float (&x)[N], uint32_t (&hi)[N / 8][4],
                                        uint32_t (&lo)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split2<T>(x[8 * j + 2 * r], x[8 * j + 2 * r + 1], hi[j][r], lo[j][r]);
}

// The 16-bit forward: 128 query rows of one head a block, key tiles of 128 streamed through
// a ring of fwd_stages<D>() stages. Its shared memory: Q [NH][128][SW], then per stage K and
// V [NH][128][SW] each, then the barriers, from a 1024-byte aligned start.
constexpr int FWD_THREADS = 384;       // a producer warpgroup, two consumer warpgroups
constexpr int FWD_BQ = 128;            // query rows per block, 64 per consumer warpgroup
constexpr int FWD_BK = 128;            // keys per tile

template <int D>
__host__ __device__ constexpr int fwd_stages() { return D == 128 ? 3 : 4; }

template <int D>
constexpr size_t fwd_smem_bytes() {
  return 1024 + size_t(FWD_BQ) * D * 2 + fwd_stages<D>() * 2 * size_t(FWD_BK) * D * 2 + 128;
}

template <typename T, int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KV, int causal, int window,
                 float scale, int BH, int chunk) {
  using L = Tile16<D>;
  constexpr int STAGES = fwd_stages<D>();
  constexpr int TILE = FWD_BK * D * 2;            // one K or V tile's bytes
  constexpr int NS = FWD_BK / 2;                  // scores a thread holds per tile
  extern __shared__ __align__(1024) unsigned char fwd_smem[];
  unsigned char* const qs = align1024(fwd_smem);  // [NH][128][SW]
  unsigned char* const stages = qs + FWD_BQ * D * 2;   // per stage: K, V [NH][128][SW]
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(stages + STAGES * 2 * TILE);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + STAGES;

  // blocks launch in order of blockIdx.x: the heads in chunks of `chunk` (the wrapper's
  // ForwardLaunch.chunk: whole KV groups whose K and V stay in the L2, so they are read
  // from HBM about once), each chunk's query tiles heaviest causal tile first, across its
  // heads; ForwardLaunch.blocks lists the same order
  const int tiles = (S + FWD_BQ - 1) / FWD_BQ;
  const int c0 = blockIdx.x / (chunk * tiles) * chunk;   // the chunk's first head
  const int nh = min(chunk, BH - c0), r = blockIdx.x - c0 * tiles;
  const int bh = c0 + r % nh, q0 = (tiles - 1 - r / nh) * FWD_BQ;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  // live key tiles [t_lo, t_hi]: those some row of the block sees (the reference's causal
  // `break` and window `continue`), one contiguous range
  int t_hi = (S - 1) / FWD_BK;
  if (causal) t_hi = min(t_hi, (q0 + FWD_BQ - 1) / FWD_BK);
  int t_lo = 0;
  if (window > 0) {
    const int x = q0 - window - FWD_BK + 1;       // live iff k0 > x
    if (x >= 0) t_lo = x / FWD_BK + 1;
  }
  const int n_steps = t_hi - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(q_full, FWD_BQ * D * 2);
      for (int hb = 0; hb < L::NH; ++hb)
        tma_load_4d(qs + hb * FWD_BQ * L::SW, tq, hb * L::SW / 2, h, q0, b, q_full);
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % STAGES;
        mbar_wait(empty + st, ((step / STAGES) & 1) ^ 1);
        const int k0 = (t_lo + step) * FWD_BK;
        unsigned char* const sp = stages + st * 2 * TILE;
        mbar_arrive_tx(full + st, 2 * TILE);
        for (int hb = 0; hb < L::NH; ++hb) {
          tma_load_4d(sp + hb * FWD_BK * L::SW, tk, hb * L::SW / 2, kvh, k0, b, full + st);
          tma_load_4d(sp + TILE + hb * FWD_BK * L::SW, tv, hb * L::SW / 2, kvh, k0, b, full + st);
        }
      }
    }
  } else {
    regs_inc<240>();
    const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale2 = scale * kLog2e;          // e^(scale·x) = 2^(scale2·x)
    const int row0 = q0 + 64 * c + warp * 16 + g;   // this thread's rows: row0, row0 + 8
    float oa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oa[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m: the row's largest raw q·k
    float corr[2];                                 // O's factor before the next P·V
    uint32_t ph[NS / 8][4], pl[NS / 8][4];         // the last tile's P, split
    float sc[NS];

    // S(step) = Q·Kᵀ into sc; its group is committed
    auto issue_s = [&](int step) {
      const unsigned char* const kt = stages + (step % STAGES) * 2 * TILE;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(T(), sc, desc_k<D>(qs, FWD_BQ, 64 * c, kk), desc_k<D>(kt, FWD_BK, 0, kk), kk);
      wgmma_commit();
    };
    // O = O·corr + P_hi·V + P_lo·V of tile `step`: P as A from registers, V as MN-major B
    // from its tile; its group is committed
    auto issue_pv = [&](int step) {
      const unsigned char* const vt = stages + (step % STAGES) * 2 * TILE + TILE;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oa[i] *= corr[(i >> 1) & 1];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        wgmma_rs_t(T(), oa, ph[j], desc_mn<D>(vt, FWD_BK, j));
        wgmma_rs_t(T(), oa, pl[j], desc_mn<D>(vt, FWD_BK, j));
      }
      wgmma_commit();
    };
    // the mask, then the online softmax of S(step) in base 2: p = 2^(scale2·s −
    // scale2·m_new) in sc, l rescaled and summed, corr for O. Element i is row row0 +
    // 8·((i >> 1) & 1), key k0 + 8·(i >> 2) + 2·t4 + (i & 1). A row that has seen only
    // masked keys keeps m = -1e30 and takes p = 0 on them (its sums stay 0); the
    // reference's p = 1 there is wiped by its first real key (corr = 0), so both agree.
    auto softmax = [&](int step) {
      const int k0 = (t_lo + step) * FWD_BK;
      // only on tiles that cross S, the diagonal or the window's edge for some row of the
      // block: a branch on the block's values (one that differed between the warpgroups
      // would make ptxas serialise the wgmmas)
      if (k0 + FWD_BK > S || (causal && k0 + FWD_BK - 1 > q0) ||
          (window > 0 && q0 + FWD_BQ - 1 - k0 >= window)) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          sc[i] = visible(row0 + ((i >> 1) & 1) * 8, k0 + (i >> 2) * 8 + 2 * t4 + (i & 1), S,
                          causal, window) ? sc[i] : kNegInf;
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = m[rr];
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * rr], sc[4 * j + 2 * rr + 1]));
        mx = quad_max(mx);
        corr[rr] = exp2_ftz((m[rr] - mx) * scale2);
        const float neg = mx == kNegInf ? 0.f : -mx * scale2;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * rr + e;
            sc[i] = exp2_ftz(fmaf(sc[i], scale2, neg));
            sum += sc[i];
          }
        l[rr] = l[rr] * corr[rr] + quad_sum(sum);
        m[rr] = mx;
      }
    };

    // Step j issues S(j) and P(j−1)·V(j−1) together, between the ping-pong barriers
    // (warpgroup c waits on named barrier 1 + c, then frees the other's: one's softmax
    // runs under the other's products, warpgroup 0 first), then runs softmax(j) under its
    // own P(j−1)·V(j−1). The barriers stay balanced: warpgroup 1 skips its last arrive.
    bar_arrive256(1, c == 1);
    mbar_wait(q_full, 0);
    mbar_wait(full, 0);
    bar_sync256(1 + c);
    wgmma_fence();
    issue_s(0);
    bar_arrive256(2 - c, c == 0 || n_steps > 1);
    wgmma_wait();
    reg_fence(sc);
    softmax(0);
    split_a<T>(sc, ph, pl);
    for (int step = 1; step < n_steps; ++step) {
      mbar_wait(full + step % STAGES, (step / STAGES) & 1);
      bar_sync256(1 + c);
      wgmma_fence();
      issue_s(step);
      issue_pv(step - 1);
      bar_arrive256(2 - c, c == 0 || step + 1 < n_steps);
      wgmma_wait1();
      reg_fence(sc);
      softmax(step);
      wgmma_wait();
      reg_fence(oa);
      reg_fence(ph);
      reg_fence(pl);
      mbar_arrive(empty + (step - 1) % STAGES);
      split_a<T>(sc, ph, pl);
    }
    issue_pv(n_steps - 1);
    wgmma_wait();
    reg_fence(oa);
    mbar_arrive(empty + (n_steps - 1) % STAGES);

    const size_t q_stride = size_t(H) * D;
    T* const ob = o + (size_t(b) * S * H + h) * D;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = row0 + rr * 8;
      if (s >= S) continue;
      const float li = fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(ob + size_t(s) * q_stride + i * 8 + 2 * t4) =
            pack2(T(), oa[4 * i + 2 * rr] / li, oa[4 * i + 2 * rr + 1] / li, nullptr);
      if (lse && t4 == 0) lse[(size_t(b) * H + h) * S + s] = m[rr] * scale + logf(li);
    }
  }
}

// The f32 forward: q, k and v in three bf16 terms each, S = Q·Kᵀ and O += P·V as sums of six
// bf16 products on wgmma (flash_fwd_f32_kernel). 128 query rows of one head a block, key
// tiles of 64 streamed through a ring of f32_stages<D>() stages, each holding K's three terms
// and then V's, each [NH][64][SW] as Tile16 lays a 16-bit tile out (TMA fills zeros past S);
// then the barriers, from a 1024-byte aligned start. Q stays in registers.
constexpr int F32_BQ = 128;            // query rows per block, 64 per consumer warpgroup
constexpr int F32_BK = 64;             // keys per tile

template <int D>
__host__ __device__ constexpr int f32_stages() { return D == 128 ? 2 : 4; }

template <int D>
constexpr size_t f32_smem_bytes() {
  return 1024 + f32_stages<D>() * 6 * size_t(F32_BK) * D * 2 + 128;
}

// (x, y) → their bf16 terms x_hi = RN(x), x_mid = RN(x − x_hi), x_lo = RN(x − x_hi − x_mid),
// each a packed pair with x in the low half: both differences are exact, and what the terms
// leave out is below 2^-24 |x| (fused_topk_score.cu split_q_kernel's rule)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  float2 h, m;
  hi = pack2(__nv_bfloat16(), x, y, &h);
  const float rx = __fsub_rn(x, h.x), ry = __fsub_rn(y, h.y);
  mid = pack2(__nv_bfloat16(), rx, ry, &m);
  lo = pack2(__nv_bfloat16(), __fsub_rn(rx, m.x), __fsub_rn(ry, m.y), nullptr);
}

// The six products kept of the nine, (A's term, B's term) with 0 = hi, 1 = mid, 2 = lo: every
// pair down to the 2^-16 terms, smallest first. What is dropped (mid·lo, lo·mid, lo·lo) is
// below 2^-23 of |a|·|b|, an f32 rounding.
__host__ __device__ constexpr int prod_a(int p) { return p == 0 ? 2 : p == 1 ? 0 : p <= 3 ? 1 : 0; }
__host__ __device__ constexpr int prod_b(int p) {
  return p == 1 ? 2 : p == 2 || p == 4 ? 1 : 0;
}

// Up to four f32 tensors (rows of D, n4 float4 each), each times its scale (rounded once),
// → rows of 3·D bf16: the row's x_hi, x_mid and x_lo; blockIdx.y picks the tensor
struct Split3Jobs {
  const float* src[4];
  __nv_bfloat16* dst[4];
  long n4[4];
  float scale[4];
};

// element y of a parameter array by selects (an index unknown at compile time would copy
// the array to local memory)
template <typename X>
__device__ __forceinline__ X pick4(const X (&a)[4], unsigned y) {
  return y == 0 ? a[0] : y == 1 ? a[1] : y == 2 ? a[2] : a[3];
}

__global__ void __launch_bounds__(256)
flash_split3_kernel(const Split3Jobs jobs, int D) {
  const float4* const x = reinterpret_cast<const float4*>(pick4(jobs.src, blockIdx.y));
  __nv_bfloat16* const ob = pick4(jobs.dst, blockIdx.y);
  const long n4 = pick4(jobs.n4, blockIdx.y);
  const float sc = pick4(jobs.scale, blockIdx.y);
  for (long i = long(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += long(gridDim.x) * blockDim.x) {
    const float4 a = x[i];
    const long row = 4 * i / D;
    const int col = int(4 * i - row * D);
    uint32_t hi[2], mid[2], lo[2];
    split3(__fmul_rn(a.x, sc), __fmul_rn(a.y, sc), hi[0], mid[0], lo[0]);
    split3(__fmul_rn(a.z, sc), __fmul_rn(a.w, sc), hi[1], mid[1], lo[1]);
    __nv_bfloat16* const p = ob + row * 3 * D + col;
    *reinterpret_cast<uint2*>(p) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(p + D) = make_uint2(mid[0], mid[1]);
    *reinterpret_cast<uint2*>(p + 2 * D) = make_uint2(lo[0], lo[1]);
  }
}

// the split pass's grid: a thread a float4, at most 8,192 blocks (the loop strides the rest)
unsigned split_blocks(long n4) {
  const long blocks = (n4 + 255) / 256;
  return unsigned(blocks < 8192 ? blocks : 8192);
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, float* __restrict__ o,
                     float* __restrict__ lse, int S, int H, int KV, int causal, int window,
                     float scale, int BH, int chunk) {
  using L = Tile16<D>;
  constexpr int STAGES = f32_stages<D>();
  constexpr int PLANE = F32_BK * D * 2;           // one term of a K or V tile
  constexpr int STAGE = 6 * PLANE;                // K's three terms, then V's
  constexpr int KS = D / 16;                      // 16-deep k-steps of Q·Kᵀ
  constexpr int NS = F32_BK / 2;                  // scores a thread holds per tile
  extern __shared__ __align__(1024) unsigned char f32_smem[];
  unsigned char* const stages = align1024(f32_smem);
  uint64_t* const full = reinterpret_cast<uint64_t*>(stages + STAGES * STAGE);
  uint64_t* const empty = full + STAGES;

  // the 16-bit body's launch order: heads in chunks, each chunk heaviest causal tile first
  const int tiles = (S + F32_BQ - 1) / F32_BQ;
  const int c0 = blockIdx.x / (chunk * tiles) * chunk;
  const int nh = min(chunk, BH - c0), r = blockIdx.x - c0 * tiles;
  const int bh = c0 + r % nh, q0 = (tiles - 1 - r / nh) * F32_BQ;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  int t_hi = (S - 1) / F32_BK;
  if (causal) t_hi = min(t_hi, (q0 + F32_BQ - 1) / F32_BK);
  int t_lo = 0;
  if (window > 0) {
    const int x = q0 - window - F32_BK + 1;       // live iff k0 > x
    if (x >= 0) t_lo = x / F32_BK + 1;
  }
  const int n_steps = t_hi - t_lo + 1;

  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<24>();
    if (threadIdx.x == 0) {
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % STAGES;
        mbar_wait(empty + st, ((step / STAGES) & 1) ^ 1);
        const int k0 = (t_lo + step) * F32_BK;
        unsigned char* const sp = stages + st * STAGE;
        mbar_arrive_tx(full + st, STAGE);
        for (int t = 0; t < 3; ++t)
          for (int hb = 0; hb < L::NH; ++hb) {
            const int col = t * D + hb * L::SW / 2, at = hb * F32_BK * L::SW;
            tma_load_4d(sp + t * PLANE + at, tk, col, kvh, k0, b, full + st);
            tma_load_4d(sp + (3 + t) * PLANE + at, tv, col, kvh, k0, b, full + st);
          }
      }
    }
  } else {
    regs_inc<240>();
    const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = q0 + 64 * c + warp * 16 + g;   // this thread's rows: row0, row0 + 8
    const size_t q_stride = size_t(H) * D;
    // Q·scale (the reference scales q) in three terms, as wgmma's A fragments: k-step kk,
    // register r holds row row0 + 8·(r & 1), columns 16·kk + 8·(r >> 1) + 2·t4 and + 1
    uint32_t qa[3][KS][4];
    {
      const float* const qb = q + (size_t(b) * S * H + h) * D;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int rg = 0; rg < 4; ++rg) {
          const int s = row0 + 8 * (rg & 1), col = 16 * kk + 8 * (rg >> 1) + 2 * t4;
          const float2 x = s < S ? *reinterpret_cast<const float2*>(qb + size_t(s) * q_stride + col)
                                 : make_float2(0.f, 0.f);
          split3(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale), qa[0][kk][rg], qa[1][kk][rg],
                 qa[2][kk][rg]);
        }
    }
    float oa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oa[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};   // m: the row's largest scaled score

    // No branch sits between a wgmma and its wait; the mask's is on the block's values.
    // The other consumer warpgroup's products run under this one's softmax.
    for (int step = 0; step < n_steps; ++step) {
      const int st = step % STAGES, k0 = (t_lo + step) * F32_BK;
      const unsigned char* const kt = stages + st * STAGE;
      const unsigned char* const vt = kt + 3 * PLANE;
      float sc[NS];
      mbar_wait(full + st, (step / STAGES) & 1);
      wgmma_fence();
      // each product over all of D before the next, smallest first: the small terms are
      // summed while the accumulator is still small
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          wgmma_rs_k(sc, qa[prod_a(p)][kk], desc_k<D>(kt + prod_b(p) * PLANE, F32_BK, 0, kk),
                     kk + p);
      wgmma_commit();
      wgmma_wait();
      reg_fence(sc);
      reg_fence(qa[0]);
      reg_fence(qa[1]);
      reg_fence(qa[2]);

      // the mask, then the online softmax: p = 2^((s − m_new)·log2 e), corr = 2^((m −
      // m_new)·log2 e). Element i is row row0 + 8·((i >> 1) & 1), key k0 + 8·(i >> 2) + 2·t4
      // + (i & 1). A row that has seen only masked keys keeps m = -1e30 and takes p = 0 on
      // them (its sums stay 0); the reference's p = 1 there is wiped by its first real key.
      if (k0 + F32_BK > S || (causal && k0 + F32_BK - 1 > q0) ||
          (window > 0 && q0 + F32_BQ - 1 - k0 >= window)) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          sc[i] = visible(row0 + ((i >> 1) & 1) * 8, k0 + (i >> 2) * 8 + 2 * t4 + (i & 1), S,
                          causal, window) ? sc[i] : kNegInf;
      }
      float corr[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float mx = m[rr];
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * rr], sc[4 * j + 2 * rr + 1]));
        mx = quad_max(mx);
        corr[rr] = exp2_ftz((m[rr] - mx) * kLog2e);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * rr + e;
            sc[i] = mx == kNegInf ? 0.f : exp2_ftz((sc[i] - mx) * kLog2e);
            sum += sc[i];
          }
        l[rr] = l[rr] * corr[rr] + quad_sum(sum);
        m[rr] = mx;
      }

      // O = O·corr + Σ P_a·V_b over the six products: P's three terms as A from registers
      // (the accumulator's layout is the A fragment's), V's terms MN-major from the tile
      uint32_t pa[3][F32_BK / 16][4];
#pragma unroll
      for (int j = 0; j < F32_BK / 16; ++j)
#pragma unroll
        for (int rg = 0; rg < 4; ++rg)
          split3(sc[8 * j + 2 * rg], sc[8 * j + 2 * rg + 1], pa[0][j][rg], pa[1][j][rg],
                 pa[2][j][rg]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) oa[i] *= corr[(i >> 1) & 1];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < F32_BK / 16; ++j)
#pragma unroll
        for (int p = 0; p < 6; ++p)
          wgmma_rs_t(__nv_bfloat16(), oa, pa[prod_a(p)][j],
                     desc_mn<D>(vt + prod_b(p) * PLANE, F32_BK, j));
      wgmma_commit();
      wgmma_wait();
      reg_fence(oa);
      reg_fence(pa[0]);
      reg_fence(pa[1]);
      reg_fence(pa[2]);
      mbar_arrive(empty + st);
    }

    float* const ob = o + (size_t(b) * S * H + h) * D;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = row0 + rr * 8;
      if (s >= S) continue;
      const float li = fmaxf(l[rr], 1e-30f);
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<float2*>(ob + size_t(s) * q_stride + i * 8 + 2 * t4) =
            make_float2(oa[4 * i + 2 * rr] / li, oa[4 * i + 2 * rr + 1] / li);
      if (lse && t4 == 0) lse[(size_t(b) * H + h) * S + s] = m[rr] + logf(li);
    }
  }
}

// dK, dV of 128 keys of one KV head: warpgroup 0 loads (one thread: K and V once by TMA,
// then Q, dO, lse and Dvec of each (query head, query tile) step into a ring of stages);
// warpgroups 1 and 2 own 64 keys each and keep their sums in registers (no atomics).
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tlse,
                      const __grid_constant__ CUtensorMap tdvec, T* __restrict__ dk,
                      T* __restrict__ dv, int S, int S4, int H, int KV, int causal,
                      int window, float scale) {
  using L = Tile16<D>;
  constexpr int T64 = L::BYTES64, STAGE = 2 * T64 + 1024;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* const ks = align1024(bwd_smem);  // [NH][128][SW]
  unsigned char* const vs = ks + 2 * T64;         // [NH][128][SW]
  unsigned char* const stages = vs + 2 * T64;     // per stage: Q, dO [NH][64][SW]; lse, Dvec [64]
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(stages + BWD_STAGES * STAGE);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + BWD_STAGES;

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * 128;
  // live query tiles [i_lo, i_lo + n_i): some query of the tile sees some key of the block
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S - 1, k0 + 126 + window) : S - 1;
  const int i_lo = q_lo / 64, n_i = q_hi / 64 - i_lo + 1, n_steps = G * n_i;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, BWD_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(kv_full, 4 * T64);
      for (int hb = 0; hb < L::NH; ++hb)
        for (int r = 0; r < 2; ++r) {
          const int at = (hb * 128 + r * 64) * L::SW;
          tma_load_4d(ks + at, tk, hb * L::SW / 2, kvh, k0 + r * 64, b, kv_full);
          tma_load_4d(vs + at, tv, hb * L::SW / 2, kvh, k0 + r * 64, b, kv_full);
        }
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % BWD_STAGES;
        mbar_wait(empty + st, ((step / BWD_STAGES) & 1) ^ 1);
        const int h = kvh * G + step / n_i, s0 = (i_lo + step % n_i) * 64;
        unsigned char* const sp = stages + st * STAGE;
        mbar_arrive_tx(full + st, 2 * T64 + 512);
        for (int hb = 0; hb < L::NH; ++hb) {
          tma_load_4d(sp + hb * 64 * L::SW, tq, hb * L::SW / 2, h, s0, b, full + st);
          tma_load_4d(sp + T64 + hb * 64 * L::SW, tdo, hb * L::SW / 2, h, s0, b, full + st);
        }
        const int at = (b * H + h) * S4 + s0;
        tma_load_1d(sp + 2 * T64, tlse, at, full + st);
        tma_load_1d(sp + 2 * T64 + 256, tdvec, at, full + st);
      }
    }
  } else {
    regs_inc<240>();
    const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale2 = scale * kLog2e;           // e^(x·scale − lse) = 2^(x·scale2 − lse·log2 e)
    const int kw0 = k0 + 64 * c;                   // this warpgroup's keys
    const int key0 = kw0 + warp * 16 + g;          // this thread's keys: key0, key0 + 8
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int step = 0; step < n_steps; ++step) {
      const int st = step % BWD_STAGES;
      const int q0 = (i_lo + step % n_i) * 64;
      const unsigned char* const qs = stages + st * STAGE;
      const unsigned char* const gs = qs + T64;
      const float* const lt = reinterpret_cast<const float*>(qs + 2 * T64);
      const float* const dt = lt + 64;
      mbar_wait(full + st, (step / BWD_STAGES) & 1);
      const bool dead = kw0 >= S || (causal && kw0 > q0 + 63) ||
                        (window > 0 && q0 - (kw0 + 63) >= window);
      if (!dead) {
        // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, 64 keys × 64 queries, both operands from the tiles
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        reg_fence(sc);
        reg_fence(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss(T(), sc, desc_k<D>(ks, 128, 64 * c, kk), desc_k<D>(qs, 64, 0, kk), 1);
          wgmma_ss(T(), dp, desc_k<D>(vs, 128, 64 * c, kk), desc_k<D>(gs, 64, 0, kk), 1);
        }
        wgmma_commit();
        wgmma_wait();
        reg_fence(sc);
        reg_fence(dp);

        // Pᵀ = exp(scale·Sᵀ − lse) (0 where masked), dSᵀ = Pᵀ ∘ (dPᵀ − Dvec); element i
        // is key key0 + 8·((i >> 1) & 1), query q0 + 8·(i >> 2) + 2·t4 + (i & 1), whose
        // lse·log2 e and Dvec are lv[u], dv_[u], u = 2·(i >> 2) + (i & 1)
        float lv[16], dv_[16];
#pragma unroll
        for (int c8 = 0; c8 < 8; ++c8) {
          const float2 l2 = *reinterpret_cast<const float2*>(lt + c8 * 8 + 2 * t4);
          const float2 d2 = *reinterpret_cast<const float2*>(dt + c8 * 8 + 2 * t4);
          lv[2 * c8] = l2.x;
          lv[2 * c8 + 1] = l2.y;
          dv_[2 * c8] = d2.x;
          dv_[2 * c8 + 1] = d2.y;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i)
          sc[i] = exp2_ftz(fmaf(sc[i], scale2, -lv[2 * (i >> 2) + (i & 1)]));
        if (q0 + 63 >= S || kw0 + 63 >= S || (causal && kw0 + 63 > q0) ||
            (window > 0 && q0 + 63 - kw0 >= window)) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = visible(q0 + (i >> 2) * 8 + 2 * t4 + (i & 1), key0 + ((i >> 1) & 1) * 8, S,
                            causal, window) ? sc[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dv_[2 * (i >> 2) + (i & 1)]);

        // dV += Pᵀ·dO, dK += dSᵀ·Q: Pᵀ and dSᵀ as A from registers (split), dO and Q as
        // MN-major B from the same tiles
        uint32_t ph[4][4], pl[4][4], sh[4][4], sl[4][4];
        split_a<T>(sc, ph, pl);
        split_a<T>(dp, sh, sl);
        reg_fence(dka);
        reg_fence(dva);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wgmma_rs_t(T(), dva, ph[j], desc_mn<D>(gs, 64, j));
          wgmma_rs_t(T(), dva, pl[j], desc_mn<D>(gs, 64, j));
          wgmma_rs_t(T(), dka, sh[j], desc_mn<D>(qs, 64, j));
          wgmma_rs_t(T(), dka, sl[j], desc_mn<D>(qs, 64, j));
        }
        wgmma_commit();
        wgmma_wait();
        reg_fence(dka);
        reg_fence(dva);
      }
      mbar_arrive(empty + st);
    }

    const size_t kv_stride = size_t(KV) * D;
    T* const dkb = dk + (size_t(b) * S * KV + kvh) * D;
    T* const dvb = dv + (size_t(b) * S * KV + kvh) * D;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = key0 + rr * 8;
      if (s >= S) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const size_t at = size_t(s) * kv_stride + i * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(dkb + at) =
            pack2(T(), dka[4 * i + 2 * rr] * scale, dka[4 * i + 2 * rr + 1] * scale, nullptr);
        *reinterpret_cast<uint32_t*>(dvb + at) =
            pack2(T(), dva[4 * i + 2 * rr], dva[4 * i + 2 * rr + 1], nullptr);
      }
    }
  }
}

// dQ of 128 query rows of one head: warpgroup 0 loads (Q and dO once, then the live K and V
// tiles of 64 keys through the ring); warpgroups 1 and 2 own 64 rows each.
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse, const float* __restrict__ dvec,
                    T* __restrict__ dq, int S, int S4, int H, int KV, int causal, int window,
                    float scale) {
  using L = Tile16<D>;
  constexpr int T64 = L::BYTES64, STAGE = 2 * T64;
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  unsigned char* const qs = align1024(bwd_smem);  // [NH][128][SW]
  unsigned char* const gs = qs + 2 * T64;         // [NH][128][SW]  dO
  unsigned char* const stages = gs + 2 * T64;     // per stage: K, V [NH][64][SW]
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(stages + BWD_STAGES * STAGE);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + BWD_STAGES;

  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;   // heaviest causal tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  int t_hi = (S - 1) / 64;             // live key tiles, the forward's predicate
  if (causal) t_hi = min(t_hi, (q0 + 127) / 64);
  int t_lo = 0;
  if (window > 0) {
    const int x = q0 - window - 63;
    if (x >= 0) t_lo = x / 64 + 1;
  }
  const int n_steps = t_hi - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < BWD_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, BWD_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(q_full, 4 * T64);
      for (int hb = 0; hb < L::NH; ++hb)
        for (int r = 0; r < 2; ++r) {
          const int at = (hb * 128 + r * 64) * L::SW;
          tma_load_4d(qs + at, tq, hb * L::SW / 2, h, q0 + r * 64, b, q_full);
          tma_load_4d(gs + at, tdo, hb * L::SW / 2, h, q0 + r * 64, b, q_full);
        }
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % BWD_STAGES;
        mbar_wait(empty + st, ((step / BWD_STAGES) & 1) ^ 1);
        const int kt0 = (t_lo + step) * 64;
        unsigned char* const sp = stages + st * STAGE;
        mbar_arrive_tx(full + st, 2 * T64);
        for (int hb = 0; hb < L::NH; ++hb) {
          tma_load_4d(sp + hb * 64 * L::SW, tk, hb * L::SW / 2, kvh, kt0, b, full + st);
          tma_load_4d(sp + T64 + hb * 64 * L::SW, tv, hb * L::SW / 2, kvh, kt0, b, full + st);
        }
      }
    }
  } else {
    regs_inc<240>();
    const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float scale2 = scale * kLog2e;
    const int qw0 = q0 + 64 * c;                   // this warpgroup's rows
    const int row0 = qw0 + warp * 16 + g;          // this thread's rows: row0, row0 + 8
    float lr[2], dr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = row0 + rr * 8;
      lr[rr] = s < S ? lse[(size_t(b) * H + h) * S + s] * kLog2e : 0.f;
      dr[rr] = s < S ? dvec[(size_t(b) * H + h) * S4 + s] : 0.f;
    }
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int step = 0; step < n_steps; ++step) {
      const int st = step % BWD_STAGES;
      const int kt0 = (t_lo + step) * 64;
      const unsigned char* const kt = stages + st * STAGE;
      const unsigned char* const vt = kt + T64;
      mbar_wait(full + st, (step / BWD_STAGES) & 1);
      const bool dead = qw0 >= S || (causal && kt0 > qw0 + 63) ||
                        (window > 0 && qw0 - (kt0 + 63) >= window);
      if (!dead) {
        // S = Q·Kᵀ and dP = dO·Vᵀ, 64 rows × 64 keys
        float sc[32], dp[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
        reg_fence(sc);
        reg_fence(dp);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_ss(T(), sc, desc_k<D>(qs, 128, 64 * c, kk), desc_k<D>(kt, 64, 0, kk), 1);
          wgmma_ss(T(), dp, desc_k<D>(gs, 128, 64 * c, kk), desc_k<D>(vt, 64, 0, kk), 1);
        }
        wgmma_commit();
        wgmma_wait();
        reg_fence(sc);
        reg_fence(dp);

        // dS = P ∘ (dP − Dvec), P = exp(scale·S − lse); element i is row row0 + 8·((i >> 1)
        // & 1), key kt0 + 8·(i >> 2) + 2·t4 + (i & 1)
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = exp2_ftz(fmaf(sc[i], scale2, -lr[(i >> 1) & 1]));
        if (qw0 + 63 >= S || kt0 + 63 >= S || (causal && kt0 + 63 > qw0) ||
            (window > 0 && qw0 + 63 - kt0 >= window)) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = visible(row0 + ((i >> 1) & 1) * 8, kt0 + (i >> 2) * 8 + 2 * t4 + (i & 1), S,
                            causal, window) ? sc[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - dr[(i >> 1) & 1]);

        // dQ += dS·K: dS as A from registers (split), K as MN-major B from its tile
        uint32_t sh[4][4], sl[4][4];
        split_a<T>(dp, sh, sl);
        reg_fence(dqa);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wgmma_rs_t(T(), dqa, sh[j], desc_mn<D>(kt, 64, j));
          wgmma_rs_t(T(), dqa, sl[j], desc_mn<D>(kt, 64, j));
        }
        wgmma_commit();
        wgmma_wait();
        reg_fence(dqa);
      }
      mbar_arrive(empty + st);
    }

    const size_t q_stride = size_t(H) * D;
    T* const dqb = dq + (size_t(b) * S * H + h) * D;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = row0 + rr * 8;
      if (s >= S) continue;
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<uint32_t*>(dqb + size_t(s) * q_stride + i * 8 + 2 * t4) =
            pack2(T(), dqa[4 * i + 2 * rr] * scale, dqa[4 * i + 2 * rr + 1] * scale, nullptr);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime (no link against the driver library)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

CUtensorMapDataType map_type(__nv_bfloat16) { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
CUtensorMapDataType map_type(__half) { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }

// (B, S, heads, width) 16-bit → boxes of `rows` rows × SW bytes of one head, swizzled as
// Tile16 (width D, or 3·D for the f32 body's three terms a row); rows past S read as zeros
template <typename T, int D>
bool rows_map(CUtensorMap* m, const void* p, int B, int S, int heads, int rows, int width = D) {
  using L = Tile16<D>;
  const cuuint64_t dims[4] = {cuuint64_t(width), cuuint64_t(heads), cuuint64_t(S),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(width) * 2, cuuint64_t(heads) * width * 2,
                                 cuuint64_t(S) * heads * width * 2};
  const cuuint32_t box[4] = {cuuint32_t(L::SW / 2), 1, cuuint32_t(rows), 1},
                   unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = L::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : L::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode_tiled()(m, map_type(T()), 4, const_cast<void*>(p), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// n f32 values → boxes of `box` (zeros past n)
bool vec_map(CUtensorMap* m, const void* p, size_t n, int box_n = 64) {
  const cuuint64_t dims[1] = {cuuint64_t(n)}, strides[1] = {4};
  const cuuint32_t box[1] = {cuuint32_t(box_n)}, unit[1] = {1};
  return encode_tiled()(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(p), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The f32 backward on wgmma: q·scale, k, v and dO in three bf16 terms each (written as rows
// of 3·D bf16 by flash_split3_kernel into the launch's scratch, loaded by TMA as 16-bit
// tiles), P and dS split into theirs in registers; each of S, dP, dV, dK and dQ sums the
// forward's six products (prod_a / prod_b). A block keeps `rows` rows of its own operands
// resident (dK/dV: K and V; dQ: Q·scale and dO) and streams tiles of `tile` rows of the
// other two through a ring of `stages`. From D 64 down the two consumer warpgroups own 64
// resident rows each and both read every tile (split); at D 128 the three terms of 128
// resident rows of two operands alone take 192 KB, so a block keeps 64 rows, both
// warpgroups own all of them, take alternate tiles of 32 rows and add their two sums in
// shared memory at the end, warpgroup 0's first (a fixed order).
constexpr int B32_THREADS = 384;       // a producer warpgroup, two consumer warpgroups

template <int D>
__host__ __device__ constexpr bool b32_split() { return D <= 64; }
template <int D>
__host__ __device__ constexpr int b32_rows() { return b32_split<D>() ? 128 : 64; }
template <int D>
__host__ __device__ constexpr int b32_tile() { return D == 128 ? 32 : 64; }
template <int D>
__host__ __device__ constexpr int b32_stages() { return D >= 64 ? 2 : 4; }

// the resident operands' six planes, then per stage the streamed operands' six planes (and
// for dK/dV 1024 bytes: the tile's lse and Dvec, the next stage's alignment), the barriers
template <int D>
constexpr size_t b32_smem_bytes(bool dkdv) {
  return 1024 + 6 * size_t(b32_rows<D>()) * D * 2 +
         b32_stages<D>() * (6 * size_t(b32_tile<D>()) * D * 2 + (dkdv ? 1024 : 0)) + 128;
}

// the alternate mode's end: warpgroup 1's sums `x` of the shared rows through shared memory
// (every tile consumed by then) into warpgroup 0's, added after its own; c is the warpgroup
template <int N>
__device__ __forceinline__ void b32_add_sums(float (&x)[N], float* red, int c, int at0) {
  const int tid = threadIdx.x & 127;
  if (c == 1) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[(at0 + i) * 128 + tid] = x[i];
  }
  bar_sync256(1);
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] += red[(at0 + i) * 128 + tid];
  }
}

// dK, dV of `rows` keys of one KV head: warpgroup 0 loads (one thread: K's and V's terms
// once, then Q·scale's and dO's terms, lse and Dvec of each (query head, query tile) step
// into the ring); warpgroups 1 and 2 keep their sums in registers (no atomics).
template <int D>
__global__ void __launch_bounds__(B32_THREADS, 1)
flash_bwd_dkdv_f32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tlse,
                          const __grid_constant__ CUtensorMap tdvec, float* __restrict__ dk,
                          float* __restrict__ dv, int S, int S4, int H, int KV, int causal,
                          int window) {
  using L = Tile16<D>;
  constexpr bool SPLIT = b32_split<D>();
  constexpr int R = b32_rows<D>(), TQ = b32_tile<D>(), STAGES = b32_stages<D>();
  constexpr int RP = R * D * 2;                   // one term of the resident K or V
  constexpr int TP = TQ * D * 2;                  // one term of a streamed Q or dO tile
  constexpr int STAGE = 6 * TP + 1024;            // Q's terms, dO's terms, lse, Dvec
  constexpr int KS = D / 16, NT = TQ / 2;         // k-steps over D; scores a thread holds
  extern __shared__ __align__(1024) unsigned char b32_smem[];
  unsigned char* const ks = align1024(b32_smem);  // K's terms [3][NH][R][SW]
  unsigned char* const vs = ks + 3 * RP;          // V's terms
  unsigned char* const stages = vs + 3 * RP;
  uint64_t* const kv_full = reinterpret_cast<uint64_t*>(stages + STAGES * STAGE);
  uint64_t* const full = kv_full + 1;
  uint64_t* const empty = full + STAGES;

  // a KV head's key blocks in a row, the heaviest causal block (the first keys) first: the
  // blocks in flight stream a few heads' Q and dO, which stay in the L2
  const int nkb = (S + R - 1) / R;
  const int bk = blockIdx.x / nkb, k0 = (blockIdx.x % nkb) * R;
  const int b = bk / KV, kvh = bk % KV, G = H / KV;
  // live query tiles [i_lo, i_lo + n_i): some query of the tile sees some key of the block
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S - 1, k0 + R - 2 + window) : S - 1;
  const int i_lo = q_lo / TQ, n_i = q_hi / TQ - i_lo + 1, n_steps = G * n_i;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, SPLIT ? 256 : 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(kv_full, 6 * RP);
      for (int t = 0; t < 3; ++t)
        for (int hb = 0; hb < L::NH; ++hb)
          for (int r = 0; r < R / 64; ++r) {
            const int col = t * D + hb * L::SW / 2, at = t * RP + (hb * R + r * 64) * L::SW;
            tma_load_4d(ks + at, tk, col, kvh, k0 + r * 64, b, kv_full);
            tma_load_4d(vs + at, tv, col, kvh, k0 + r * 64, b, kv_full);
          }
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % STAGES;
        mbar_wait(empty + st, ((step / STAGES) & 1) ^ 1);
        const int h = kvh * G + step / n_i, s0 = (i_lo + step % n_i) * TQ;
        unsigned char* const sp = stages + st * STAGE;
        mbar_arrive_tx(full + st, 6 * TP + 2 * TQ * 4);
        for (int t = 0; t < 3; ++t)
          for (int hb = 0; hb < L::NH; ++hb) {
            const int col = t * D + hb * L::SW / 2, at = t * TP + hb * TQ * L::SW;
            tma_load_4d(sp + at, tq, col, h, s0, b, full + st);
            tma_load_4d(sp + 3 * TP + at, tdo, col, h, s0, b, full + st);
          }
        const int at = (b * H + h) * S4 + s0;
        tma_load_1d(sp + 6 * TP, tlse, at, full + st);
        tma_load_1d(sp + 6 * TP + TQ * 4, tdvec, at, full + st);
      }
    }
  } else {
    regs_inc<240>();
    const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = SPLIT ? 64 * c : 0;             // this warpgroup's resident rows
    const int kw0 = k0 + r0;                       // its keys
    const int key0 = kw0 + warp * 16 + g;          // this thread's keys: key0, key0 + 8
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    mbar_wait(kv_full, 0);

    // split: every step; alternate: warpgroup c takes steps c, c + 2, …
    for (int step = SPLIT ? 0 : c; step < n_steps; step += SPLIT ? 1 : 2) {
      const int st = step % STAGES;
      const int q0 = (i_lo + step % n_i) * TQ;
      const unsigned char* const qs = stages + st * STAGE;   // Q·scale's terms
      const unsigned char* const gs = qs + 3 * TP;           // dO's terms
      const float* const lt = reinterpret_cast<const float*>(qs + 6 * TP);
      const float* const dt = lt + TQ;
      mbar_wait(full + st, (step / STAGES) & 1);
      const bool dead = kw0 >= S || (causal && kw0 > q0 + TQ - 1) ||
                        (window > 0 && q0 - (kw0 + 63) >= window);
      if (!dead) {
        // Sᵀ = K·(Q·scale)ᵀ and dPᵀ = V·dOᵀ, 64 keys × TQ queries, six products each over all
        // of D, smallest first, both operands' terms from shared memory
        float sc[NT], dp[NT];
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_ss(__nv_bfloat16(), sc, desc_k<D>(ks + prod_a(p) * RP, R, r0, kk),
                     desc_k<D>(qs + prod_b(p) * TP, TQ, 0, kk), p + kk);
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_ss(__nv_bfloat16(), dp, desc_k<D>(vs + prod_a(p) * RP, R, r0, kk),
                     desc_k<D>(gs + prod_b(p) * TP, TQ, 0, kk), p + kk);
        wgmma_commit();
        wgmma_wait();
        reg_fence(sc);
        reg_fence(dp);

        // Pᵀ = exp(Sᵀ − lse) (0 where masked), dSᵀ = Pᵀ ∘ (dPᵀ − Dvec); element i is key
        // key0 + 8·((i >> 1) & 1), query q0 + 8·(i >> 2) + 2·t4 + (i & 1), whose lse and
        // Dvec are lv[u], dvv[u], u = 2·(i >> 2) + (i & 1)
        float lv[NT / 2], dvv[NT / 2];
#pragma unroll
        for (int c8 = 0; c8 < TQ / 8; ++c8) {
          const float2 l2 = *reinterpret_cast<const float2*>(lt + c8 * 8 + 2 * t4);
          const float2 d2 = *reinterpret_cast<const float2*>(dt + c8 * 8 + 2 * t4);
          lv[2 * c8] = l2.x;
          lv[2 * c8 + 1] = l2.y;
          dvv[2 * c8] = d2.x;
          dvv[2 * c8 + 1] = d2.y;
        }
#pragma unroll
        for (int i = 0; i < NT; ++i)
          sc[i] = exp2_ftz((sc[i] - lv[2 * (i >> 2) + (i & 1)]) * kLog2e);
        if (q0 + TQ - 1 >= S || kw0 + 63 >= S || (causal && kw0 + 63 > q0) ||
            (window > 0 && q0 + TQ - 1 - kw0 >= window)) {
#pragma unroll
          for (int i = 0; i < NT; ++i)
            sc[i] = visible(q0 + (i >> 2) * 8 + 2 * t4 + (i & 1), key0 + ((i >> 1) & 1) * 8, S,
                            causal, window) ? sc[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) dp[i] = sc[i] * (dp[i] - dvv[2 * (i >> 2) + (i & 1)]);

        // dV += Pᵀ·dO, dK += dSᵀ·(Q·scale): Pᵀ's and dSᵀ's terms as A from registers (the
        // accumulator's layout is the A fragment's), dO's and Q's terms as MN-major B from
        // the very tiles the first products read K-major
        uint32_t pa[3][TQ / 16][4], sa[3][TQ / 16][4];
#pragma unroll
        for (int j = 0; j < TQ / 16; ++j)
#pragma unroll
          for (int rg = 0; rg < 4; ++rg) {
            split3(sc[8 * j + 2 * rg], sc[8 * j + 2 * rg + 1], pa[0][j][rg], pa[1][j][rg],
                   pa[2][j][rg]);
            split3(dp[8 * j + 2 * rg], dp[8 * j + 2 * rg + 1], sa[0][j][rg], sa[1][j][rg],
                   sa[2][j][rg]);
          }
        reg_fence(dka);
        reg_fence(dva);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < TQ / 16; ++j)
#pragma unroll
          for (int p = 0; p < 6; ++p)
            wgmma_rs_t(__nv_bfloat16(), dva, pa[prod_a(p)][j],
                       desc_mn<D>(gs + prod_b(p) * TP, TQ, j));
#pragma unroll
        for (int j = 0; j < TQ / 16; ++j)
#pragma unroll
          for (int p = 0; p < 6; ++p)
            wgmma_rs_t(__nv_bfloat16(), dka, sa[prod_a(p)][j],
                       desc_mn<D>(qs + prod_b(p) * TP, TQ, j));
        wgmma_commit();
        wgmma_wait();
        reg_fence(dka);
        reg_fence(dva);
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          reg_fence(pa[t]);
          reg_fence(sa[t]);
        }
      }
      mbar_arrive(empty + st);
    }

    if constexpr (!SPLIT) {
      float* const red = reinterpret_cast<float*>(stages);
      bar_sync256(1);                               // every tile consumed
      b32_add_sums(dka, red, c, 0);
      b32_add_sums(dva, red, c, D / 2);
    }
    if (SPLIT || c == 0) {
      const size_t kv_stride = size_t(KV) * D;
      float* const dkb = dk + (size_t(b) * S * KV + kvh) * D;
      float* const dvb = dv + (size_t(b) * S * KV + kvh) * D;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int s = key0 + rr * 8;
        if (s >= S) continue;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const size_t at = size_t(s) * kv_stride + i * 8 + 2 * t4;
          *reinterpret_cast<float2*>(dkb + at) =
              make_float2(dka[4 * i + 2 * rr], dka[4 * i + 2 * rr + 1]);
          *reinterpret_cast<float2*>(dvb + at) =
              make_float2(dva[4 * i + 2 * rr], dva[4 * i + 2 * rr + 1]);
        }
      }
    }
  }
}

// dQ of `rows` query rows of one head: warpgroup 0 loads (Q·scale's and dO's terms once, then
// the live tiles of K's and V's terms through the ring); warpgroups 1 and 2 compute.
template <int D>
__global__ void __launch_bounds__(B32_THREADS, 1)
flash_bwd_dq_f32_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse4,
                        const float* __restrict__ dvec, float* __restrict__ dq, int S, int S4,
                        int H, int KV, int causal, int window, float scale) {
  using L = Tile16<D>;
  constexpr bool SPLIT = b32_split<D>();
  constexpr int R = b32_rows<D>(), TK = b32_tile<D>(), STAGES = b32_stages<D>();
  constexpr int RP = R * D * 2;                   // one term of the resident Q·scale or dO
  constexpr int TP = TK * D * 2;                  // one term of a streamed K or V tile
  constexpr int STAGE = 6 * TP;                   // K's terms, V's terms
  constexpr int KS = D / 16, NT = TK / 2;
  extern __shared__ __align__(1024) unsigned char b32_smem[];
  unsigned char* const qs = align1024(b32_smem);  // Q·scale's terms [3][NH][R][SW]
  unsigned char* const gs = qs + 3 * RP;          // dO's terms
  unsigned char* const stages = gs + 3 * RP;
  uint64_t* const q_full = reinterpret_cast<uint64_t*>(stages + STAGES * STAGE);
  uint64_t* const full = q_full + 1;
  uint64_t* const empty = full + STAGES;

  // a head's query blocks in a row, the heaviest causal block (the last rows) first, and the
  // heads of a KV group in a row: the blocks in flight share a few K and V heads in the L2
  const int nqb = (S + R - 1) / R;
  const int bh = blockIdx.x / nqb, q0 = (nqb - 1 - blockIdx.x % nqb) * R;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  int t_hi = (S - 1) / TK;                        // live key tiles, the forward's predicate
  if (causal) t_hi = min(t_hi, (q0 + R - 1) / TK);
  int t_lo = 0;
  if (window > 0) {
    const int x = q0 - window - TK + 1;
    if (x >= 0) t_lo = x / TK + 1;
  }
  const int n_steps = t_hi - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, SPLIT ? 256 : 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(q_full, 6 * RP);
      for (int t = 0; t < 3; ++t)
        for (int hb = 0; hb < L::NH; ++hb)
          for (int r = 0; r < R / 64; ++r) {
            const int col = t * D + hb * L::SW / 2, at = t * RP + (hb * R + r * 64) * L::SW;
            tma_load_4d(qs + at, tq, col, h, q0 + r * 64, b, q_full);
            tma_load_4d(gs + at, tdo, col, h, q0 + r * 64, b, q_full);
          }
      for (int step = 0; step < n_steps; ++step) {
        const int st = step % STAGES;
        mbar_wait(empty + st, ((step / STAGES) & 1) ^ 1);
        const int kt0 = (t_lo + step) * TK;
        unsigned char* const sp = stages + st * STAGE;
        mbar_arrive_tx(full + st, STAGE);
        for (int t = 0; t < 3; ++t)
          for (int hb = 0; hb < L::NH; ++hb) {
            const int col = t * D + hb * L::SW / 2, at = t * TP + hb * TK * L::SW;
            tma_load_4d(sp + at, tk, col, kvh, kt0, b, full + st);
            tma_load_4d(sp + 3 * TP + at, tv, col, kvh, kt0, b, full + st);
          }
      }
    }
  } else {
    regs_inc<240>();
    const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = SPLIT ? 64 * c : 0;             // this warpgroup's resident rows
    const int qw0 = q0 + r0;
    const int row0 = qw0 + warp * 16 + g;          // this thread's rows: row0, row0 + 8
    float lr[2], dr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int s = row0 + rr * 8;
      lr[rr] = s < S ? lse4[(size_t(b) * H + h) * S4 + s] : 0.f;
      dr[rr] = s < S ? dvec[(size_t(b) * H + h) * S4 + s] : 0.f;
    }
    float dqa[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int step = SPLIT ? 0 : c; step < n_steps; step += SPLIT ? 1 : 2) {
      const int st = step % STAGES;
      const int kt0 = (t_lo + step) * TK;
      const unsigned char* const kt = stages + st * STAGE;   // K's terms
      const unsigned char* const vt = kt + 3 * TP;           // V's terms
      mbar_wait(full + st, (step / STAGES) & 1);
      const bool dead = qw0 >= S || (causal && kt0 > qw0 + 63) ||
                        (window > 0 && qw0 - (kt0 + TK - 1) >= window);
      if (!dead) {
        // S = (Q·scale)·Kᵀ and dP = dO·Vᵀ, 64 rows × TK keys
        float sc[NT], dp[NT];
        wgmma_fence();
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_ss(__nv_bfloat16(), sc, desc_k<D>(qs + prod_a(p) * RP, R, r0, kk),
                     desc_k<D>(kt + prod_b(p) * TP, TK, 0, kk), p + kk);
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            wgmma_ss(__nv_bfloat16(), dp, desc_k<D>(gs + prod_a(p) * RP, R, r0, kk),
                     desc_k<D>(vt + prod_b(p) * TP, TK, 0, kk), p + kk);
        wgmma_commit();
        wgmma_wait();
        reg_fence(sc);
        reg_fence(dp);

        // dS = P ∘ (dP − Dvec), P = exp(S − lse); element i is row row0 + 8·((i >> 1) & 1),
        // key kt0 + 8·(i >> 2) + 2·t4 + (i & 1)
#pragma unroll
        for (int i = 0; i < NT; ++i) sc[i] = exp2_ftz((sc[i] - lr[(i >> 1) & 1]) * kLog2e);
        if (qw0 + 63 >= S || kt0 + TK - 1 >= S || (causal && kt0 + TK - 1 > qw0) ||
            (window > 0 && qw0 + 63 - kt0 >= window)) {
#pragma unroll
          for (int i = 0; i < NT; ++i)
            sc[i] = visible(row0 + ((i >> 1) & 1) * 8, kt0 + (i >> 2) * 8 + 2 * t4 + (i & 1), S,
                            causal, window) ? sc[i] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) dp[i] = sc[i] * (dp[i] - dr[(i >> 1) & 1]);

        // dQ += dS·K: dS's terms as A from registers, K's as MN-major B from its tile
        uint32_t sa[3][TK / 16][4];
#pragma unroll
        for (int j = 0; j < TK / 16; ++j)
#pragma unroll
          for (int rg = 0; rg < 4; ++rg)
            split3(dp[8 * j + 2 * rg], dp[8 * j + 2 * rg + 1], sa[0][j][rg], sa[1][j][rg],
                   sa[2][j][rg]);
        reg_fence(dqa);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < TK / 16; ++j)
#pragma unroll
          for (int p = 0; p < 6; ++p)
            wgmma_rs_t(__nv_bfloat16(), dqa, sa[prod_a(p)][j],
                       desc_mn<D>(kt + prod_b(p) * TP, TK, j));
        wgmma_commit();
        wgmma_wait();
        reg_fence(dqa);
#pragma unroll
        for (int t = 0; t < 3; ++t) reg_fence(sa[t]);
      }
      mbar_arrive(empty + st);
    }

    if constexpr (!SPLIT) {
      bar_sync256(1);                               // every tile consumed
      b32_add_sums(dqa, reinterpret_cast<float*>(stages), c, 0);
    }
    if (SPLIT || c == 0) {
      const size_t q_stride = size_t(H) * D;
      float* const dqb = dq + (size_t(b) * S * H + h) * D;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int s = row0 + rr * 8;
        if (s >= S) continue;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<float2*>(dqb + size_t(s) * q_stride + i * 8 + 2 * t4) =
              make_float2(dqa[4 * i + 2 * rr] * scale, dqa[4 * i + 2 * rr + 1] * scale);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, void* scratch, int B,
           int S, int H, int KV, int causal, int window, int chunk, float scale,
           cudaStream_t stream) {
  float* lse_f = static_cast<float*>(lse);
  if constexpr (sizeof(T) == 4) {
    // K's and V's three terms a row into the scratch (flash_split3_kernel), then the forward
    const long n4 = long(B) * S * KV * D / 4;
    __nv_bfloat16* const kp = static_cast<__nv_bfloat16*>(scratch);
    __nv_bfloat16* const vp = kp + 12 * n4;
    CUtensorMap mk, mv;
    if (!scratch || chunk < 1 || chunk > B * H || !encode_tiled() ||
        !rows_map<__nv_bfloat16, D>(&mk, kp, B, S, KV, F32_BK, 3 * D) ||
        !rows_map<__nv_bfloat16, D>(&mv, vp, B, S, KV, F32_BK, 3 * D))
      return int(cudaErrorInvalidValue);
    const Split3Jobs jobs = {{static_cast<const float*>(k), static_cast<const float*>(v)},
                             {kp, vp}, {n4, n4}, {1.f, 1.f}};
    flash_split3_kernel<<<dim3(split_blocks(n4), 2), 256, 0, stream>>>(jobs, D);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    constexpr size_t smem = f32_smem_bytes<D>();
    e = cudaFuncSetAttribute(flash_fwd_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const unsigned blocks = unsigned(B) * H * ((S + F32_BQ - 1) / F32_BQ);
    flash_fwd_f32_kernel<D><<<blocks, FWD_THREADS, smem, stream>>>(
        static_cast<const float*>(q), mk, mv, static_cast<float*>(o), lse_f, S, H, KV, causal,
        window, scale, B * H, chunk);
  } else {
    CUtensorMap mq, mk, mv;
    if (chunk < 1 || chunk > B * H || !encode_tiled() || !rows_map<T, D>(&mq, q, B, S, H, FWD_BQ) ||
        !rows_map<T, D>(&mk, k, B, S, KV, FWD_BK) || !rows_map<T, D>(&mv, v, B, S, KV, FWD_BK))
      return int(cudaErrorInvalidValue);
    constexpr size_t smem = fwd_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const unsigned blocks = unsigned(B) * H * ((S + FWD_BQ - 1) / FWD_BQ);
    flash_fwd_kernel<T, D><<<blocks, FWD_THREADS, smem, stream>>>(
        mq, mk, mv, static_cast<T*>(o), lse_f, S, H, KV, causal, window, scale, B * H, chunk);
  }
  return int(cudaGetLastError());
}

// The f32 backward after the row-dot pass: q·scale, k, v and dO into the scratch as rows of
// their three bf16 terms (flash_split3_kernel), then the two kernels
template <int D>
int launch_bwd_f32(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse4, const float* dvec, void* scratch, float* dq, float* dk,
                   float* dv, int B, int S, int S4, int H, int KV, int causal, int window,
                   float scale, cudaStream_t stream) {
  using BF = __nv_bfloat16;
  const long nq4 = long(B) * S * H * D / 4, nk4 = long(B) * S * KV * D / 4;
  BF* const q3 = static_cast<BF*>(scratch);
  BF* const k3 = q3 + 12 * nq4;
  BF* const v3 = k3 + 12 * nk4;
  BF* const g3 = v3 + 12 * nk4;
  constexpr int R = b32_rows<D>(), TT = b32_tile<D>();
  const size_t nv = size_t(B) * H * S4;
  // dK/dV: K and V resident (boxes of 64 rows), Q and dO streamed; dQ the other way round
  CUtensorMap rk, rv, sq, sdo, ml, md, rq, rdo, sk, sv;
  if (!scratch || !encode_tiled() || !rows_map<BF, D>(&rk, k3, B, S, KV, 64, 3 * D) ||
      !rows_map<BF, D>(&rv, v3, B, S, KV, 64, 3 * D) ||
      !rows_map<BF, D>(&sq, q3, B, S, H, TT, 3 * D) ||
      !rows_map<BF, D>(&sdo, g3, B, S, H, TT, 3 * D) || !vec_map(&ml, lse4, nv, TT) ||
      !vec_map(&md, dvec, nv, TT) || !rows_map<BF, D>(&rq, q3, B, S, H, 64, 3 * D) ||
      !rows_map<BF, D>(&rdo, g3, B, S, H, 64, 3 * D) ||
      !rows_map<BF, D>(&sk, k3, B, S, KV, TT, 3 * D) ||
      !rows_map<BF, D>(&sv, v3, B, S, KV, TT, 3 * D))
    return int(cudaErrorInvalidValue);
  const Split3Jobs jobs = {{q, k, v, dout}, {q3, k3, v3, g3}, {nq4, nk4, nk4, nq4},
                           {scale, 1.f, 1.f, 1.f}};
  flash_split3_kernel<<<dim3(split_blocks(nq4 > nk4 ? nq4 : nk4), 4), 256, 0, stream>>>(jobs, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  constexpr size_t smem_kv = b32_smem_bytes<D>(true), smem_q = b32_smem_bytes<D>(false);
  if ((e = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_kv))) ||
      (e = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_q))))
    return int(e);
  flash_bwd_dkdv_f32_kernel<D><<<unsigned(B) * KV * ((S + R - 1) / R), B32_THREADS, smem_kv,
                                 stream>>>(sq, rk, rv, sdo, ml, md, dk, dv, S, S4, H, KV, causal,
                                           window);
  if ((e = cudaGetLastError())) return int(e);
  flash_bwd_dq_f32_kernel<D><<<unsigned(B) * H * ((S + R - 1) / R), B32_THREADS, smem_q,
                               stream>>>(rq, sk, sv, rdo, lse4, dvec, dq, S, S4, H, KV, causal,
                                         window, scale);
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dvec, void* scratch, void* dq, void* dk, void* dv, int B,
               int S, int H, int KV, int causal, int window, float scale, cudaStream_t stream) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(dvec);
  // Dvec and a copy of lse in rows of S4 (S rounded up to 4) for the TMA loads
  const int S4 = (S + 3) / 4 * 4;
  float* const lse4 = df + size_t(B) * H * S4;
  const long threads = long(B) * S * H * (sizeof(T) == 2 ? D / 8 : 32);
  flash_bwd_rowdot_kernel<T><<<unsigned((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), gt, lf, df, lse4, B, S, H, D, S4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  if constexpr (sizeof(T) == 4) {
    return launch_bwd_f32<D>(qt, kt, vt, gt, lse4, df, scratch, static_cast<float*>(dq),
                             static_cast<float*>(dk), static_cast<float*>(dv), B, S, S4, H, KV,
                             causal, window, scale, stream);
  } else {
    CUtensorMap mq, mk, mv, mdo, ml, md;
    if (!encode_tiled() || !rows_map<T, D>(&mq, q, B, S, H, 64) ||
        !rows_map<T, D>(&mk, k, B, S, KV, 64) || !rows_map<T, D>(&mv, v, B, S, KV, 64) ||
        !rows_map<T, D>(&mdo, dout, B, S, H, 64) ||
        !vec_map(&ml, lse4, size_t(B) * H * S4) || !vec_map(&md, df, size_t(B) * H * S4))
      return int(cudaErrorInvalidValue);
    constexpr size_t smem_kv = dkdv_smem_bytes<D>(), smem_q = dq_smem_bytes<D>();
    if ((e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_kv))) ||
        (e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_q))))
      return int(e);
    const int blocks = (S + 127) / 128;
    flash_bwd_dkdv_kernel<T, D><<<dim3(B * KV, blocks), BWD_THREADS, smem_kv, stream>>>(
        mq, mk, mv, mdo, ml, md, static_cast<T*>(dk), static_cast<T*>(dv), S, S4, H, KV,
        causal, window, scale);
    if ((e = cudaGetLastError())) return int(e);
    flash_bwd_dq_kernel<T, D><<<dim3(B * H, blocks), BWD_THREADS, smem_q, stream>>>(
        mq, mk, mv, mdo, lf, df, static_cast<T*>(dq), S, S4, H, KV, causal, window, scale);
  }
  return int(cudaGetLastError());
}

template <typename T>
int by_dim(const void* q, const void* k, const void* v, void* o, void* lse, void* scratch, int B,
           int S, int H, int KV, int D, int causal, int window, int chunk, float scale,
           cudaStream_t stream) {
#define FLASH_FWD(DD)                                                                   \
  launch<T, DD>(q, k, v, o, lse, scratch, B, S, H, KV, causal, window, chunk, scale, stream)
  switch (D) {
    case 16: return FLASH_FWD(16);
    case 32: return FLASH_FWD(32);
    case 64: return FLASH_FWD(64);
    case 128: return FLASH_FWD(128);
#undef FLASH_FWD
  }
  return int(cudaErrorInvalidValue);
}

template <typename T>
int bwd_by_dim(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dvec, void* scratch, void* dq, void* dk, void* dv, int B,
               int S, int H, int KV, int D, int causal, int window, float scale,
               cudaStream_t stream) {
#define FLASH_BWD(DD)                                                                     \
  case DD:                                                                                \
    return launch_bwd<T, DD>(q, k, v, o, dout, lse, dvec, scratch, dq, dk, dv, B, S, H, KV, \
                             causal, window, scale, stream);
  switch (D) {
    FLASH_BWD(16)
    FLASH_BWD(32)
    FLASH_BWD(64)
    FLASH_BWD(128)
  }
#undef FLASH_BWD
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and o alike).
// D in {16, 32, 64, 128}; H a multiple of KV; B·H at most 65,535; q, k and v
// 16-byte aligned. lse: null, or (B, H, S) f32 that
// receives each row's log-sum-exp of its scaled scores, m + log(max(l, 1e-30)).
// chunk: the query heads a chunk of the launch order, 1..B·H (flash_attention.py
// ForwardLaunch.chunk). scratch: f32 only, 6·B·S·KV·D bf16, 16-byte aligned (K's and V's
// three terms a row); null for the 16-bit dtypes
extern "C" int flash_attention(const void* q, const void* k, const void* v, int dtype, int B,
                               int S, int H, int KV, int D, int causal, int window, int chunk,
                               float scale, void* o, void* lse, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return by_dim<float>(q, k, v, o, lse, scratch, B, S, H, KV, D, causal, window, chunk,
                           scale, s);
    case 1:
      return by_dim<__nv_bfloat16>(q, k, v, o, lse, nullptr, B, S, H, KV, D, causal, window,
                                   chunk, scale, s);
    case 2:
      return by_dim<__half>(q, k, v, o, lse, nullptr, B, S, H, KV, D, causal, window, chunk,
                            scale, s);
  }
  return int(cudaErrorInvalidValue);
}

// The forward's launch shape for dtype and D, as flash_attention.py's forward_launch_shape
// mirrors it: out[0..4] = query rows a block, keys a tile, ring stages, threads a block,
// dynamic shared memory bytes. Returns 0, or an error for another D or dtype.
extern "C" int flash_forward_shape(int dtype, int D, int* out) {
  switch (D) {
#define FLASH_SHAPE(DD)                                                                    \
  case DD:                                                                                 \
    if (dtype == 0) {                                                                      \
      out[0] = F32_BQ, out[1] = F32_BK, out[2] = f32_stages<DD>(), out[3] = FWD_THREADS;   \
      out[4] = int(f32_smem_bytes<DD>());                                                  \
    } else {                                                                               \
      out[0] = FWD_BQ, out[1] = FWD_BK, out[2] = fwd_stages<DD>(), out[3] = FWD_THREADS;   \
      out[4] = int(fwd_smem_bytes<DD>());                                                  \
    }                                                                                      \
    return dtype >= 0 && dtype <= 2 ? 0 : int(cudaErrorInvalidValue);
    FLASH_SHAPE(16)
    FLASH_SHAPE(32)
    FLASH_SHAPE(64)
    FLASH_SHAPE(128)
#undef FLASH_SHAPE
  }
  return int(cudaErrorInvalidValue);
}

// The backward's two kernels' launch shapes for dtype and D, as flash_attention.py's
// backward_launch_shape mirrors them: out[0..5] the dK/dV kernel's resident rows a block
// (keys), streamed tile rows (queries), ring stages, threads a block, dynamic shared memory
// bytes and whether its two consumer warpgroups split the resident rows (1) or take
// alternate tiles of the same rows (0); out[6..11] the same of the dQ kernel (resident query
// rows, streamed keys). Returns 0, or an error for another D or dtype.
extern "C" int flash_backward_shape(int dtype, int D, int* out) {
  switch (D) {
#define FLASH_BWD_SHAPE(DD)                                                                \
  case DD:                                                                                 \
    for (int kind = 0; kind < 2; ++kind) {                                                 \
      int* const o = out + 6 * kind;                                                       \
      if (dtype == 0) {                                                                    \
        o[0] = b32_rows<DD>(), o[1] = b32_tile<DD>(), o[2] = b32_stages<DD>();             \
        o[3] = B32_THREADS, o[4] = int(b32_smem_bytes<DD>(kind == 0));                     \
        o[5] = b32_split<DD>();                                                            \
      } else {                                                                             \
        o[0] = 128, o[1] = 64, o[2] = BWD_STAGES, o[3] = BWD_THREADS;                      \
        o[4] = int(kind == 0 ? dkdv_smem_bytes<DD>() : dq_smem_bytes<DD>()), o[5] = 1;     \
      }                                                                                    \
    }                                                                                      \
    return dtype >= 0 && dtype <= 2 ? 0 : int(cudaErrorInvalidValue);
    FLASH_BWD_SHAPE(16)
    FLASH_BWD_SHAPE(32)
    FLASH_BWD_SHAPE(64)
    FLASH_BWD_SHAPE(128)
#undef FLASH_BWD_SHAPE
  }
  return int(cudaErrorInvalidValue);
}

// The backward: dq (B, S, H, D), dk and dv (B, S, KV, D) in the inputs' dtype from q, k,
// v, the forward's o and lse (B, H, S) f32, and dout (like o); dvec is f32 scratch of
// 2·B·H·S4 values, S4 = S rounded up to a multiple of 4. Same shapes, dtypes and alignment
// as flash_attention (o and dout too). scratch: f32 only, 6·B·S·(H + KV)·D bf16, 16-byte
// aligned (q·scale's, k's, v's and dO's three terms a row); null for the 16-bit dtypes
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        int dtype, int B, int S, int H, int KV, int D,
                                        int causal, int window, float scale, void* dvec,
                                        void* scratch, void* dq, void* dk, void* dv,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return bwd_by_dim<float>(q, k, v, o, dout, lse, dvec, scratch, dq, dk, dv, B, S, H, KV,
                               D, causal, window, scale, s);
    case 1:
      return bwd_by_dim<__nv_bfloat16>(q, k, v, o, dout, lse, dvec, nullptr, dq, dk, dv, B, S,
                                       H, KV, D, causal, window, scale, s);
    case 2:
      return bwd_by_dim<__half>(q, k, v, o, dout, lse, dvec, nullptr, dq, dk, dv, B, S, H, KV,
                                D, causal, window, scale, s);
  }
  return int(cudaErrorInvalidValue);
}
