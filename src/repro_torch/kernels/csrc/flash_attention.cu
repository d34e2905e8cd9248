// Block-wise online-softmax attention (flash attention) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention: q (B, S, H, D),
// k, v (B, S, KV, D) in one float dtype → o (B, S, H, D) in that dtype. Head h
// reads KV head h / (H / KV) (GQA). Masks: key position < S; causal: pos_q >=
// pos_k; window > 0: pos_q - pos_k < window. Arithmetic is the Pallas kernel's,
// in f32: s = scale·(q·k) (the f32 body scales q first, as the reference
// does), m_new = max(m, rowmax s), p = exp(s - m_new), corr =
// exp(m - m_new), l = l·corr + Σp, acc = acc·corr + p·v, o = acc / max(l,
// 1e-30), rounded once to q's dtype. Masked scores are the finite -1e30, never
// -inf: a row whose first live tile is fully masked for it takes p = exp(0) = 1
// on those slots until its first real key makes corr = exp(-1e30 - m) = 0 and
// wipes them, where -inf would give NaN. A key tile is skipped only where no
// row of the block can see it (the reference's causal `break` and window
// `continue`), so the live tiles are one contiguous range.
//
// What bounds it on an H100: operations, 4·D flops per unmasked (q, k) pair
// per head against a few bytes per pair. Two bodies:
//
// * bf16 / fp16 (flash_tc_kernel): both products on the tensor cores with
//   mma.sync.m16n8k16 (f32 accumulation). mma.sync and not wgmma: its
//   register layouts are fixed and documented, so the S accumulator turns
//   into P's A operand in registers with no shared-memory descriptors or
//   swizzle modes to get right; wgmma would reach the full tensor rate and
//   is the next step. A block of 4 warps owns 64 query rows of one head
//   (16 rows per warp). Q is staged once, in K's second stage before that
//   fills, and kept in registers as A fragments (ldmatrix); at D 128 a block
//   takes 70 KB of shared memory and 210 registers a thread, so two blocks
//   share an SM (three would spill). K and V tiles of 64 keys stream through
//   a two-stage ring in shared memory filled by cp.async (zero-filled past
//   S), so tile j+1 arrives while tile j computes. Rows are padded by 16
//   bytes, so the 8 rows an ldmatrix reads fall in distinct banks. S = Q·Kᵀ reads
//   K with ldmatrix (K's rows are Bᵀ's columns); the softmax scale is applied
//   to S in f32 after the product (the reference scales q in f32, so a
//   pre-scaled 16-bit Q would be a new rounding). The online softmax runs in
//   the accumulator's own layout: a thread holds 2 rows × 16 keys of a tile
//   and takes row max and sum with two quad shuffles; exp is __expf (ex2 of
//   x·log2 e, a few ulp, far inside the output's one rounding). P stays at the
//   reference's f32 precision: P_hi = round(P), P_lo = round(P - P_hi), both
//   in the input's 16-bit type, and O += P_hi·V + P_lo·V (V through
//   ldmatrix.trans), a residue of about 2^-16 of P. The split costs 1.5× the
//   MMA work of a kernel that rounds P once, as SDPA does. Query tiles launch
//   heaviest first under a causal mask (blockIdx.y counts down).
// * f32 (flash_f32_kernel): f32 FMAs on the CUDA cores (67 TFLOP/s peak);
//   TF32 tensor cores would break the 2e-5 contract, and this body already
//   beats SDPA's f32 path. A block owns 64 query rows and walks the 64-key
//   tiles; Q (pre-scaled) and Kᵀ are staged transposed so a thread reads 4
//   query rows and 4 keys as two float4 per step of d and keeps a 4×4 score
//   tile; half-warps reduce the row max and sum with shuffles; P goes back to
//   shared memory in Kᵀ's place; each thread accumulates 4 rows × D/16
//   output columns.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// bf16 / fp16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;              // query rows per block (16 per warp)
constexpr int TC_BK = 64;              // keys per tile
constexpr int TC_THREADS = 128;

template <int D>
constexpr size_t tc_smem_bytes() {     // two stages of K and V, 16-bit (Q borrows one)
  return size_t(4 * TC_BK) * (D + 8) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronous; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_1() {   // all but the newest group done
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c (16×8, f32) += a (16×16) · b (16×8), a row-major, b column-major
template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4],
                                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// 64 rows of D values from rows s0.. of src (row stride `stride`) into dst
// (row stride D + 8), zeros for rows at or past S; one commit group per call
// site, issued by all 128 threads.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, size_t stride, int s0, int S) {
  constexpr int CPR = D / 8;           // 16-byte pieces per row
  for (int e = threadIdx.x; e < 64 * CPR; e += TC_THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8, s = s0 + r;
    const bool in = s < S;
    cp_async16(dst + r * (D + 8) + c, in ? src + size_t(s) * stride + c : src, in ? 16 : 0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_tc_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ o, float* __restrict__ lse, int S, int H, int KV, int causal,
                int window, float scale) {
  constexpr int STR = D + 8;           // shared row stride (elements)
  constexpr int KST = D / 16;          // k-steps of Q·Kᵀ, d-pairs of P·V
  constexpr int NT = TC_BK / 8;        // 8-key score tiles per warp row slab
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);          // [2][64][STR]
  T* vs = ks + 2 * TC_BK * STR;                    // [2][64][STR]
  T* qs = ks + TC_BK * STR;                        // [64][STR], in K's stage 1 until read

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;          // mma fragment row / column pair
  const int mi = lane >> 3, mr = lane & 7;         // ldmatrix matrix / row of this lane
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_BQ;   // heaviest causal tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const size_t q_stride = size_t(H) * D, kv_stride = size_t(KV) * D;
  const T* qb = q + (size_t(b) * S * H + h) * D;
  const T* kb = k + (size_t(b) * S * KV + kvh) * D;
  const T* vb = v + (size_t(b) * S * KV + kvh) * D;

  // live key tiles [t_lo, t_hi]: the reference's block predicate
  int t_hi = (S - 1) / TC_BK;
  if (causal) t_hi = min(t_hi, (q0 + TC_BQ - 1) / TC_BK);
  int t_lo = 0;
  if (window > 0) {
    const int x = q0 - window - TC_BK + 1;         // live iff k0 > x
    if (x >= 0) t_lo = x / TC_BK + 1;
  }

  stage_rows<T, D>(qs, qb, q_stride, q0, S);
  stage_rows<T, D>(ks, kb, kv_stride, t_lo * TC_BK, S);
  stage_rows<T, D>(vs, vb, kv_stride, t_lo * TC_BK, S);
  cp_async_commit();
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  uint32_t qf[KST][4];                             // Q as A fragments, for every tile
#pragma unroll
  for (int kk = 0; kk < KST; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + mr + (mi & 1) * 8) * STR + kk * 16 + (mi >> 1) * 8);
  __syncthreads();                                 // K's stage 1 is free for tile t_lo + 1

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;             // this thread's rows: row0, row0 + 8

  for (int it = t_lo; it <= t_hi; ++it) {
    const int st = (it - t_lo) & 1;
    if (it < t_hi) {                               // tile it+1 into the other stage
      stage_rows<T, D>(ks + (st ^ 1) * TC_BK * STR, kb, kv_stride, (it + 1) * TC_BK, S);
      stage_rows<T, D>(vs + (st ^ 1) * TC_BK * STR, vb, kv_stride, (it + 1) * TC_BK, S);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const T* kt = ks + st * TC_BK * STR;
    const T* vt = vs + st * TC_BK * STR;

    // S = Q·Kᵀ: per 16 keys, one ldmatrix.x4 gives two 8-key B fragments
    float sc[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
      for (int kk = 0; kk < KST; ++kk) {
        uint32_t bf[4];
        ldsm_x4(bf, kt + (np * 16 + mr + (mi >> 1) * 8) * STR + kk * 16 + (mi & 1) * 8);
        mma16816<T>(sc[2 * np], qf[kk], bf[0], bf[1]);
        mma16816<T>(sc[2 * np + 1], qf[kk], bf[2], bf[3]);
      }
    }

    // scale, mask, online softmax in the accumulator's layout
    const int k0 = it * TC_BK;
    const bool edge = k0 + TC_BK > S || (causal && k0 + TC_BK - 1 > q0) ||
                      (window > 0 && q0 + TC_BQ - 1 - k0 >= window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = sc[nt][e] * scale;
        if (edge) {
          const int pq = row0 + (e >> 1) * 8, pk = k0 + nt * 8 + 2 * t4 + (e & 1);
          bool ok = pk < S;
          if (causal) ok = ok && pq >= pk;
          if (window > 0) ok = ok && pq - pk < window;
          s = ok ? s : kNegInf;
        }
        sc[nt][e] = s;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = kNegInf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(sc[nt][2 * rr], sc[nt][2 * rr + 1]));
      const float m_new = fmaxf(m[rr], quad_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        sc[nt][2 * rr] = __expf(sc[nt][2 * rr] - m_new);
        sc[nt][2 * rr + 1] = __expf(sc[nt][2 * rr + 1] - m_new);
        sum += sc[nt][2 * rr] + sc[nt][2 * rr + 1];
      }
      const float corr = __expf(m[rr] - m_new);
      l[rr] = l[rr] * corr + quad_sum(sum);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[i][2 * rr] *= corr;
        acc[i][2 * rr + 1] *= corr;
      }
      m[rr] = m_new;
    }

    // O += P_hi·V + P_lo·V: the score fragments of keys 16j..16j+15 are the
    // A fragment of P; V's B fragments come from ldmatrix.trans
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t ph[4], pl[4];
      split2<T>(sc[2 * j][0], sc[2 * j][1], ph[0], pl[0]);
      split2<T>(sc[2 * j][2], sc[2 * j][3], ph[1], pl[1]);
      split2<T>(sc[2 * j + 1][0], sc[2 * j + 1][1], ph[2], pl[2]);
      split2<T>(sc[2 * j + 1][2], sc[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KST; ++dp) {
        uint32_t bf[4];
        ldsm_x4_t(bf, vt + (j * 16 + mr + (mi & 1) * 8) * STR + dp * 16 + (mi >> 1) * 8);
        mma16816<T>(acc[2 * dp], ph, bf[0], bf[1]);
        mma16816<T>(acc[2 * dp], pl, bf[0], bf[1]);
        mma16816<T>(acc[2 * dp + 1], ph, bf[2], bf[3]);
        mma16816<T>(acc[2 * dp + 1], pl, bf[2], bf[3]);
      }
    }
    __syncthreads();                   // this stage is free for tile it+2
  }

  T* ob = o + (size_t(b) * S * H + h) * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = row0 + rr * 8;
    if (s >= S) continue;
    const float li = fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(ob + size_t(s) * q_stride + i * 8 + 2 * t4) =
          pack2(T(), acc[i][2 * rr] / li, acc[i][2 * rr + 1] / li, nullptr);
    if (lse && t4 == 0) lse[(size_t(b) * H + h) * S + s] = m[rr] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int kThreads = 256;          // 16 × 16 threads: ty owns 4 rows, tx 4 keys
constexpr int PAD = BQ + 4;            // row stride of Qᵀ, Kᵀ and Pᵀ (floats)

// reduce over the 16 threads of a half-warp (lanes that share ty)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return (size_t(D) * PAD + size_t(D > BK ? D : BK) * PAD + size_t(BK) * (D + 4)) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse, int S,
                 int H, int KV, int causal, int window, float scale) {
  constexpr int VSTR = D + 4;          // row stride of V (floats)
  constexpr int CPT = D / 16;          // output columns per thread
  extern __shared__ __align__(16) float sm[];
  float* qt = sm;                                  // [D][PAD]  Qᵀ·scale
  float* kt = qt + D * PAD;                        // [max(D, BK)][PAD]  Kᵀ, then Pᵀ
  float* vs = kt + (D > BK ? D : BK) * PAD;        // [BK][VSTR]  V

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const size_t q_stride = size_t(H) * D, kv_stride = size_t(KV) * D;
  const float* qb = q + (size_t(b) * S * H + h) * D;
  const float* kb = k + (size_t(b) * S * KV + kvh) * D;
  const float* vb = v + (size_t(b) * S * KV + kvh) * D;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e % D, s = q0 + r;
    qt[c * PAD + r] = s < S ? __fmul_rn(qb[size_t(s) * q_stride + c], scale) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = 0.f;
  }

  const int n_tiles = (S + BK - 1) / BK;
  for (int kt_i = 0; kt_i < n_tiles; ++kt_i) {
    const int k0 = kt_i * BK;
    if (causal && k0 > q0 + BQ - 1) break;                 // this and later tiles dead
    if (window > 0 && q0 - (k0 + BK - 1) >= window) continue;
    __syncthreads();                   // the last tile's readers of Pᵀ and V are done
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D, c = e % D, s = k0 + r;
      float kv_k = 0.f, kv_v = 0.f;
      if (s < S) {
        kv_k = kb[size_t(s) * kv_stride + c];
        kv_v = vb[size_t(s) * kv_stride + c];
      }
      kt[c * PAD + r] = kv_k;
      vs[r * VSTR + c] = kv_v;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(qt + c * PAD + ty * 4);
      const float4 bb = *reinterpret_cast<const float4*>(kt + c * PAD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pq = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pk = k0 + tx * 4 + j;
        bool ok = pk < S;
        if (causal) ok = ok && pq >= pk;
        if (window > 0) ok = ok && pq - pk < window;
        sc[i][j] = ok ? sc[i][j] : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_sum(sum);
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= corr;
      m[i] = m_new;
    }

    __syncthreads();                   // every thread is done reading Kᵀ: Pᵀ takes its place
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(kt + (tx * 4 + j) * PAD + ty * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(kt + j * PAD + ty * 4);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
      float vv[CPT];
      if constexpr (CPT % 4 == 0) {
#pragma unroll
        for (int c4 = 0; c4 < CPT / 4; ++c4) {
          const float4 x = *reinterpret_cast<const float4*>(vs + j * VSTR + tx * CPT + 4 * c4);
          vv[4 * c4] = x.x; vv[4 * c4 + 1] = x.y; vv[4 * c4 + 2] = x.z; vv[4 * c4 + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) vv[cc] = vs[j * VSTR + tx * CPT + cc];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[i][cc] = fmaf(pv[i], vv[cc], acc[i][cc]);
    }
  }

  float* ob = o + (size_t(b) * S * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) ob[size_t(s) * q_stride + tx * CPT + cc] = acc[i][cc] / li;
    if (lse && tx == 0) lse[(size_t(b) * H + h) * S + s] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------------------
// Backward: dQ, dK, dV from q, k, v, o, dO and the forward's row lse
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Dvec[b, h, s] = Σ_d dO[b, s, h, d]·O[b, s, h, d] in f32; one warp per (b, s, h) row
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_rowdot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                        float* __restrict__ dvec, int B, int S, int H, int D) {
  const long r = (long(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= long(B) * S * H) return;
  const T* op = o + size_t(r) * D;
  const T* gp = dout + size_t(r) * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f32(op[c]), to_f32(gp[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = int(r % H), s = int((r / H) % S), b = int(r / (long(H) * S));
    dvec[(size_t(b) * H + h) * S + s] = acc;
  }
}

// the inner tile of the 16-bit backward kernels: queries of a dK/dV step, keys of a dQ
// step (32 at D 128 keeps the accumulators in registers)
template <int D>
__host__ __device__ constexpr int bwd_tile() { return D <= 64 ? 64 : 32; }

template <int D>
constexpr size_t dkdv_smem_bytes() {   // K, V (64 rows); two stages of Q, dO; lse, Dvec
  return size_t(2 * 64 + 4 * bwd_tile<D>()) * (D + 8) * 2 + size_t(4 * bwd_tile<D>()) * 4;
}
template <int D>
constexpr size_t dq_smem_bytes() {     // Q, dO (64 rows); two stages of K, V
  return size_t(2 * 64 + 4 * bwd_tile<D>()) * (D + 8) * 2;
}

// N rows of D values from rows s0.. of src into dst (row stride D + 8), zeros past S
template <typename T, int D, int N>
__device__ __forceinline__ void stage_n(T* dst, const T* src, size_t stride, int s0, int S) {
  constexpr int CPR = D / 8;
  for (int e = threadIdx.x; e < N * CPR; e += TC_THREADS) {
    const int r = e / CPR, c = (e % CPR) * 8, s = s0 + r;
    const bool in = s < S;
    cp_async16(dst + r * (D + 8) + c, in ? src + size_t(s) * stride + c : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ bool visible(int pq, int pk, int S, int causal, int window) {
  bool ok = pq < S && pk < S;
  if (causal) ok = ok && pq >= pk;
  if (window > 0) ok = ok && pq - pk < window;
  return ok;
}

// dK, dV of 64 keys of one KV head (16 per warp): walks the G query heads of the head's
// group and, per head, the live query tiles; sums stay in registers, so no atomics.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkdv_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv, int S,
                  int H, int KV, int causal, int window, float scale) {
  constexpr int STR = D + 8, QT = bwd_tile<D>(), NT = QT / 8, KST = D / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);          // [64][STR]
  T* vs = ks + 64 * STR;                           // [64][STR]
  T* qs = vs + 64 * STR;                           // [2][QT][STR]
  T* gs = qs + 2 * QT * STR;                       // [2][QT][STR]  dO
  float* ls = reinterpret_cast<float*>(gs + 2 * QT * STR);   // [2][QT]  lse
  float* dl = ls + 2 * QT;                                    // [2][QT]  Dvec

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * 64;
  const size_t q_stride = size_t(H) * D, kv_stride = size_t(KV) * D;
  const T* kb = k + (size_t(b) * S * KV + kvh) * D;
  const T* vb = v + (size_t(b) * S * KV + kvh) * D;

  // live query tiles [i_lo, i_hi]: some row of the tile sees some key of the block
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S - 1, k0 + 64 - 2 + window) : S - 1;
  const int i_lo = q_lo / QT, n_i = q_hi / QT - i_lo + 1, n_steps = G * n_i;

  auto stage_step = [&](int step, int st) {        // (head step / n_i, tile i_lo + step % n_i)
    const int h = kvh * G + step / n_i, s0 = (i_lo + step % n_i) * QT;
    stage_n<T, D, QT>(qs + st * QT * STR, q + (size_t(b) * S * H + h) * D, q_stride, s0, S);
    stage_n<T, D, QT>(gs + st * QT * STR, dout + (size_t(b) * S * H + h) * D, q_stride, s0, S);
    for (int t = threadIdx.x; t < QT; t += TC_THREADS) {
      const size_t at = (size_t(b) * H + h) * S + s0 + t;
      ls[st * QT + t] = s0 + t < S ? lse[at] : 0.f;
      dl[st * QT + t] = s0 + t < S ? dvec[at] : 0.f;
    }
  };
  stage_n<T, D, 64>(ks, kb, kv_stride, k0, S);
  stage_n<T, D, 64>(vs, vb, kv_stride, k0, S);
  stage_step(0, 0);
  cp_async_commit();

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;
  const int key0 = k0 + warp * 16 + g;             // this thread's keys: key0, key0 + 8

  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1;
    if (step + 1 < n_steps) stage_step(step + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const T* qt = qs + st * QT * STR;
    const T* gt = gs + st * QT * STR;
    const float* lt = ls + st * QT;
    const float* dt = dl + st * QT;
    const int qi0 = (i_lo + step % n_i) * QT;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys × QT queries a warp; Q's and dO's rows are the
    // B operands' columns (ldmatrix), K and V the A operands
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KST; ++kk) {
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, ks + (warp * 16 + mr + (mi & 1) * 8) * STR + kk * 16 + (mi >> 1) * 8);
      ldsm_x4(vf, vs + (warp * 16 + mr + (mi & 1) * 8) * STR + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, qt + (np * 16 + mr + (mi >> 1) * 8) * STR + kk * 16 + (mi & 1) * 8);
        mma16816<T>(sc[2 * np], kf, bf[0], bf[1]);
        mma16816<T>(sc[2 * np + 1], kf, bf[2], bf[3]);
        ldsm_x4(bf, gt + (np * 16 + mr + (mi >> 1) * 8) * STR + kk * 16 + (mi & 1) * 8);
        mma16816<T>(dp[2 * np], vf, bf[0], bf[1]);
        mma16816<T>(dp[2 * np + 1], vf, bf[2], bf[3]);
      }
    }

    // Pᵀ = exp(scale·Sᵀ − lse) (0 where masked), dSᵀ = Pᵀ ∘ (dPᵀ − Dvec)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cq = nt * 8 + 2 * t4 + (e & 1);
        const float p = visible(qi0 + cq, key0 + (e >> 1) * 8, S, causal, window)
                            ? __expf(sc[nt][e] * scale - lt[cq]) : 0.f;
        sc[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - dt[cq]);
      }

    // dV += Pᵀ·dO, dK += dSᵀ·Q: Pᵀ and dSᵀ are A fragments in registers, each split
    // into a rounded part and its rounded residue (f32 precision, as the forward's P);
    // dO's and Q's B fragments come from ldmatrix.trans
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      split2<T>(sc[2 * j][0], sc[2 * j][1], ph[0], pl[0]);
      split2<T>(sc[2 * j][2], sc[2 * j][3], ph[1], pl[1]);
      split2<T>(sc[2 * j + 1][0], sc[2 * j + 1][1], ph[2], pl[2]);
      split2<T>(sc[2 * j + 1][2], sc[2 * j + 1][3], ph[3], pl[3]);
      split2<T>(dp[2 * j][0], dp[2 * j][1], sh[0], sl[0]);
      split2<T>(dp[2 * j][2], dp[2 * j][3], sh[1], sl[1]);
      split2<T>(dp[2 * j + 1][0], dp[2 * j + 1][1], sh[2], sl[2]);
      split2<T>(dp[2 * j + 1][2], dp[2 * j + 1][3], sh[3], sl[3]);
#pragma unroll
      for (int di = 0; di < KST; ++di) {
        uint32_t bf[4];
        ldsm_x4_t(bf, gt + (j * 16 + mr + (mi & 1) * 8) * STR + di * 16 + (mi >> 1) * 8);
        mma16816<T>(dva[2 * di], ph, bf[0], bf[1]);
        mma16816<T>(dva[2 * di], pl, bf[0], bf[1]);
        mma16816<T>(dva[2 * di + 1], ph, bf[2], bf[3]);
        mma16816<T>(dva[2 * di + 1], pl, bf[2], bf[3]);
        ldsm_x4_t(bf, qt + (j * 16 + mr + (mi & 1) * 8) * STR + di * 16 + (mi >> 1) * 8);
        mma16816<T>(dka[2 * di], sh, bf[0], bf[1]);
        mma16816<T>(dka[2 * di], sl, bf[0], bf[1]);
        mma16816<T>(dka[2 * di + 1], sh, bf[2], bf[3]);
        mma16816<T>(dka[2 * di + 1], sl, bf[2], bf[3]);
      }
    }
    __syncthreads();                   // this stage is free for step + 2
  }

  T* dkb = dk + (size_t(b) * S * KV + kvh) * D;
  T* dvb = dv + (size_t(b) * S * KV + kvh) * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = key0 + rr * 8;
    if (s >= S) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const size_t at = size_t(s) * kv_stride + i * 8 + 2 * t4;
      *reinterpret_cast<uint32_t*>(dkb + at) =
          pack2(T(), dka[i][2 * rr] * scale, dka[i][2 * rr + 1] * scale, nullptr);
      *reinterpret_cast<uint32_t*>(dvb + at) =
          pack2(T(), dva[i][2 * rr], dva[i][2 * rr + 1], nullptr);
    }
  }
}

// dQ of 64 query rows of one head (16 per warp): walks the live key tiles
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_tc(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ dvec, T* __restrict__ dq, int S, int H, int KV,
                int causal, int window, float scale) {
  constexpr int STR = D + 8, KT = bwd_tile<D>(), NT = KT / 8, KST = D / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);          // [64][STR]
  T* gs = qs + 64 * STR;                           // [64][STR]  dO
  T* ks = gs + 64 * STR;                           // [2][KT][STR]
  T* vs = ks + 2 * KT * STR;                       // [2][KT][STR]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 64;      // heaviest causal tiles first
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const size_t q_stride = size_t(H) * D, kv_stride = size_t(KV) * D;
  const T* kb = k + (size_t(b) * S * KV + kvh) * D;
  const T* vb = v + (size_t(b) * S * KV + kvh) * D;

  int t_hi = (S - 1) / KT;             // live key tiles, the forward's predicate
  if (causal) t_hi = min(t_hi, (q0 + 63) / KT);
  int t_lo = 0;
  if (window > 0) {
    const int x = q0 - window - KT + 1;
    if (x >= 0) t_lo = x / KT + 1;
  }

  stage_n<T, D, 64>(qs, q + (size_t(b) * S * H + h) * D, q_stride, q0, S);
  stage_n<T, D, 64>(gs, dout + (size_t(b) * S * H + h) * D, q_stride, q0, S);
  stage_n<T, D, KT>(ks, kb, kv_stride, t_lo * KT, S);
  stage_n<T, D, KT>(vs, vb, kv_stride, t_lo * KT, S);
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;             // this thread's rows: row0, row0 + 8
  float lr[2], dr[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = row0 + rr * 8;
    const size_t at = (size_t(b) * H + h) * S + s;
    lr[rr] = s < S ? lse[at] : 0.f;
    dr[rr] = s < S ? dvec[at] : 0.f;
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  for (int it = t_lo; it <= t_hi; ++it) {
    const int st = (it - t_lo) & 1;
    if (it < t_hi) {
      stage_n<T, D, KT>(ks + (st ^ 1) * KT * STR, kb, kv_stride, (it + 1) * KT, S);
      stage_n<T, D, KT>(vs + (st ^ 1) * KT * STR, vb, kv_stride, (it + 1) * KT, S);
    }
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const T* kt = ks + st * KT * STR;
    const T* vt = vs + st * KT * STR;

    // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows × KT keys a warp
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KST; ++kk) {
      uint32_t qf[4], gf[4];
      ldsm_x4(qf, qs + (warp * 16 + mr + (mi & 1) * 8) * STR + kk * 16 + (mi >> 1) * 8);
      ldsm_x4(gf, gs + (warp * 16 + mr + (mi & 1) * 8) * STR + kk * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, kt + (np * 16 + mr + (mi >> 1) * 8) * STR + kk * 16 + (mi & 1) * 8);
        mma16816<T>(sc[2 * np], qf, bf[0], bf[1]);
        mma16816<T>(sc[2 * np + 1], qf, bf[2], bf[3]);
        ldsm_x4(bf, vt + (np * 16 + mr + (mi >> 1) * 8) * STR + kk * 16 + (mi & 1) * 8);
        mma16816<T>(dp[2 * np], gf, bf[0], bf[1]);
        mma16816<T>(dp[2 * np + 1], gf, bf[2], bf[3]);
      }
    }

    // dS = P ∘ (dP − Dvec), P = exp(scale·S − lse)
    const int kt0 = it * KT;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = visible(row0 + (e >> 1) * 8, kt0 + nt * 8 + 2 * t4 + (e & 1), S,
                                causal, window)
                            ? __expf(sc[nt][e] * scale - lr[e >> 1]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dr[e >> 1]);
      }

    // dQ += dS·K: dS split as in dK/dV, K's B fragments from ldmatrix.trans
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t sh[4], sl[4];
      split2<T>(dp[2 * j][0], dp[2 * j][1], sh[0], sl[0]);
      split2<T>(dp[2 * j][2], dp[2 * j][3], sh[1], sl[1]);
      split2<T>(dp[2 * j + 1][0], dp[2 * j + 1][1], sh[2], sl[2]);
      split2<T>(dp[2 * j + 1][2], dp[2 * j + 1][3], sh[3], sl[3]);
#pragma unroll
      for (int di = 0; di < KST; ++di) {
        uint32_t bf[4];
        ldsm_x4_t(bf, kt + (j * 16 + mr + (mi & 1) * 8) * STR + di * 16 + (mi >> 1) * 8);
        mma16816<T>(dqa[2 * di], sh, bf[0], bf[1]);
        mma16816<T>(dqa[2 * di], sl, bf[0], bf[1]);
        mma16816<T>(dqa[2 * di + 1], sh, bf[2], bf[3]);
        mma16816<T>(dqa[2 * di + 1], sl, bf[2], bf[3]);
      }
    }
    __syncthreads();
  }

  T* dqb = dq + (size_t(b) * S * H + h) * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int s = row0 + rr * 8;
    if (s >= S) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<uint32_t*>(dqb + size_t(s) * q_stride + i * 8 + 2 * t4) =
          pack2(T(), dqa[i][2 * rr] * scale, dqa[i][2 * rr + 1] * scale, nullptr);
  }
}

// f32 backward on the CUDA cores: 32-row tiles, 256 threads; a thread computes 4 scores
// (one row, 4 columns) and owns D/8 output columns of one row, strided by 8.
constexpr int FB = 32;
constexpr int FB_THREADS = 256;

template <int D>
constexpr size_t f32_bwd_smem_bytes() {  // four FB × D tiles, two FB × FB, two FB vectors
  return (size_t(4) * FB * (D + 1) + 2 * FB * (FB + 1) + 2 * FB) * 4;
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dvec,
                   float* __restrict__ dk, float* __restrict__ dv, int S, int H, int KV,
                   int causal, int window, float scale) {
  constexpr int R = D + 1;
  extern __shared__ __align__(16) float sm[];
  float* ks = sm;                      // [FB][R]
  float* vs = ks + FB * R;             // [FB][R]
  float* qs = vs + FB * R;             // [FB][R]  Q·scale
  float* gs = qs + FB * R;             // [FB][R]  dO
  float* ps = gs + FB * R;             // [FB][FB + 1]  Pᵀ (key, query)
  float* ds = ps + FB * (FB + 1);      // [FB][FB + 1]  dSᵀ
  float* ls = ds + FB * (FB + 1);      // [FB]  lse
  float* dl = ls + FB;                 // [FB]  Dvec

  const int tid = threadIdx.x, sr = tid >> 3, sc0 = (tid & 7) * 4, oc = tid & 7;
  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV, G = H / KV;
  const int k0 = blockIdx.y * FB;
  const size_t q_stride = size_t(H) * D, kv_stride = size_t(KV) * D;
  const float* kb = k + (size_t(b) * S * KV + kvh) * D;
  const float* vb = v + (size_t(b) * S * KV + kvh) * D;
  for (int e = tid; e < FB * D; e += FB_THREADS) {
    const int r = e / D, c = e % D, s = k0 + r;
    ks[r * R + c] = s < S ? kb[size_t(s) * kv_stride + c] : 0.f;
    vs[r * R + c] = s < S ? vb[size_t(s) * kv_stride + c] : 0.f;
  }
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(S - 1, k0 + FB - 2 + window) : S - 1;

  float dka[D / 8], dva[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dka[j] = dva[j] = 0.f;
  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    const float* qb = q + (size_t(b) * S * H + h) * D;
    const float* gb = dout + (size_t(b) * S * H + h) * D;
    for (int i = q_lo / FB; i <= q_hi / FB; ++i) {
      const int q0 = i * FB;
      __syncthreads();                 // the last tile's readers are done
      for (int e = tid; e < FB * D; e += FB_THREADS) {
        const int r = e / D, c = e % D, s = q0 + r;
        qs[r * R + c] = s < S ? __fmul_rn(qb[size_t(s) * q_stride + c], scale) : 0.f;
        gs[r * R + c] = s < S ? gb[size_t(s) * q_stride + c] : 0.f;
      }
      if (tid < FB) {
        const size_t at = (size_t(b) * H + h) * S + q0 + tid;
        ls[tid] = q0 + tid < S ? lse[at] : 0.f;
        dl[tid] = q0 + tid < S ? dvec[at] : 0.f;
      }
      __syncthreads();
      float s4[4] = {0.f, 0.f, 0.f, 0.f}, p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = 0; c < D; ++c) {
        const float kc = ks[sr * R + c], vc = vs[sr * R + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s4[j] = fmaf(qs[(sc0 + j) * R + c], kc, s4[j]);
          p4[j] = fmaf(gs[(sc0 + j) * R + c], vc, p4[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cq = sc0 + j;
        const float p = visible(q0 + cq, k0 + sr, S, causal, window) ? expf(s4[j] - ls[cq])
                                                                     : 0.f;
        ps[sr * (FB + 1) + cq] = p;
        ds[sr * (FB + 1) + cq] = p * (p4[j] - dl[cq]);
      }
      __syncthreads();
      for (int cq = 0; cq < FB; ++cq) {
        const float p = ps[sr * (FB + 1) + cq], dsv = ds[sr * (FB + 1) + cq];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          dva[j] = fmaf(p, gs[cq * R + oc + 8 * j], dva[j]);
          dka[j] = fmaf(dsv, qs[cq * R + oc + 8 * j], dka[j]);
        }
      }
    }
  }
  const int s = k0 + sr;
  if (s < S) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const size_t at = (size_t(b) * S * KV + kvh) * D + size_t(s) * kv_stride + oc + 8 * j;
      dk[at] = dka[j];
      dv[at] = dva[j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dvec,
                 float* __restrict__ dq, int S, int H, int KV, int causal, int window,
                 float scale) {
  constexpr int R = D + 1;
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                      // [FB][R]  Q·scale
  float* gs = qs + FB * R;             // [FB][R]  dO
  float* ks = gs + FB * R;             // [FB][R]
  float* vs = ks + FB * R;             // [FB][R]
  float* ds = vs + FB * R;             // [FB][FB + 1]  dS (query, key)

  const int tid = threadIdx.x, sr = tid >> 3, sc0 = (tid & 7) * 4, oc = tid & 7;
  const int q0 = blockIdx.y * FB;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / KV);
  const size_t q_stride = size_t(H) * D, kv_stride = size_t(KV) * D;
  const float* qb = q + (size_t(b) * S * H + h) * D;
  const float* gb = dout + (size_t(b) * S * H + h) * D;
  const float* kb = k + (size_t(b) * S * KV + kvh) * D;
  const float* vb = v + (size_t(b) * S * KV + kvh) * D;
  for (int e = tid; e < FB * D; e += FB_THREADS) {
    const int r = e / D, c = e % D, s = q0 + r;
    qs[r * R + c] = s < S ? __fmul_rn(qb[size_t(s) * q_stride + c], scale) : 0.f;
    gs[r * R + c] = s < S ? gb[size_t(s) * q_stride + c] : 0.f;
  }
  const int pq = q0 + sr;
  const size_t at = (size_t(b) * H + h) * S + pq;
  const float lr = pq < S ? lse[at] : 0.f, dr = pq < S ? dvec[at] : 0.f;

  int t_hi = (S - 1) / FB;
  if (causal) t_hi = min(t_hi, (q0 + FB - 1) / FB);
  int t_lo = 0;
  if (window > 0) {
    const int x = q0 - window - FB + 1;
    if (x >= 0) t_lo = x / FB + 1;
  }
  float dqa[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dqa[j] = 0.f;
  for (int it = t_lo; it <= t_hi; ++it) {
    const int kt0 = it * FB;
    __syncthreads();
    for (int e = tid; e < FB * D; e += FB_THREADS) {
      const int r = e / D, c = e % D, s = kt0 + r;
      ks[r * R + c] = s < S ? kb[size_t(s) * kv_stride + c] : 0.f;
      vs[r * R + c] = s < S ? vb[size_t(s) * kv_stride + c] : 0.f;
    }
    __syncthreads();
    float s4[4] = {0.f, 0.f, 0.f, 0.f}, p4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float qc = qs[sr * R + c], gc = gs[sr * R + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s4[j] = fmaf(qc, ks[(sc0 + j) * R + c], s4[j]);
        p4[j] = fmaf(gc, vs[(sc0 + j) * R + c], p4[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = visible(pq, kt0 + sc0 + j, S, causal, window) ? expf(s4[j] - lr) : 0.f;
      ds[sr * (FB + 1) + sc0 + j] = p * (p4[j] - dr);
    }
    __syncthreads();
    for (int kc = 0; kc < FB; ++kc) {
      const float dsv = ds[sr * (FB + 1) + kc];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) dqa[j] = fmaf(dsv, ks[kc * R + oc + 8 * j], dqa[j]);
    }
  }
  if (pq < S) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) dq[(size_t(b) * S * H + h) * D + size_t(pq) * q_stride +
                                       oc + 8 * j] = dqa[j] * scale;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S, int H,
           int KV, int causal, int window, float scale, cudaStream_t stream) {
  float* lse_f = static_cast<float*>(lse);
  if constexpr (sizeof(T) == 4) {
    constexpr size_t smem = f32_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const dim3 grid((S + BQ - 1) / BQ, B * H);
    flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse_f, S, H, KV, causal, window,
        scale);
  } else {
    constexpr size_t smem = tc_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const dim3 grid(B * H, (S + TC_BQ - 1) / TC_BQ);
    flash_tc_kernel<T, D><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse_f, S, H, KV, causal, window, scale);
  }
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dvec, void* dq, void* dk, void* dv, int B, int S, int H,
               int KV, int causal, int window, float scale, cudaStream_t stream) {
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *gt = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);
  float* df = static_cast<float*>(dvec);
  const long rows = long(B) * S * H;
  flash_bwd_rowdot_kernel<T><<<unsigned((rows * 32 + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(o), gt, df, B, S, H, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return int(e);
  if constexpr (sizeof(T) == 4) {
    constexpr size_t smem = f32_bwd_smem_bytes<D>();
    if ((e = cudaFuncSetAttribute(flash_bwd_dkdv_f32<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))) ||
        (e = cudaFuncSetAttribute(flash_bwd_dq_f32<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem))))
      return int(e);
    const int tiles = (S + FB - 1) / FB;
    flash_bwd_dkdv_f32<D><<<dim3(B * KV, tiles), FB_THREADS, smem, stream>>>(
        qt, kt, vt, gt, lf, df, static_cast<float*>(dk), static_cast<float*>(dv), S, H, KV,
        causal, window, scale);
    if ((e = cudaGetLastError())) return int(e);
    flash_bwd_dq_f32<D><<<dim3(B * H, tiles), FB_THREADS, smem, stream>>>(
        qt, kt, vt, gt, lf, df, static_cast<float*>(dq), S, H, KV, causal, window, scale);
  } else {
    constexpr size_t smem_kv = dkdv_smem_bytes<D>(), smem_q = dq_smem_bytes<D>();
    if ((e = cudaFuncSetAttribute(flash_bwd_dkdv_tc<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_kv))) ||
        (e = cudaFuncSetAttribute(flash_bwd_dq_tc<T, D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem_q))))
      return int(e);
    const int tiles = (S + 63) / 64;
    flash_bwd_dkdv_tc<T, D><<<dim3(B * KV, tiles), TC_THREADS, smem_kv, stream>>>(
        qt, kt, vt, gt, lf, df, static_cast<T*>(dk), static_cast<T*>(dv), S, H, KV, causal,
        window, scale);
    if ((e = cudaGetLastError())) return int(e);
    flash_bwd_dq_tc<T, D><<<dim3(B * H, tiles), TC_THREADS, smem_q, stream>>>(
        qt, kt, vt, gt, lf, df, static_cast<T*>(dq), S, H, KV, causal, window, scale);
  }
  return int(cudaGetLastError());
}

template <typename T>
int by_dim(const void* q, const void* k, const void* v, void* o, void* lse, int B, int S, int H,
           int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, S, H, KV, causal, window, scale, stream);
  }
  return int(cudaErrorInvalidValue);
}

template <typename T>
int bwd_by_dim(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const void* lse, void* dvec, void* dq, void* dk, void* dv, int B, int S, int H,
               int KV, int D, int causal, int window, float scale, cudaStream_t stream) {
#define FLASH_BWD(DD)                                                                       \
  case DD:                                                                                  \
    return launch_bwd<T, DD>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, S, H, KV, causal, \
                             window, scale, stream);
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
// D in {16, 32, 64, 128}; H a multiple of KV; B·H at most 65,535; for the
// 16-bit dtypes q, k and v 16-byte aligned. lse: null, or (B, H, S) f32 that
// receives each row's log-sum-exp of its scaled scores, m + log(max(l, 1e-30)).
extern "C" int flash_attention(const void* q, const void* k, const void* v, int dtype, int B,
                               int S, int H, int KV, int D, int causal, int window,
                               float scale, void* o, void* lse, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_dim<float>(q, k, v, o, lse, B, S, H, KV, D, causal, window, scale, s);
    case 1:
      return by_dim<__nv_bfloat16>(q, k, v, o, lse, B, S, H, KV, D, causal, window, scale, s);
    case 2: return by_dim<__half>(q, k, v, o, lse, B, S, H, KV, D, causal, window, scale, s);
  }
  return int(cudaErrorInvalidValue);
}

// The backward: dq (B, S, H, D), dk and dv (B, S, KV, D) in the inputs' dtype from q, k,
// v, the forward's o and lse (B, H, S) f32, and dout (like o); dvec is (B, H, S) f32
// scratch. Same shapes, dtypes and alignment as flash_attention (o and dout too).
extern "C" int flash_attention_backward(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        int dtype, int B, int S, int H, int KV, int D,
                                        int causal, int window, float scale, void* dvec,
                                        void* dq, void* dk, void* dv, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return bwd_by_dim<float>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, S, H, KV, D,
                               causal, window, scale, s);
    case 1:
      return bwd_by_dim<__nv_bfloat16>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, S, H, KV,
                                       D, causal, window, scale, s);
    case 2:
      return bwd_by_dim<__half>(q, k, v, o, dout, lse, dvec, dq, dk, dv, B, S, H, KV, D,
                                causal, window, scale, s);
  }
  return int(cudaErrorInvalidValue);
}
