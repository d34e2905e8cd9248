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
                T* __restrict__ o, int S, int H, int KV, int causal, int window, float scale) {
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
                 const float* __restrict__ v, float* __restrict__ o, int S, int H, int KV,
                 int causal, int window, float scale) {
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
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           int causal, int window, float scale, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    constexpr size_t smem = f32_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const dim3 grid((S + BQ - 1) / BQ, B * H);
    flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, KV, causal, window, scale);
  } else {
    constexpr size_t smem = tc_smem_bytes<D>();
    cudaError_t e = cudaFuncSetAttribute(flash_tc_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
    const dim3 grid(B * H, (S + TC_BQ - 1) / TC_BQ);
    flash_tc_kernel<T, D><<<grid, TC_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), S, H, KV, causal, window, scale);
  }
  return int(cudaGetLastError());
}

template <typename T>
int by_dim(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           int D, int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, causal, window, scale, stream);
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and o alike).
// D in {16, 32, 64, 128}; H a multiple of KV; B·H at most 65,535; for the
// 16-bit dtypes q, k and v 16-byte aligned.
extern "C" int flash_attention(const void* q, const void* k, const void* v, int dtype, int B,
                               int S, int H, int KV, int D, int causal, int window,
                               float scale, void* o, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return by_dim<float>(q, k, v, o, B, S, H, KV, D, causal, window, scale, s);
    case 1: return by_dim<__nv_bfloat16>(q, k, v, o, B, S, H, KV, D, causal, window, scale, s);
    case 2: return by_dim<__half>(q, k, v, o, B, S, H, KV, D, causal, window, scale, s);
  }
  return int(cudaErrorInvalidValue);
}
