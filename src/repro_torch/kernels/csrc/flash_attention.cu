// Block-wise online-softmax attention (flash attention) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention: q (B, S, H, D),
// k, v (B, S, KV, D) in one float dtype → o (B, S, H, D) in that dtype. Head h
// reads KV head h / (H / KV) (GQA). Masks: key position < S; causal: pos_q >=
// pos_k; window > 0: pos_q - pos_k < window. Arithmetic is the Pallas kernel's,
// in f32 throughout: s = (q·scale)·k, m_new = max(m, rowmax s), p = exp(s -
// m_new), corr = exp(m - m_new), l = l·corr + Σp, acc = acc·corr + p·v, and
// o = acc / max(l, 1e-30). Masked scores are the finite -1e30, never -inf: a
// row whose first live tile is fully masked for it takes p = exp(0) = 1 on
// those slots until its first real key makes corr = exp(-1e30 - m) = 0 and
// wipes them, where -inf would give NaN. bf16/fp16 inputs are widened exactly,
// so the result depends on the tile size only through the order of f32 sums.
//
// What bounds it on an H100: operations (4·D flops per unmasked (q, k) pair
// per head against a few bytes per pair). This first version runs them on the
// CUDA cores in f32 (67 TFLOP/s peak), not on the tensor cores: a bf16
// mma.sync for P·V would round P to bf16, which the reference does not.
// Design: grid (ceil(S/64), B·H); a block owns 64 query rows of one head and
// walks the 64-key tiles in order, skipping tiles that no row of the block
// can see (causal and window culling, as the reference does). Q (pre-scaled)
// and Kᵀ are staged transposed in shared memory so that a thread reads 4
// query rows and 4 keys as two float4 per step of d and keeps a 4×4 tile of
// scores in registers; the 16 threads of a half-warp share 4 query rows and
// reduce the row max and sum with shuffles. P goes back to shared memory (in
// Kᵀ's place), and each thread accumulates 4 rows × D/16 output columns.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int kThreads = 256;          // 16 × 16 threads: ty owns 4 rows, tx 4 keys
constexpr int PAD = BQ + 4;            // row stride of Qᵀ, Kᵀ and Pᵀ (floats)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

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
constexpr size_t smem_bytes() {
  return (size_t(D) * PAD + size_t(D > BK ? D : BK) * PAD + size_t(BK) * (D + 4)) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int S, int H, int KV, int causal, int window, float scale) {
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
  const T* qb = q + (size_t(b) * S * H + h) * D;
  const T* kb = k + (size_t(b) * S * KV + kvh) * D;
  const T* vb = v + (size_t(b) * S * KV + kvh) * D;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e % D, s = q0 + r;
    qt[c * PAD + r] = s < S ? __fmul_rn(to_f32(qb[size_t(s) * q_stride + c]), scale) : 0.f;
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
        kv_k = to_f32(kb[size_t(s) * kv_stride + c]);
        kv_v = to_f32(vb[size_t(s) * kv_stride + c]);
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

  T* ob = o + (size_t(b) * S * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      ob[size_t(s) * q_stride + tx * CPT + cc] = from_f32<T>(acc[i][cc] / li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H, int KV,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KV, causal, window, scale);
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
// D in {16, 32, 64, 128}; H a multiple of KV; B·H at most 65,535.
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
