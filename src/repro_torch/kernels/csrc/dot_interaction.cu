// DLRM pairwise-dot feature interaction for Hopper (sm_90a).
//
// Replaces src/repro/kernels/dot_interaction.py::dot_interaction, whose Pallas
// kernel writes the batched Gram matrix X·Xᵀ (f32 accumulation, stored in the
// input's dtype) and leaves the upper-triangle compaction to XLA. This kernel
// writes the triangle directly: out[b, p] = round(Σ_c x[b,i,c]·x[b,j,c]) for
// the p-th pair (i < j) in np.triu_indices(F, k=1) order (row-major), summed
// in f32 and rounded once to the input's dtype.
//
// What bounds it on an H100: the bytes of X (F·d values per row; 27×128 f32
// is 13.8 KB) and of the output; it does F(F-1)/2·2d flops per row, about 6.5
// per input byte at f32. Design: a block stages `rows` batch rows in shared
// memory as f32 (16-byte loads where the row allows), with a row stride of
// d + 1 floats so the threads of a warp, which read consecutive rows j, hit
// distinct banks; then each thread owns whole pairs and sums along d with
// f32 FMAs. Simple, not register-blocked: two shared loads per FMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_interaction_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int F, int d,
                       int rows, int vec) {
  extern __shared__ float xs[];                 // rows × F × (d + 1) floats
  const int stride = d + 1;
  const int b0 = blockIdx.x * rows;
  const int nrows = min(rows, B - b0);
  const int n_el = nrows * F * d;
  const T* src = x + size_t(b0) * F * d;
  if (vec) {                                    // d % V == 0: a vector stays in its row
    constexpr int V = 16 / sizeof(T);
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    for (int e = threadIdx.x; e < n_el / V; e += kThreads) {
      const uint4 raw = __ldg(src4 + e);
      const T* vals = reinterpret_cast<const T*>(&raw);
      const int row = (e * V) / d, c = (e * V) - row * d;
#pragma unroll
      for (int i = 0; i < V; ++i) xs[row * stride + c + i] = to_f32(vals[i]);
    }
  } else {
    for (int e = threadIdx.x; e < n_el; e += kThreads) {
      const int row = e / d, c = e - row * d;
      xs[row * stride + c] = to_f32(src[e]);
    }
  }
  __syncthreads();
  const int n_pairs = F * (F - 1) / 2;
  for (int e = threadIdx.x; e < nrows * n_pairs; e += kThreads) {
    const int r = e / n_pairs, p0 = e - r * n_pairs;
    int i = 0, p = p0;
    while (p >= F - 1 - i) { p -= F - 1 - i; ++i; }   // row-major triu order
    const int j = i + 1 + p;
    const float* xi = xs + (r * F + i) * stride;
    const float* xj = xs + (r * F + j) * stride;
    float acc = 0.f;
#pragma unroll 8
    for (int c = 0; c < d; ++c) acc = fmaf(xi[c], xj[c], acc);
    out[size_t(b0 + r) * n_pairs + p0] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int F, int d, int rows, int vec,
           cudaStream_t stream) {
  const size_t smem = size_t(rows) * F * (d + 1) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(dot_interaction_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const int grid = (B + rows - 1) / rows;
  dot_interaction_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), B, F, d, rows, vec);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. x (B, F, d) → out (B, F(F-1)/2).
// rows: batch rows per block (the wrapper sizes it to the shared memory);
// vec: 1 when d·sizeof(T) is a multiple of 16 bytes and x is 16-byte aligned.
extern "C" int dot_interaction(const void* x, int dtype, int B, int F, int d, int rows,
                               int vec, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, out, B, F, d, rows, vec, s);
    case 1: return launch<__nv_bfloat16>(x, out, B, F, d, rows, vec, s);
    case 2: return launch<__half>(x, out, B, F, d, rows, vec, s);
  }
  return int(cudaErrorInvalidValue);
}
