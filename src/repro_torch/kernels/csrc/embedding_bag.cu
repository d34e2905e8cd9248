// Pooled multi-hot embedding lookup (EmbeddingBag, mode sum) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/embedding_bag.py::embedding_bag. The TPU kernel
// streams the whole table through VMEM tile by tile and, per batch tile, adds
// counts(idx ∈ tile) @ tile on the MXU: O(V·d) bytes per batch tile, which
// pays only because the TPU has no fast scattered reads. It computes
//   out[b] = Σ_p table[idx[b, p]]   over 0 <= idx[b, p] < V,
// in f32: a duplicate index counts each time, a negative index is padding,
// and an index >= V adds nothing (it lands on the zero rows that pad the
// table to a whole tile, or in no tile at all).
//
// What bounds it on an H100: the bytes of the rows the bags touch, the
// indices and the output (a small-vocab table stays in the 50 MB L2, so the
// repeated row reads are L2 traffic). Design: one warp per bag; the warp
// reads the bag's P indices (a broadcast load each) and, for every valid one,
// streams that row with 16-byte loads across its lanes, summing in f32
// registers in index order; the row is never read for a skipped index.
// O(B·P·d) work instead of the TPU's O(B·V·d).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ idx,
                     float* __restrict__ out, int B, int P, int V, int d, int vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;                           // warp-uniform
  const int* bag = idx + size_t(b) * P;
  float* dst = out + size_t(b) * d;
  if (vec) {                                    // rows are whole 16-byte vectors
    constexpr int W = 16 / sizeof(T);
    const int dv = d / W;
    for (int cv = lane; cv < dv; cv += 32) {
      float acc[W];
#pragma unroll
      for (int i = 0; i < W; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        const int id = __ldg(bag + p);
        if (id < 0 || id >= V) continue;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(table + size_t(id) * d) + cv);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < W; ++i) acc[i] += to_f32(vals[i]);
      }
#pragma unroll
      for (int i = 0; i < W; ++i) dst[cv * W + i] = acc[i];
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int p = 0; p < P; ++p) {
        const int id = __ldg(bag + p);
        if (id < 0 || id >= V) continue;
        acc += to_f32(table[size_t(id) * d + c]);
      }
      dst[c] = acc;
    }
  }
}

template <typename T>
int launch(const void* table, const int* idx, float* out, int B, int P, int V, int d,
           int vec, cudaStream_t stream) {
  const int grid = (B + kWarps - 1) / kWarps;
  embedding_bag_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(table), idx,
                                                         out, B, P, V, d, vec);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. table (V, d), idx (B, P) int32
// → out (B, d) float32. vec: 1 when d·sizeof(T) is a multiple of 16 bytes and
// table and out are 16-byte aligned.
extern "C" int embedding_bag(const void* table, int dtype, const void* idx, int B, int P,
                             int V, int d, int vec, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case 0: return launch<float>(table, ix, o, B, P, V, d, vec, s);
    case 1: return launch<__nv_bfloat16>(table, ix, o, B, P, V, d, vec, s);
    case 2: return launch<__half>(table, ix, o, B, P, V, d, vec, s);
  }
  return int(cudaErrorInvalidValue);
}
