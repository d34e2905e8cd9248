// DLRM pairwise-dot feature interaction for Hopper (sm_90a).
//
// Replaces src/repro/kernels/dot_interaction.py::dot_interaction, whose Pallas
// kernel writes the batched Gram matrix X·Xᵀ (f32 accumulation, stored in the
// input's dtype) and leaves the upper-triangle compaction to XLA. This kernel
// writes the triangle directly: out[b, p] = round(Σ_c x[b,i,c]·x[b,j,c]) for
// the p-th pair (i < j) in np.triu_indices(F, k=1) order (row-major), summed
// in f32 along c in order and rounded once to the input's dtype. No TF32.
//
// What bounds it on an H100: the bytes of X (F·d values per row; 27×128 f32
// is 13.8 KB) and of the output; it does F(F-1)/2·2d flops per row, about 6.5
// per input byte at f32, so the FMAs must keep pace with HBM. Design:
// * Register-blocked pairs. F is padded up to Fp, a multiple of 4, and cut
//   into 4-feature blocks; a thread owns one (i-block ≤ j-block) tile of 4×4
//   pairs of one batch row (28 tiles for F 27) and keeps its 16 sums in
//   registers. Per 16 bytes of d it reads 4 + 4 vectors from shared memory
//   and runs 16 FMAs per element pair: one 16-byte shared load per 8 FMAs in
//   f32, four times fewer than one pair per thread. It writes only the
//   i < j < F entries.
// * Conflict-free layout. A stage holds `rows` batch rows × Fp features × one
//   128-byte chunk of d, in the input's own dtype; rows are `row_elems` apart,
//   which is 16 bytes past a multiple of 128, and threads take consecutive
//   rows first, so the 8 threads of a quarter-warp read 8 distinct 16-byte
//   bank groups. bf16 and fp16 values are widened exactly as they are read
//   (the same numbers as widening them when staged).
// * Overlapped loads. Stages are filled by cp.async 16-byte copies in a
//   double buffer: a block walks its (group of rows, chunk of d) steps and
//   copies step s+1 while it computes step s. A thread walks its copies with
//   carrying counters: integer divisions per copy cost as much as the FMAs.
//   The grid is the blocks the card holds at once (the occupancy API); each
//   block strides over groups of rows. When
//   d·sizeof(T) is not a multiple of 16 (or x is not 16-byte aligned) the
//   stage is filled by plain loads and read one element at a time.
// The launch shape (rows, threads, row_elems, shared bytes) comes from
// kernels/dot_interaction.py::launch_shape. The backward, a kernel of its own
// design (TMA bulk copies into a ring), is described where it is defined.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kStages = 2;                     // the cp.async ring: a double buffer

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

// 16 bytes of shared memory → 16 / sizeof(T) floats
template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[16 / sizeof(T)]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < int(16 / sizeof(T)); ++i) o[i] = to_f32(vals[i]);
}

// Step s of a block's walk (its row group s / n_chunks, chunk s % n_chunks of d) → dst:
// `rows` batch rows × F features × one 128-byte chunk, rows row_elems apart, features DC
// apart; rows at or past B are not copied. A thread's copies e = tid, tid + nthr, ... split
// into (row rr, feature f, piece p) by counters that carry instead of dividing per copy.
// One commit group per call.
template <typename T, bool VEC>
__device__ __forceinline__ void stage_step(const T* __restrict__ x, T* dst, int s, int B, int F,
                                           int d, int rows, int n_chunks, int row_elems) {
  constexpr int DC = 128 / sizeof(T);
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int b0 = (blockIdx.x + (s / n_chunks) * gridDim.x) * rows;
  const int c0 = (s % n_chunks) * DC, cn = min(DC, d - c0);
  const int w = VEC ? V : 1, pieces = cn / w, total = rows * F * pieces;
  const int dp = nthr % pieces, df = (nthr / pieces) % F, dr = nthr / pieces / F;
  int p = tid % pieces, f = (tid / pieces) % F, rr = tid / pieces / F;
  const T* src = x + size_t(b0) * F * d + c0;
  for (int e = tid; e < total; e += nthr) {
    if (b0 + rr < B) {
      if constexpr (VEC) {
        cp_async16(dst + rr * row_elems + f * DC + p * V, src + (rr * F + f) * d + p * V);
      } else {
        dst[rr * row_elems + f * DC + p] = src[(rr * F + f) * d + p];
      }
    }
    p += dp;
    int carry = p >= pieces;
    p -= carry ? pieces : 0;
    f += df + carry;
    carry = f >= F;
    f -= carry ? F : 0;
    rr += dr + carry;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dot_interaction_kernel(const T* __restrict__ x, T* __restrict__ out, int B, int F, int d,
                       int rows, int row_elems) {
  constexpr int DC = 128 / sizeof(T);          // elements of d per chunk
  constexpr int V = 16 / sizeof(T);            // elements per 16-byte piece
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const stages = reinterpret_cast<T*>(smem_raw);      // kStages × rows × row_elems
  const int stage_elems = rows * row_elems;

  const int nb = (F + 3) / 4, n_tiles = nb * (nb + 1) / 2, n_pairs = F * (F - 1) / 2;
  const int tid = threadIdx.x;
  const bool active = tid < rows * n_tiles;
  const int r = tid % rows;
  int ib = 0, jb = 0;
  if (active) {                                // tile t → (ib ≤ jb), row-major
    int t = tid / rows;
    while (t >= nb - ib) { t -= nb - ib; ++ib; }
    jb = ib + t;
  }

  const int bx = blockIdx.x, gx = gridDim.x;
  const int n_groups = (B + rows - 1) / rows, n_chunks = (d + DC - 1) / DC;
  if (bx >= n_groups) return;
  const int n_steps = ((n_groups - 1 - bx) / gx + 1) * n_chunks;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {      // one commit group per step
    if (s < n_steps) stage_step<T, VEC>(x, stages + s * stage_elems, s, B, F, d, rows, n_chunks,
                                        row_elems);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int s = 0; s < n_steps; ++s) {
    const int ahead = s + kStages - 1;
    if (ahead < n_steps)
      stage_step<T, VEC>(x, stages + (ahead % kStages) * stage_elems, ahead, B, F, d, rows,
                         n_chunks, row_elems);
    else asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
    __syncthreads();
    const int c0 = (s % n_chunks) * DC, cn = min(DC, d - c0);
    if (active) {
      const T* st = stages + (s % kStages) * stage_elems;
      const T* xi = st + r * row_elems + 4 * ib * DC;
      const T* xj = st + r * row_elems + 4 * jb * DC;
      if constexpr (VEC) {
        for (int c = 0; c < cn; c += V) {
          float a[4][V], bq[4][V];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) load_vec<T>(xi + ii * DC + c, a[ii]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) load_vec<T>(xj + jj * DC + c, bq[jj]);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int cc = 0; cc < V; ++cc) acc[ii][jj] = fmaf(a[ii][cc], bq[jj][cc], acc[ii][jj]);
        }
      } else {
        for (int c = 0; c < cn; ++c) {
          float a[4], bq[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) a[ii] = to_f32(xi[ii * DC + c]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) bq[jj] = to_f32(xj[jj * DC + c]);
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = fmaf(a[ii], bq[jj], acc[ii][jj]);
        }
      }
    }
    if (s % n_chunks == n_chunks - 1) {        // the group's last chunk: write, reset
      const int b = (bx + (s / n_chunks) * gx) * rows + r;
      if (active && b < B) {
        T* ob = out + size_t(b) * n_pairs;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int i = 4 * ib + ii;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * jb + jj;
            if (i < j && j < F) ob[i * F - i * (i + 1) / 2 + j - i - 1] = from_f32<T>(acc[ii][jj]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
    }
    __syncthreads();                           // this stage is free for a later step
  }
}

// 16 / sizeof(T) floats → 16 bytes of T at p, each rounded once
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[16 / sizeof(T)]) {
  uint4 raw;
  T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < int(16 / sizeof(T)); ++i) vals[i] = from_f32<T>(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// ---------------------------------------------------------------------------
// The backward: dX[b] = Gsym[b]·X[b], Gsym[i][j] = Gsym[j][i] = g[b, pair(i, j)] for i < j,
// zero on the diagonal.
//
// Bound by bytes (X read, dX written, g read), at 6.4 flops per byte of X in f32. A block
// is persistent and walks units (row b, chunk of d): the whole row when Fp·d fits a stage
// (27 × 128 f32 is 13.8 KB). One thread keeps a ring of `stages` units of X in flight with
// TMA bulk copies (one per unit when the chunk is all of d, else one per feature), each
// completing on the stage's mbarrier: about 40 KB ahead of the block's compute at F 27,
// d 128. The next unit's g row is copied by cp.async (4-byte words) while this unit
// computes, then expanded into Gsym (Fp × Fp floats, a pair table of (i, j) built once).
// An item is (4-feature block, 16-byte piece of the chunk): it sums Σ_j Gsym[i][j]·x[j][c]
// over j in order for its 4 features × 16 bytes in f32 registers (Gsym read 4 j at a time
// as float4, one broadcast per warp) and rounds each once; consecutive threads take
// consecutive pieces, so a warp reads and writes 512 contiguous bytes of a feature row.
// Stage rows F..Fp-1 and Gsym's diagonal are zero, written once. Without vec (d·sizeof(T)
// not a multiple of 16, or x unaligned) the threads copy each unit with plain loads.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// the backward's shared memory: the ring, Gsym, the staged g row, the pair table, barriers
// (kernels/dot_interaction.py::backward_launch_shape computes the same)
__host__ __device__ inline size_t backward_smem_bytes(int F, int chunk, int stages, int size) {
  const int fp = (F + 3) / 4 * 4, n_pairs = F * (F - 1) / 2;
  return align16(size_t(stages) * fp * chunk * size) + size_t(fp) * fp * 4 +
         align16(size_t(n_pairs) * size + 4) + align16(size_t(n_pairs) * 4) + 8 * size_t(stages);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dot_interaction_backward_kernel(const T* __restrict__ x, const T* __restrict__ grad,
                                T* __restrict__ dx, int B, int F, int d, int chunk, int stages) {
  constexpr int W = VEC ? 16 / sizeof(T) : 1;  // elements of d per item
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nb = (F + 3) / 4, fp = 4 * nb, n_pairs = F * (F - 1) / 2;
  T* const ring = reinterpret_cast<T*>(smem_raw);                 // stages × fp × chunk
  float* const gsym = reinterpret_cast<float*>(smem_raw + align16(size_t(stages) * fp * chunk *
                                                                  sizeof(T)));  // fp × fp
  uint32_t* const gword = reinterpret_cast<uint32_t*>(gsym + fp * fp);    // the next g row
  int* const pairs = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(gword) +
                                            align16(size_t(n_pairs) * sizeof(T) + 4));
  uint64_t* const full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(pairs) +
                                                     align16(size_t(n_pairs) * 4));

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int n_chunks = (d + chunk - 1) / chunk;
  const long units = long(B) * n_chunks;
  if (blockIdx.x >= units) return;
  const int n_mine = int((units - 1 - blockIdx.x) / gridDim.x + 1);
  auto unit_of = [&](int k, int& b, int& c0) {
    const long u = blockIdx.x + long(k) * gridDim.x;
    b = int(u / n_chunks);
    c0 = int(u % n_chunks) * chunk;
  };

  for (int e = tid; e < stages * (fp - F) * chunk; e += nthr) {
    const int st = e / ((fp - F) * chunk), r = e % ((fp - F) * chunk);
    ring[size_t(st) * fp * chunk + F * chunk + r] = from_f32<T>(0.f);
  }
  for (int e = tid; e < fp * fp; e += nthr) gsym[e] = 0.f;
  for (int i = tid; i < F; i += nthr)                          // row i's pairs (i, j > i)
    for (int j = i + 1; j < F; ++j) pairs[i * F - i * (i + 1) / 2 + j - i - 1] = i << 16 | j;
  if (VEC && tid == 0) {
    for (int st = 0; st < stages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(full + st))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // unit k's X → stage k % stages (one thread), completing on its barrier
  auto load_x = [&](int k) {
    int b, c0;
    unit_of(k, b, c0);
    const int cn = min(chunk, d - c0), st = k % stages;
    T* dst = ring + size_t(st) * fp * chunk;
    const T* src = x + size_t(b) * F * d + c0;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(full + st)), "r"(uint32_t(F * cn * sizeof(T))) : "memory");
    if (chunk == d) {
      bulk_load(dst, src, F * cn * sizeof(T), full + st);
    } else {
      for (int f = 0; f < F; ++f)
        bulk_load(dst + f * chunk, src + size_t(f) * d, cn * sizeof(T), full + st);
    }
  };
  // unit k's g row → gword, as the 4-byte words that cover it (cp.async, one commit group);
  // a 16-bit g of odd length ends in half a word, read alone with a 2-byte load
  const size_t g_bytes = size_t(B) * n_pairs * sizeof(T);
  auto stage_g = [&](int k) {
    int b, c0;
    unit_of(k, b, c0);
    const size_t e0 = size_t(b) * n_pairs, w0 = e0 * sizeof(T) / 4;
    const int n_words = int(((e0 + n_pairs) * sizeof(T) + 3) / 4 - w0);
    const uint32_t* src = reinterpret_cast<const uint32_t*>(grad) + w0;
    for (int w = tid; w < n_words; w += nthr) {
      if ((w0 + w + 1) * 4 <= g_bytes)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(smem_u32(gword + w)), "l"(src + w) : "memory");
      else
        gword[w] = *reinterpret_cast<const uint16_t*>(src + w);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto expand_g = [&](int k) {                                 // gword → Gsym (both halves)
    int b, c0;
    unit_of(k, b, c0);
    const int off = int((size_t(b) * n_pairs) % (4 / sizeof(T)));
    const T* gv = reinterpret_cast<const T*>(gword) + off;
    for (int p = tid; p < n_pairs; p += nthr) {
      const int ij = pairs[p], i = ij >> 16, j = ij & 0xffff;
      const float val = to_f32(gv[p]);
      gsym[i * fp + j] = val;
      gsym[j * fp + i] = val;
    }
  };

  __syncthreads();                                 // pads, Gsym zeros, pairs, barriers
  if (VEC && tid == 0)
    for (int k = 0; k < stages - 1 && k < n_mine; ++k) load_x(k);
  stage_g(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  expand_g(0);
  __syncthreads();

  for (int k = 0; k < n_mine; ++k) {
    int b, c0;
    unit_of(k, b, c0);
    const int cn = min(chunk, d - c0), st = k % stages;
    T* const xs = ring + size_t(st) * fp * chunk;
    if (VEC && tid == 0 && k + stages - 1 < n_mine) load_x(k + stages - 1);
    if (k + 1 < n_mine) stage_g(k + 1);
    if constexpr (VEC) {
      mbar_wait(full + st, (k / stages) & 1);
    } else {
      for (int e = tid; e < F * cn; e += nthr) {
        const int f = e / cn, c = e % cn;
        xs[f * chunk + c] = x[(size_t(b) * F + f) * d + c0 + c];
      }
      __syncthreads();
    }
    const int pieces = (cn + W - 1) / W;
    for (int item = tid; item < nb * pieces; item += nthr) {
      const int piece = item % pieces, ib = item / pieces;
      const float* gr = gsym + 4 * ib * fp;
      const T* xr = xs + piece * W;
      float acc[4][W];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[ii][w] = 0.f;
      for (int j4 = 0; j4 < fp; j4 += 4) {
        float4 g4[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) g4[ii] = *reinterpret_cast<const float4*>(gr + ii * fp + j4);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float xv[W];
          if constexpr (VEC) {
            load_vec<T>(xr + (j4 + jj) * chunk, xv);
          } else {
            xv[0] = to_f32(xr[(j4 + jj) * chunk]);
          }
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
            const float gv = jj == 0   ? g4[ii].x
                             : jj == 1 ? g4[ii].y
                             : jj == 2 ? g4[ii].z
                                       : g4[ii].w;
#pragma unroll
            for (int w = 0; w < W; ++w) acc[ii][w] = fmaf(gv, xv[w], acc[ii][w]);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int i = 4 * ib + ii;
        if (i >= F) break;
        T* out = dx + (size_t(b) * F + i) * d + c0 + piece * W;
        if constexpr (VEC) {
          store_vec<T>(out, acc[ii]);
        } else {
          out[0] = from_f32<T>(acc[ii][0]);
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();                               // stage st and Gsym are free; g row landed
    if (k + 1 < n_mine) {
      expand_g(k + 1);
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const void* x, void* out, int B, int F, int d, int rows, int row_elems, int threads,
           int smem, int vec, cudaStream_t stream) {
  if (threads > kMaxThreads || size_t(smem) < size_t(kStages) * rows * row_elems * sizeof(T))
    return int(cudaErrorInvalidValue);
  auto kern = vec ? dot_interaction_kernel<T, true> : dot_interaction_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int occ = 0, dev = 0, n_sm = 0;              // grid: the blocks the card holds at once
  if (e || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, smem)) ||
      (e = cudaGetDevice(&dev)) ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)))
    return int(e);
  const int grid = min((B + rows - 1) / rows, max(occ, 1) * n_sm);
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(out), B, F,
                                        d, rows, row_elems);
  return int(cudaGetLastError());
}

template <typename T>
int launch_backward(const void* x, const void* grad, void* dx, int B, int F, int d, int chunk,
                    int stages, int threads, int smem, int vec, cudaStream_t stream) {
  if (threads > kMaxThreads || stages < 2 || chunk < 1 || chunk > d ||
      (vec && chunk != d && chunk % (16 / sizeof(T))) ||
      size_t(smem) < backward_smem_bytes(F, chunk, stages, sizeof(T)))
    return int(cudaErrorInvalidValue);
  auto kern = vec ? dot_interaction_backward_kernel<T, true>
                  : dot_interaction_backward_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int occ = 0, dev = 0, n_sm = 0;              // grid: the blocks the card holds at once
  if (e || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, smem)) ||
      (e = cudaGetDevice(&dev)) ||
      (e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)))
    return int(e);
  const long units = long(B) * ((d + chunk - 1) / chunk);
  const int grid = int(units < long(max(occ, 1)) * n_sm ? units : long(max(occ, 1)) * n_sm);
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(grad),
                                        static_cast<T*>(dx), B, F, d, chunk, stages);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. x (B, F, d) → out (B, F(F-1)/2).
// rows, row_elems, threads (≤ 256) and smem (≥ 2 stages) from launch_shape;
// vec: 1 when d·sizeof(T) is a multiple of 16 bytes and x is 16-byte aligned.
extern "C" int dot_interaction(const void* x, int dtype, int B, int F, int d, int rows,
                               int row_elems, int threads, int smem, int vec, void* out,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, out, B, F, d, rows, row_elems, threads, smem, vec, s);
    case 1: return launch<__nv_bfloat16>(x, out, B, F, d, rows, row_elems, threads, smem, vec, s);
    case 2: return launch<__half>(x, out, B, F, d, rows, row_elems, threads, smem, vec, s);
  }
  return int(cudaErrorInvalidValue);
}

// The backward of dot_interaction: grad (B, F(F-1)/2) and x (B, F, d) in one dtype → dx
// (B, F, d) in it. chunk (elements of d a stage holds: d, or a multiple of 16 bytes with vec),
// stages (≥ 2), threads (≤ 256) and smem (backward_smem_bytes) from backward_launch_shape;
// vec as for the forward (x and dx 16-byte aligned).
extern "C" int dot_interaction_backward(const void* x, const void* grad, int dtype, int B, int F,
                                        int d, int chunk, int stages, int threads, int smem,
                                        int vec, void* dx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_backward<float>(x, grad, dx, B, F, d, chunk, stages, threads, smem, vec, s);
    case 1:
      return launch_backward<__nv_bfloat16>(x, grad, dx, B, F, d, chunk, stages, threads, smem,
                                            vec, s);
    case 2:
      return launch_backward<__half>(x, grad, dx, B, F, d, chunk, stages, threads, smem, vec, s);
  }
  return int(cudaErrorInvalidValue);
}
