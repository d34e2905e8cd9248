// Fused spatio-textual score + running top-k for Hopper (sm_90a).
//
// Replaces the three Pallas kernels in src/repro/kernels/fused_topk_score.py:
//   fts_routed         <- fused_topk_score_routed          (query-major, :314)
//   fts_cluster_major  <- fused_topk_score_cluster_major   (cluster-major, :509)
//   fts_gather         <- fused_topk_score                 (gather path, :173)
//
// All compute, for a query q and a resident object o of a routed cluster,
//   ST = w0 * (q . o) + w1 * w_hat[clip(int(S_in * t), 0, t - 1)],
//   S_in = 1 - clip(|q_loc - o_loc| / dist_max, 0, 1),
// skip padding rows (id < 0) and rows failing the filter predicate (the
// reference scores them NEG_INF with id -1, which is exactly what an unfilled
// output slot holds), and keep the top k by (score desc, scan position asc):
// the order jax.lax.top_k gives over the reference's [running list, tile]
// concatenation, so ids are deterministic. The scan position is route * cap +
// row (routed), the row (cluster-major: one list per (query, route) pair) or
// the local position in the query's candidate copy (gather).
//
// The engine scans (routed, cluster-major): one Hopper kernel, engine_scan_kernel.
// - What bounds them on an H100 is the bytes of the distinct routed clusters'
//   live rows, read once for every group of up to G (query, route) pairs routed
//   to the cluster (G = 16 at d 768 and k 20, 32 at narrow rows; fewer as k grows:
//   launch_shape). The products go to the tensor cores (wgmma).
// - Work items are (cluster, 1024-row chunk, slot group of G pairs),
//   built on the device: cluster-major from the host plan's roster; routed by a
//   counting sort of the batch's B * cr (query, route) pairs by cluster inside the
//   launch (a histogram, a prefix sum, a scatter: no host sync, no plan), so a
//   (cluster, chunk) is read once per slot group, not once per query group. Pair p
//   keeps its scan position (p % cr) * cap + row and its partial rows, so the
//   (B, k) output and the tie order are what the query-major scan gave. A
//   pre-pass (items_kernel) writes each item's record: its chunk's mask of live
//   64-row tiles (a tile that is all padding is never fetched) and its slots' pairs.
// - A persistent block is one producer warp and two consumer warpgroups (one where
//   two do not fit: the largest k). The producer takes items from an atomic
//   counter, reading the next item's record under the current item's loads, and
//   streams the live tiles' rows by TMA (one tensor map over the buffers viewed as
//   (c * cap, d) in their stored type, 128-byte swizzle), live tile j to
//   warpgroup j % 2, each through its own ring of 64 rows x 128 bytes stages
//   with full and empty mbarriers. Each warpgroup computes its tiles' 64 x 3N
//   products with wgmma (the next stage's A read while up to DEPTH stages' groups
//   are in flight), scores them and keeps its own top-k lists, so one
//   warpgroup's scoring runs under the other's products and loads; B and the
//   item's setup are shared, and each warpgroup writes its own partial lists.
// - The products: each query is split once per launch into three bf16 terms,
//   q = q_hi + q_mid + q_lo (each the rounded residue of the last; what is left
//   is below 2^-24 |q|), written in the order the products read them, and staged
//   per item in shared memory as wgmma's B, the three terms of N slots side by side
//   (3N columns, one wgmma a k-step and row term). bf16 rows are A in shared memory (the TMA
//   stage itself); int8 rows are widened to bf16 in registers (every int8 is exact
//   in bf16) and f32 rows split into three bf16 terms as q is (2^-24 |o| left: an
//   f32 row's own precision), both used as A from registers, with the stage's k
//   order permuted so that a thread reads its A fragment as two 16-byte pieces per
//   row (split_q_kernel applies the same permutation to q). Products of bf16 terms
//   are exact in f32; each query term sums in its own f32 column and the three are
//   added as (hi + mid) + lo, so the dot product differs from the plain version's
//   by its order and by the terms' residues, 2^-24 |q|.|o| each; int8 rows take the
//   row scale once per (row, slot), after the sum: one rounding away from the
//   reference's element-wise float(o) * scale. Exact integer data give exact sums.
// - Top-k: a key beating its slot's k-th key enters the slot's candidate buffer;
//   after each tile a warpgroup merges its buffers into its sorted lists by rank,
//   over all its slots at once, eight candidates compared a round.
// - Each item writes one sorted partial list per slot, chunk and warpgroup; the
//   merge kernel (a warp per output row) folds them by key into (B, k) (routed) or
//   (B * cr, k) pairs (cluster-major, folded by engine.merge_cluster_major).
//
// The gather scan (fts_gather) keeps the tiled CUDA-core body: one query's candidate
// copy per item, one slot, rows widened on the FP32 CUDA cores through a cp.async
// double buffer; it reads each row once for one query, so it is bound by bytes.
//
// Numerics: the spatial bucket uses IEEE sqrt and division with explicit _rn
// intrinsics (no contraction, no fast-math), so S_in, the bucket and w1 * srel are
// bit-identical to the reference.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// ---- keys -----------------------------------------------------------------

__device__ __forceinline__ uint32_t order_bits(float f) {
  if (f == 0.0f) f = 0.0f;           // -0 and +0 compare equal: one key
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// larger key = better: score descending, then scan position ascending.
// 0 is the empty slot (below every real key).
__device__ __forceinline__ uint64_t make_key(float s, uint32_t pos) {
  return (uint64_t(order_bits(s)) << 32) | uint64_t(0xffffffffu - pos);
}

__device__ __forceinline__ float key_score(uint64_t key) {
  return from_order_bits(uint32_t(key >> 32));
}

__device__ __forceinline__ uint32_t key_pos(uint64_t key) {
  return 0xffffffffu - uint32_t(key);
}

// ---- row loads --------------------------------------------------------------

template <typename T> struct Row;      // 16-byte vector = V elements

template <> struct Row<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& r, float (&v)[4]) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
};

template <> struct Row<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& r, float (&v)[8]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// float(b) exactly, without a conversion instruction: byte b ^ 0x80 = b + 128
// becomes the mantissa of 2^23 + b + 128, and 2^23 + 128 is subtracted.
__device__ __forceinline__ float i8_to_f32(uint32_t w_xor, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(w_xor, 0x4B000000u, 0x7440u | j)), 8388736.f);
}

template <> struct Row<int8_t> {
  static constexpr int V = 16;
  __device__ static void unpack(const uint4& r, float (&v)[16]) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                           r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * i + j] = i8_to_f32(w[i], j);
  }
};


// ---- score terms ------------------------------------------------------------

// w1 * w_hat[bucket]: the spatial half of ST, bit-identical to the reference
__device__ __forceinline__ float spatial_term(float qx, float qy, float ox, float oy,
                                              float w1, float dist_max, int t,
                                              const float* __restrict__ w_hat) {
  const float dx = __fsub_rn(qx, ox), dy = __fsub_rn(qy, oy);
  const float dist = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  const float sd = fminf(fmaxf(__fdiv_rn(dist, dist_max), 0.f), 1.f);
  const float s_in = __fsub_rn(1.f, sd);
  int idx = int(__fmul_rn(s_in, float(t)));        // truncation, like astype(int32)
  idx = min(max(idx, 0), t - 1);
  return __fmul_rn(w1, __ldg(w_hat + idx));
}

__device__ __forceinline__ bool passes3(int tenant, int cat, int ts, int4 f) {
  return (f.x < 0 || tenant == f.x) && (f.y == 0 || (cat & f.y) != 0) && ts >= f.z &&
         ts <= f.w;
}

struct ScanArgs {
  const float* q; const float* q_loc; const float* w; const void* emb;
  const float* scale; const float* loc; const int* ids; const int* attrs;
  const int* q_filt; const float* w_hat;
  int cap, d, t, k, chunk_rows, slots;
  float dist_max;
  uint64_t* part_key; int* part_id;
};

// an empty partial list (a route to no cluster): keys 0, ids -1
__device__ __forceinline__ void write_empty(const ScanArgs& a, long long out_row, int tid,
                                            int nthreads) {
  for (int e = tid; e < a.k; e += nthreads) {
    a.part_key[out_row * a.k + e] = 0;
    a.part_id[out_row * a.k + e] = -1;
  }
}

// ---- the gather scan (the tiled CUDA-core body) --------------------------------
//
// A work item scores rows [r0, r0 + nrows) of one query's candidate copy (one
// chunk) in one slot and writes its sorted partial list of k keys to part_key row
// `out`. Thread t owns row t of every 256-row tile; rows travel in their stored
// type through a cp.async double buffer of 256 rows x 128 bytes (+ the query's
// floats for those 128 bytes) and are widened in registers.

constexpr int kTile = 256;                   // rows per tile: one row per thread
constexpr int kChunkBytes = 128;             // bytes of each row one stage holds
constexpr int kStages = 2;                   // the cp.async ring
constexpr int kCandCap = kTile / 2;          // candidates the slot takes per half tile
constexpr int kGroup = 16;                   // per-slot fields of the layout
static_assert(kThreads == kTile, "one thread per row of a tile");

// Shared-memory layout, in bytes (mirrored by gather_launch_shape in
// kernels/fused_topk_score.py, which passes the total; the launcher checks it).
// A stage holds 256 rows x 128 bytes, 16-byte piece s of row r at piece
// s ^ (r & 7), then the query's floats for the same 128 bytes of the row.
struct TileSmem {
  size_t stage, ids, tiles, cand, lists, thresh, out, par, filt, ints, total;
};

__host__ __device__ inline TileSmem tile_smem(int chunk_rows, int k, int kce, int G) {
  TileSmem s;
  s.stage = align16(size_t(kTile) * kChunkBytes + size_t(G) * kce * 4);
  size_t off = s.stage * kStages;
  s.ids = off;    off += align16(size_t(chunk_rows) * 4);
  s.tiles = off;  off += align16(size_t(chunk_rows / kTile + 1) * 4);
  s.cand = off;   off += size_t(G) * kCandCap * 8;
  s.lists = off;  off += 2 * size_t(G) * k * 8;
  s.thresh = off; off += size_t(kGroup) * 8;
  s.out = off;    off += size_t(kGroup) * 8;
  s.par = off;    off += size_t(kGroup) * 16;
  s.filt = off;   off += size_t(kGroup) * 16;
  s.ints = off;   off += size_t(kGroup) * 5 * 4;     // q, nreal, sel, cand_n, pos
  s.total = off;
  return s;
}

struct Slots {                                // views of an item's shared memory
  int* ids; int* tiles; uint64_t* cand; uint64_t* lists; uint64_t* thresh;
  long long* out; float4* par; int* q; int* nreal; int* sel; int* cand_n; int* pos;
  __device__ Slots(unsigned char* smem, const TileSmem& L)
      : ids(reinterpret_cast<int*>(smem + L.ids)),
        tiles(reinterpret_cast<int*>(smem + L.tiles)),
        cand(reinterpret_cast<uint64_t*>(smem + L.cand)),
        lists(reinterpret_cast<uint64_t*>(smem + L.lists)),
        thresh(reinterpret_cast<uint64_t*>(smem + L.thresh)),
        out(reinterpret_cast<long long*>(smem + L.out)),
        par(reinterpret_cast<float4*>(smem + L.par)),
        q(reinterpret_cast<int*>(smem + L.ints)), nreal(q + kGroup), sel(q + 2 * kGroup),
        cand_n(q + 3 * kGroup), pos(q + 4 * kGroup) {}
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc += q . row(tid) over one stage (nsteps 16-byte pieces of the row)
template <typename T, bool DQ>
__device__ __forceinline__ void tile_dot(const unsigned char* rs, const float* qs, int nsteps,
                                         int tid, float sc, float& acc) {
  constexpr int V = Row<T>::V;
  const unsigned char* row = rs + tid * kChunkBytes;
  for (int ks = 0; ks < nsteps; ++ks) {
    float v[V];
    Row<T>::unpack(*reinterpret_cast<const uint4*>(row + ((ks ^ (tid & 7)) << 4)), v);
    if (DQ) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = __fmul_rn(v[e], sc);
    }
    const float* qrow = qs + ks * V;
#pragma unroll
    for (int e4 = 0; e4 < V / 4; ++e4) {
      const float4 qq = *reinterpret_cast<const float4*>(qrow + 4 * e4);
      acc = fmaf(qq.x, v[4 * e4], acc);
      acc = fmaf(qq.y, v[4 * e4 + 1], acc);
      acc = fmaf(qq.z, v[4 * e4 + 2], acc);
      acc = fmaf(qq.w, v[4 * e4 + 3], acc);
    }
  }
}

// Merge the slot's candidates into its sorted list by rank (keys are unique):
// an entry's new rank is its rank among the list plus its rank among the
// candidates. Lists are double-buffered (sel); thresh becomes the k-th key.
__device__ void flush_candidates(const Slots& S, int k) {
  const int tid = threadIdx.x;
  __syncthreads();                            // every push has landed
  const int nc = S.cand_n[0];
  if (nc > 0) {
    const int nr = S.nreal[0];
    const uint64_t* cur = S.lists + size_t(S.sel[0]) * k;
    uint64_t* nxt = S.lists + size_t(S.sel[0] ^ 1) * k;
    for (int e = tid; e < nr + nc; e += kThreads) {
      const uint64_t x = e < nr ? cur[e] : S.cand[e - nr];
      int rank = 0;
      for (int m = 0; m < nc; ++m) rank += S.cand[m] > x;
      if (e < nr) {
        rank += e;
      } else {
        int lo = 0, hi = nr;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (cur[mid] > x) lo = mid + 1; else hi = mid;
        }
        rank += lo;
      }
      if (rank < k) nxt[rank] = x;
    }
  }
  __syncthreads();
  if (tid == 0 && nc > 0) {
    const int nn = min(k, S.nreal[0] + nc);
    S.nreal[0] = nn;
    S.sel[0] ^= 1;
    S.thresh[0] = nn == k ? S.lists[size_t(S.sel[0]) * k + k - 1] : 0;
    S.cand_n[0] = 0;
  }
  __syncthreads();
}

template <typename T, bool DQ>
__device__ void gather_item(const ScanArgs& a, unsigned char* smem, const TileSmem& L,
                            const Slots& S, size_t base, int r0, int nrows) {
  constexpr int kce = kChunkBytes / sizeof(T);
  constexpr int kQSegs = kce / 4;            // 16-byte pieces of the stage's query floats
  const int tid = threadIdx.x;
  const int k = a.k;

  // 1. the chunk's ids, its live tiles, an empty list
  for (int n = tid; n < nrows; n += kThreads) S.ids[n] = a.ids[base + r0 + n];
  if (tid == 0) {
    S.nreal[0] = 0;
    S.sel[0] = 0;
    S.cand_n[0] = 0;
    S.thresh[0] = 0;
  }
  __syncthreads();
  const int n_tiles = (nrows + kTile - 1) / kTile;
  int n_live = 0;
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int n = tt * kTile + tid;
    if (__syncthreads_or(n < nrows && S.ids[n] >= 0)) {
      if (tid == 0) S.tiles[n_live] = tt;
      ++n_live;
    }
  }
  __syncthreads();

  const int rowbytes = a.d * int(sizeof(T));
  const int nk = (rowbytes + kChunkBytes - 1) / kChunkBytes;
  const int steps = n_live * nk;
  const char* emb = static_cast<const char*>(a.emb);
  const int qr = S.q[0];

  // 2. the ring: step s = (live tile s / nk, 128-byte column s % nk)
  auto issue = [&](int s) {
    if (s < steps) {
      const int st = s % kStages, tt = S.tiles[s / nk], kc = s % nk;
      const int bytes = min(kChunkBytes, rowbytes - kc * kChunkBytes);
      unsigned char* rs = smem + size_t(st) * L.stage;
      for (int e = tid; e < kTile * (kChunkBytes / 16); e += kThreads) {
        const int rr = e >> 3, sg = e & 7, n = tt * kTile + rr;
        if (sg * 16 < bytes && n < nrows && S.ids[n] >= 0)
          cp_async16(rs + rr * kChunkBytes + ((sg ^ (rr & 7)) << 4),
                     emb + (base + r0 + n) * size_t(rowbytes) + kc * kChunkBytes + sg * 16);
      }
      float* qs = reinterpret_cast<float*>(rs + kTile * kChunkBytes);
      const int qfloats = bytes / int(sizeof(T));
      if (tid < kQSegs && tid * 4 < qfloats)
        cp_async16(qs + tid * 4, a.q + size_t(qr) * a.d + kc * kce + tid * 4);
    }
    cp_commit();
  };

  float acc = 0.f, sc = 1.f;
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_wait<0>();
    __syncthreads();                         // stage s landed; stage s - 1 is free
    issue(s + kStages - 1);
    const int st = s % kStages, kc = s % nk, tt = S.tiles[s / nk];
    const int n = tt * kTile + tid;          // this thread's row of the tile
    if (DQ && kc == 0) sc = n < nrows ? a.scale[base + r0 + n] : 1.f;
    const unsigned char* rs = smem + size_t(st) * L.stage;
    const int bytes = min(kChunkBytes, rowbytes - kc * kChunkBytes);
    tile_dot<T, DQ>(rs, reinterpret_cast<const float*>(rs + kTile * kChunkBytes), bytes / 16,
                    tid, sc, acc);
    if (kc != nk - 1) continue;

    // 3. the tile is scored: the candidates enter in two halves of the tile, so
    // the slot takes <= 128
    const bool live = n < nrows && S.ids[n] >= 0;
    for (int half = 0; half < 2; ++half) {
      if (live && (tid / kCandCap) == half) {
        const size_t row = base + r0 + n;
        const float4 p = S.par[0];
        const float sterm = spatial_term(p.x, p.y, a.loc[row * 2], a.loc[row * 2 + 1], p.w,
                                         a.dist_max, a.t, a.w_hat);
        const uint64_t key = make_key(__fadd_rn(__fmul_rn(p.z, acc), sterm),
                                      uint32_t(S.pos[0] + r0 + n));
        if (key > S.thresh[0]) S.cand[atomicAdd(S.cand_n, 1)] = key;
      }
      flush_candidates(S, k);
    }
    acc = 0.f;
  }
  cp_wait<0>();
  __syncthreads();

  // 4. the sorted partial list
  const long long o = S.out[0];
  const int nr = S.nreal[0];
  const uint64_t* cur = S.lists + size_t(S.sel[0]) * k;
  for (int e = tid; e < k; e += kThreads) a.part_key[o * k + e] = e < nr ? cur[e] : 0;
  __syncthreads();                           // the smem is the next item's
}

// The candidate copy (B, n, d) is B clusters of capacity n, query b routed to
// cluster b alone: item = b * n_chunks + ch scores chunk ch of query b's copy
// in one slot, scan positions = local positions in [0, n). No plan kernel.
// One slot needs one accumulator, so three blocks share an SM.
template <typename T, bool DQ>
__global__ void __launch_bounds__(kThreads, 3)
gather_kernel(ScanArgs a, int* __restrict__ counter, int B, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int item_s;
  const TileSmem L = tile_smem(a.chunk_rows, a.k, kChunkBytes / sizeof(T), 1);
  const Slots S(smem, L);
  const int tid = threadIdx.x;
  const int total = B * n_chunks;
  for (;;) {
    if (tid == 0) item_s = atomicAdd(counter, 1);
    __syncthreads();
    const int item = item_s;
    if (item >= total) return;
    const int b = item / n_chunks, ch = item % n_chunks;
    if (tid == 0) {
      S.q[0] = b;
      S.out[0] = item;
      S.pos[0] = 0;
      S.par[0] = make_float4(a.q_loc[2 * b], a.q_loc[2 * b + 1], a.w[2 * b], a.w[2 * b + 1]);
    }
    __syncthreads();
    const int r0 = ch * a.chunk_rows;
    gather_item<T, DQ>(a, smem, L, S, size_t(b) * a.cap, r0, min(a.chunk_rows, a.cap - r0));
  }
}

// ---- Hopper building blocks: mbarriers, TMA, named barriers, wgmma ------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}
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
// one box of a 2-D tensor map → shared memory; its bytes complete on bar
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap& map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1),
         "r"(smem_addr(bar)) : "memory");
}
// named barrier `id` over `threads` consumer threads (the producer warp never waits on
// one): a warpgroup's own (id 1 + wg, 128) or all the consumers' (id 3)
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// shared-memory writes of this thread → visible to wgmma's reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// all but the newest n groups done (n < 4, the same in every thread)
__device__ __forceinline__ void wgmma_wait_n(int n) {
  switch (n) {
    case 0: wgmma_wait<0>(); break;
    case 1: wgmma_wait<1>(); break;
    case 2: wgmma_wait<2>(); break;
    default: wgmma_wait<3>(); break;
  }
}
// keeps registers that an in-flight wgmma reads or writes where they are until here
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}
// wgmma's shared-memory matrix descriptor of a K-major operand in 128-byte swizzled
// 8-row atoms (1024 bytes apart): start address, leading byte offset 16 (unused),
// stride byte offset 1024, swizzle mode 1
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) | uint64_t(1) << 16 | uint64_t(64) << 32 |
         uint64_t(1) << 62;
}

// d (64 x N3, f32) = A·B + (acc ? d : 0), bf16 operands, B (16 x N3) K-major in shared
// memory; A (64 x 16) K-major in shared memory (ss) or from registers (rs). N3 = 3N:
// the three query terms of N slots side by side.
__device__ __forceinline__ void wgmma_ss(float (&d)[12], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
               "%12, %13, p, 1, 1, 0, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
               : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[12], const uint32_t* a, uint64_t db,
                                         int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
               "{%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[24], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23}, "
               "%24, %25, p, 1, 1, 0, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
               : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[24], const uint32_t* a, uint64_t db,
                                         int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23}, "
               "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[48], uint64_t da, uint64_t db, int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
               "%48, %49, p, 1, 1, 0, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
               : "l"(da), "l"(db), "r"(acc));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t* a, uint64_t db,
                                         int acc) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
               "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
               "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
               "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
                 "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
                 "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
                 "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
                 "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                 "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// ---- the engine scans: layout, work items, the query split -------------------------

constexpr int kScanTile = 64;                  // object rows per wgmma tile (M)
constexpr int kStageBytes = 128;               // bytes of a row per ring stage
constexpr int kStageTile = kScanTile * kStageBytes;   // one TMA box: 8 KB
constexpr int kSlotMax = 32;                   // the most query slots of a work item
constexpr int kWG = 128;                       // a consumer warpgroup
constexpr int kConsumers = 2 * kWG;            // at most two of them
constexpr int kScanThreads = kConsumers + 32;  // and one producer warp
constexpr int kFieldBytes = 2560;              // the per-slot fields (ScanSlots)

// 16-deep k-steps of a stage, elements of a stage, whether A comes from registers
template <typename T> struct Tier;
// and the most wgmma groups (stages) in flight: A registers of each stay live until its
// group completes
template <> struct Tier<float> {           // split into three bf16 terms in registers
  static constexpr int E = 32, KS = 2, PARTS = 3, DEPTH = 3;
  static constexpr bool DQ = false, REG = true;
};
template <> struct Tier<__nv_bfloat16> {   // A read by wgmma from the stage itself
  static constexpr int E = 64, KS = 4, PARTS = 1, DEPTH = 4;
  static constexpr bool DQ = false, REG = false;
};
template <> struct Tier<int8_t> {          // widened to bf16 in registers, exactly
  static constexpr int E = 128, KS = 8, PARTS = 1, DEPTH = 2;
  static constexpr bool DQ = true, REG = true;
};

// 64-wide blocks of B's k (the row's stages, zero past d)
__host__ __device__ inline int b_blocks(int d, int elem) {
  const int nk = (d * elem + kStageBytes - 1) / kStageBytes;
  return (nk * (kStageBytes / elem) + 63) / 64;
}

// Shared-memory layout of the engine scan with W consumer warpgroups (1 or 2), in
// bytes from a 1024-aligned base (mirrored by scan_smem in kernels/fused_topk_score.py;
// the launcher checks the total the wrapper passes): W rings (stages x 64 rows x 128
// bytes, each row's 16-byte pieces swizzled by TMA), B (b_blocks x 3N rows x 128
// bytes, swizzled alike: row t * N + j of a block holds query term t of slot j, so one
// wgmma of N3 = 3N columns takes all three terms), then per warpgroup the
// double-buffered sorted lists (G x k keys), the candidate buffers (G x 64 keys) and
// the per-slot fields, the item queue (2 item records) and the mbarriers (full and
// empty per stage of each ring, full and empty per queue entry).
struct ScanSmem { size_t ring, bmat, lists, cand, fields, queue, bars, total, per_lists; };

// An item: {roster row (-1: no more items), cluster, slot group << 16 | chunk, the
// mask of the chunk's 64-row tiles that hold a live row} and the pairs of its slots
// (-1: none); items_kernel writes them, the producer passes each on in its queue.
struct ItemRecord { int4 desc; int pairs[kSlotMax]; };

__host__ __device__ inline ScanSmem scan_smem(int d, int k, int elem, int G, int stages,
                                              int W) {
  const int n = G < 8 ? 8 : G;
  ScanSmem s;
  s.ring = 0;
  s.bmat = size_t(W) * stages * kStageTile;
  s.lists = s.bmat + size_t(3) * b_blocks(d, elem) * n * 128;
  s.per_lists = 2 * size_t(G) * k * 8;
  s.cand = s.lists + W * s.per_lists;
  s.fields = s.cand + size_t(W) * G * kScanTile * 8;
  s.queue = s.fields + size_t(W) * kFieldBytes;
  s.bars = s.queue + 2 * sizeof(ItemRecord);
  s.total = 1024 + s.bars + size_t(2 * W * stages + 4) * 8;
  return s;
}

struct ScanSlots {                             // a warpgroup's views of its slots
  float4* par; int4* filt; uint64_t* thresh; long long* out;
  int* q; int* pos; int* nreal; int* sel; int* cand_n; int* span;
  uint64_t* lists; uint64_t* cand;
  __device__ ScanSlots(unsigned char* base, const ScanSmem& L, int G, int wg) {
    unsigned char* f = base + L.fields + size_t(wg) * kFieldBytes;
    par = reinterpret_cast<float4*>(f);
    filt = reinterpret_cast<int4*>(f + 512);
    thresh = reinterpret_cast<uint64_t*>(f + 1024);
    out = reinterpret_cast<long long*>(f + 1280);
    q = reinterpret_cast<int*>(f + 1536);
    pos = q + 32; nreal = q + 64; sel = q + 96; cand_n = q + 128;
    span = q + 160;                            // 33 prefix sums of the merge sizes
    lists = reinterpret_cast<uint64_t*>(base + L.lists + wg * L.per_lists);
    cand = reinterpret_cast<uint64_t*>(base + L.cand) + size_t(wg) * G * kScanTile;
  }
};

// Where an item's slots come from. Cluster-major: roster row i of the host plan
// (cluster u[i], slot s holds pair roster[i][s], live when in [0, n_total)).
// Routed: row i < c is cluster i, row c the routes to no cluster; its slots are
// the pairs of slots[start[i] .. start[i] + count[i]) (the batch's pairs sorted by
// cluster on the device). groups[i] slot groups of G, offsets their items' prefix.
struct Roster {
  const int* u; const int* slots; const int* start; const int* count;
  const int* groups; const int* offsets;
  int rows, qcap, cr, n_total, c, routed;
};

__device__ __forceinline__ int row_cluster(const Roster& R, int i) {
  return R.routed ? (i < R.c ? i : -1) : R.u[i];
}
__device__ __forceinline__ int slot_pair(const Roster& R, int i, int s) {
  if (R.routed) return s < R.count[i] ? R.slots[R.start[i] + s] : -1;
  if (s >= R.qcap) return -1;
  const int o = R.slots[size_t(i) * R.qcap + s];
  return o >= 0 && o < R.n_total ? o : -1;
}
// item → (roster row i, slot group g, chunk ch): rows take groups[i] * n_chunks
// items from offsets[i], chunk-major (item offsets[i] + ch * groups[i] + g), so the
// slot groups of one cluster chunk run side by side and share it through L2
__device__ __forceinline__ void item_of(const Roster& R, int item, int& i, int& g, int& ch) {
  int lo = 0, hi = R.rows;                   // offsets[lo] <= item < offsets[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (R.offsets[mid] <= item) lo = mid; else hi = mid;
  }
  const int local = item - R.offsets[lo], gi = R.groups[lo];
  i = lo;
  ch = local / gi;
  g = local % gi;
}

// one block of 1024: out[0..n] = exclusive prefix sum of in[x] * mul, out[n] the total
__device__ void block_scan(const int* __restrict__ in, int n, int mul, int* __restrict__ out,
                           int* part) {
  const int tid = threadIdx.x;
  const int per = (n + 1023) / 1024;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int sum = 0;
  for (int x = lo; x < hi; ++x) sum += in[x] * mul;
  part[tid] = sum;
  __syncthreads();
  for (int off = 1; off < 1024; off <<= 1) {
    const int add = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += add;
    __syncthreads();
  }
  int run = tid ? part[tid - 1] : 0;
  for (int x = lo; x < hi; ++x) {
    out[x] = run;
    run += in[x] * mul;
  }
  if (tid == 1023) out[n] = part[1023];
  __syncthreads();
}

// cluster-major: groups[i] = ceil((last live slot of roster row i + 1) / G)
__global__ void cm_groups_kernel(const int* __restrict__ roster, int qcap, int n_total, int G,
                                 int* __restrict__ groups) {
  __shared__ int wmax[kWarps];
  const int i = blockIdx.x;
  int last = -1;
  for (int s = threadIdx.x; s < qcap; s += blockDim.x) {
    const int o = roster[size_t(i) * qcap + s];
    if (o >= 0 && o < n_total) last = s;     // s grows along the loop
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(kFull, last, off));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = wmax[0];
    for (int w = 1; w < int(blockDim.x >> 5); ++w) m = max(m, wmax[w]);
    groups[i] = (m + G) / G;                 // 0 for a row with no live slot
  }
}

// offsets of the items (groups * n_chunks each); resets the work counter
__global__ void __launch_bounds__(1024)
offsets_kernel(const int* __restrict__ groups, int rows, int n_chunks,
               int* __restrict__ offsets, int* __restrict__ counter) {
  __shared__ int part[1024];
  block_scan(groups, rows, n_chunks, offsets, part);
  if (threadIdx.x == 0) *counter = 0;
}

// The item records, one warp an item (a tile that is all padding is never fetched);
// records past the item count are left unwritten.
__global__ void items_kernel(Roster R, const int* __restrict__ ids, int cap, int chunk_rows,
                             int G, int max_items, ItemRecord* __restrict__ rec) {
  const int item = int((blockIdx.x * size_t(blockDim.x) + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (item >= max_items || item >= R.offsets[R.rows]) return;   // warp-uniform
  int i, g, ch;
  item_of(R, item, i, g, ch);
  const int cl = row_cluster(R, i), r0 = ch * chunk_rows, nrows = min(chunk_rows, cap - r0);
  unsigned mask = 0;
  if (cl >= 0 && cl < R.c) {
    const int* idp = ids + size_t(cl) * cap + r0;
    for (int t0 = 0; t0 < nrows; t0 += 16 * kScanTile) {   // 16 tiles a round
      int live[32];
#pragma unroll
      for (int h = 0; h < 32; ++h) {
        const int n = t0 + h * 32 + lane;
        live[h] = n < nrows ? idp[n] : -1;
      }
#pragma unroll
      for (int tt = 0; tt < 16; ++tt)
        if (__any_sync(kFull, live[2 * tt] >= 0 || live[2 * tt + 1] >= 0))
          mask |= 1u << (t0 / kScanTile + tt);
    }
  }
  rec[item].pairs[lane] = lane < G ? slot_pair(R, i, g * G + lane) : -1;
  if (lane == 0) rec[item].desc = make_int4(i, cl, (g << 16) | ch, int(mask));
}

// routed: the counting sort of the pairs by cluster (row c: routes to no cluster)
__device__ __forceinline__ int route_row(int cl, int c) { return cl >= 0 && cl < c ? cl : c; }

__global__ void route_count_kernel(const int* __restrict__ top_c, int n_pairs, int c,
                                   int* __restrict__ count) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n_pairs) atomicAdd(count + route_row(top_c[p], c), 1);
}

__global__ void __launch_bounds__(1024)
route_offsets_kernel(const int* __restrict__ count, int c, int G, int n_chunks,
                     int* __restrict__ start, int* __restrict__ groups,
                     int* __restrict__ offsets, int* __restrict__ fill,
                     int* __restrict__ counter) {
  __shared__ int part[1024];
  for (int i = threadIdx.x; i <= c; i += 1024) {
    groups[i] = (count[i] + G - 1) / G;
    fill[i] = 0;
  }
  __syncthreads();
  block_scan(count, c + 1, 1, start, part);
  block_scan(groups, c + 1, n_chunks, offsets, part);
  if (threadIdx.x == 0) *counter = 0;
}

// pair p → its row's next place; the order inside a row is free (a pair's partial
// lists depend on its own scores alone)
__global__ void route_scatter_kernel(const int* __restrict__ top_c, int n_pairs, int c,
                                     const int* __restrict__ start, int* __restrict__ fill,
                                     int* __restrict__ order) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pairs) return;
  const int r = route_row(top_c[p], c);
  order[start[r] + atomicAdd(fill + r, 1)] = p;
}

// Position, inside a stage of E elements, of the element that logical k index li
// reads: the identity for bf16 rows (wgmma reads them from shared memory); for A in
// registers, k-step s = li / 16, k = li % 16 of the fragment of lane t = (k % 8) / 2
// holds elements E/4 * t + 4s + j, j = 2 (k / 8) + k % 2: a thread's A values of the
// whole stage are E/4 contiguous elements of each of its rows.
__device__ __forceinline__ int stage_perm(int li, int elem) {
  if (elem == 2) return li;
  const int E = kStageBytes / elem, s = li >> 4, kq = li & 15;
  return (E / 4) * ((kq & 7) >> 1) + 4 * s + 2 * (kq >> 3) + (kq & 1);
}

// q (B, d) f32 → three bf16 terms (B, 3, kb * 64), q_hi = RN(q), q_mid = RN(q - q_hi),
// q_lo = RN(q - q_hi - q_mid) (both differences exact), in the products' k order
__global__ void split_q_kernel(const float* __restrict__ q, int d, int elem, int kb,
                               uint16_t* __restrict__ out) {
  const int b = blockIdx.x, width = kb * 64, E = kStageBytes / elem;
  for (int li = threadIdx.x; li < width; li += blockDim.x) {
    const int x_at = (li / E) * E + stage_perm(li % E, elem);
    const float x = x_at < d ? q[size_t(b) * d + x_at] : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(x);
    const float r1 = __fsub_rn(x, __bfloat162float(hi));
    const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
    const __nv_bfloat16 lo = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
    uint16_t* o = out + size_t(b) * 3 * width + li;
    o[0] = __bfloat16_as_ushort(hi);
    o[width] = __bfloat16_as_ushort(mid);
    o[2 * width] = __bfloat16_as_ushort(lo);
  }
}

// ---- the engine scan kernel ------------------------------------------------------

template <int V> struct IntC { static constexpr int value = V; };

// a thread's rows n and n + 8 of a tile: ids (-1: padding or past the chunk),
// locations, int8 scales and, when filtered, attributes
template <bool F>
struct RowPair {
  int id[2] = {-1, -1};
  float2 loc[2] = {{0.f, 0.f}, {0.f, 0.f}};
  float sc[2] = {1.f, 1.f};
  int3 at[2] = {{0, 0, 0}, {0, 0, 0}};
  __device__ __forceinline__ void load(const ScanArgs& a, size_t rowbase, int n, int nrows,
                                       bool dq) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = n + 8 * h;
      const size_t row = rowbase + r;
      id[h] = r < nrows ? a.ids[row] : -1;
      if (r < nrows) {                         // padding rows are never scored
        loc[h] = reinterpret_cast<const float2*>(a.loc)[row];
        if (dq) sc[h] = a.scale[row];
        if (F) at[h] = make_int3(a.attrs[row * 3], a.attrs[row * 3 + 1], a.attrs[row * 3 + 2]);
      }
    }
  }
};

// (x, y) → a bf16 pair, x in the low half, rounded to nearest
__device__ __forceinline__ uint32_t bf2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the low / high bf16 of a pair as f32
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// A fragments of one stage for this thread (rows ra and ra + 8 of the 64-row tile, lane
// t4 of its quad): the thread's 32 bytes of each row, pieces 2 t4 and 2 t4 + 1 at their
// swizzled places; ar[(s * PARTS + part) * 4 + r] as wgmma's A registers of k-step s
template <typename T>
__device__ __forceinline__ void load_a(const unsigned char* stage, int ra, int t4,
                                       uint32_t (&ar)[Tier<T>::KS * Tier<T>::PARTS * 4]) {
  const int sw = ra & 7;
  const uint4* rowa = reinterpret_cast<const uint4*>(stage + ra * kStageBytes);
  const uint4* rowb = reinterpret_cast<const uint4*>(stage + (ra + 8) * kStageBytes);
  const uint4 x[2] = {rowa[(2 * t4) ^ sw], rowa[(2 * t4 + 1) ^ sw]};
  const uint4 y[2] = {rowb[(2 * t4) ^ sw], rowb[(2 * t4 + 1) ^ sw]};
  const uint32_t wa[8] = {x[0].x, x[0].y, x[0].z, x[0].w, x[1].x, x[1].y, x[1].z, x[1].w};
  const uint32_t wb[8] = {y[0].x, y[0].y, y[0].z, y[0].w, y[1].x, y[1].y, y[1].z, y[1].w};
  if constexpr (Tier<T>::DQ) {
    // k-step s: word s of each row holds its 4 values (j = 0..3)
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint32_t u = wa[s] ^ 0x80808080u, v = wb[s] ^ 0x80808080u;
      ar[s * 4 + 0] = bf2(i8_to_f32(u, 0), i8_to_f32(u, 1));
      ar[s * 4 + 1] = bf2(i8_to_f32(v, 0), i8_to_f32(v, 1));
      ar[s * 4 + 2] = bf2(i8_to_f32(u, 2), i8_to_f32(u, 3));
      ar[s * 4 + 3] = bf2(i8_to_f32(v, 2), i8_to_f32(v, 3));
    }
  } else {
    // f32: k-step s reads floats 4s .. 4s + 3 of each row's 8; each pair → hi, mid, lo
    // (each the rounded residue of the last, every difference exact)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t* w = (r & 1) ? wb : wa;
        const int e = 4 * s + 2 * (r >> 1);
        float fx = __uint_as_float(w[e]), fy = __uint_as_float(w[e + 1]);
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          const uint32_t t = bf2(fx, fy);
          ar[(s * 3 + part) * 4 + r] = t;
          fx = __fsub_rn(fx, bf_lo(t));
          fy = __fsub_rn(fy, bf_hi(t));
        }
      }
  }
}

// The products of one stage: KS k-steps (global k-step ks0 + s), each A term (f32 rows:
// A_hi, A_mid and A_lo) against the 3N columns of the query terms. B's k-step ks sits at
// bmat + (ks / 4) * 3N * 128 + (ks % 4) * 32. `first`: the tile's first stage (its
// first product overwrites the accumulator).
template <typename T, int N>
__device__ __forceinline__ void stage_products(const unsigned char* stage,
                                               const unsigned char* bmat, int ks0, bool first,
                                               const uint32_t (&ar)[Tier<T>::KS *
                                                                    Tier<T>::PARTS * 4],
                                               float (&acc)[3 * N / 2]) {
  using TT = Tier<T>;
#pragma unroll
  for (int s = 0; s < TT::KS; ++s) {
    const int ks = ks0 + s;
    const uint64_t db = sw128_desc(bmat + (ks >> 2) * 3 * N * 128 + (ks & 3) * 32);
#pragma unroll
    for (int part = 0; part < TT::PARTS; ++part) {
      const int keep = !(first && s == 0 && part == 0);
      if constexpr (TT::REG)
        wgmma_rs(acc, ar + (s * TT::PARTS + part) * 4, db, keep);
      else
        wgmma_ss(acc, sw128_desc(stage + s * 32), db, keep);
    }
  }
}

// Merge every slot's candidates into its sorted list by rank (keys are unique): an
// entry's new rank is its rank among the list plus its rank among the candidates,
// over the (slot, entry) pairs of all slots at once. Lists are double-buffered
// (sel); thresh becomes the k-th key. One warpgroup (ctid its thread, bar its barrier).
__device__ void scan_flush(const ScanSlots& S, int k, int G, int ctid, int bar) {
  named_sync(bar, kWG);                      // every push has landed
  if (ctid < 32) {
    const int m = ctid < G && S.cand_n[ctid] > 0 ? S.nreal[ctid] + S.cand_n[ctid] : 0;
    int incl = m;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (ctid >= off) incl += y;
    }
    S.span[ctid] = incl - m;
    if (ctid == 31) S.span[32] = incl;
  }
  named_sync(bar, kWG);
  const int total = S.span[32];
  if (!total) return;                        // no candidates: nothing to merge
  for (int f = ctid; f < total; f += kWG) {
    int j = 0, hi = 32;                      // span[j] <= f < span[j + 1]
    while (hi - j > 1) {
      const int mid = (j + hi) >> 1;
      if (S.span[mid] <= f) j = mid; else hi = mid;
    }
    const int e = f - S.span[j], nc = S.cand_n[j], nr = S.nreal[j];
    const uint64_t* cur = S.lists + (size_t(S.sel[j]) * G + j) * k;
    uint64_t* nxt = S.lists + (size_t(S.sel[j] ^ 1) * G + j) * k;
    const uint64_t* cj = S.cand + size_t(j) * kScanTile;
    const uint64_t x = e < nr ? cur[e] : cj[e - nr];
    int rank = e < nr ? e : 0;
    // eight independent reads a round (the buffer holds 64, so m + 7 < 64 always)
    for (int m = 0; m < nc && rank < k; m += 8) {
      uint64_t c8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) c8[u] = cj[m + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) rank += (m + u < nc) & (c8[u] > x);
    }
    if (e >= nr && rank < k) {
      int lo = 0, h2 = nr;
      while (lo < h2) {
        const int mid = (lo + h2) >> 1;
        if (cur[mid] > x) lo = mid + 1; else h2 = mid;
      }
      rank += lo;
    }
    if (rank < k) nxt[rank] = x;
  }
  named_sync(bar, kWG);
  if (ctid < G && S.cand_n[ctid] > 0) {
    const int nn = min(k, S.nreal[ctid] + S.cand_n[ctid]);
    S.nreal[ctid] = nn;
    S.sel[ctid] ^= 1;
    S.thresh[ctid] = nn == k ? S.lists[(size_t(S.sel[ctid]) * G + ctid) * k + k - 1] : 0;
    S.cand_n[ctid] = 0;
  }
  named_sync(bar, kWG);
}

// The engine scan: persistent blocks of one producer warp (item records and TMA) and W
// consumer warpgroups (wgmma and the top-k), W = 1 or 2. An item's live 64-row tiles
// go to the warpgroups in turn, each through its own ring, and each warpgroup keeps
// its own lists, so an item writes W partial lists per slot; B and the item's setup
// are shared. N: the wgmma's slot columns (G rounded up to 8).
template <typename T, bool F, int N>
__global__ void __launch_bounds__(kScanThreads, 1)
engine_scan_kernel(const __grid_constant__ CUtensorMap rows_map, ScanArgs a, Roster R,
                   const ItemRecord* __restrict__ recs, const uint16_t* __restrict__ qsplit,
                   int stages, int W, int n_chunks, int* __restrict__ counter) {
  using TT = Tier<T>;
  constexpr int AR = TT::KS * TT::PARTS * 4;   // A registers of a stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* const base = align1024(smem_raw);
  const int G = a.slots, k = a.k;
  const ScanSmem L = scan_smem(a.d, k, sizeof(T), G, stages, W);
  unsigned char* const bmat = base + L.bmat;
  ItemRecord* const queue = reinterpret_cast<ItemRecord*>(base + L.queue);
  uint64_t* const full = reinterpret_cast<uint64_t*>(base + L.bars);   // [W][stages]
  uint64_t* const empty = full + W * stages;                            // [W][stages]
  uint64_t* const qfull = empty + W * stages;
  uint64_t* const qempty = qfull + 2;
  const int nk = (a.d * int(sizeof(T)) + kStageBytes - 1) / kStageBytes;
  const int kb = b_blocks(a.d, sizeof(T));
  // stages a warpgroup holds at most: one fewer than its ring, so the producer can fill
  // the next
  const int depth = min(TT::DEPTH, stages - 1);
  const int total = R.offsets[R.rows];
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int st = 0; st < W * stages; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 4);              // lane 0 of each warp of the warpgroup
    }
    for (int qs = 0; qs < 2; ++qs) {
      mbar_init(qfull + qs, 1);
      mbar_init(qempty + qs, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- the producer warp: items from the counter, the rings' TMA loads ------------
    const int lane = tid & 31;
    int next = 0;
    if (lane == 0) next = atomicAdd(counter, 1);
    int item = __shfl_sync(kFull, next, 0);
    int4 cur = make_int4(-1, -1, 0, 0);        // the item's descriptor, and this lane's
    int pair = -1;                             // slot's pair
    if (item < total) {
      cur = recs[item].desc;
      pair = recs[item].pairs[lane];
      if (lane == 0) next = atomicAdd(counter, 1);
    }
    int step[2] = {0, 0};
    for (int qstep = 0;; ++qstep) {
      const bool done = item >= total;
      const int qs = qstep & 1;
      mbar_wait(qempty + qs, ((qstep >> 1) & 1) ^ 1);
      queue[qs].pairs[lane] = pair;
      if (lane == 0) queue[qs].desc = done ? make_int4(-1, -1, 0, 0) : cur;
      __syncwarp();
      if (lane == 0) mbar_arrive(qfull + qs);
      if (done) break;
      // the next item's record, read under this item's loads
      const int4 dsc = cur;
      item = __shfl_sync(kFull, next, 0);
      if (item < total) {
        cur = recs[item].desc;
        pair = recs[item].pairs[lane];
        if (lane == 0) next = atomicAdd(counter, 1);
      }
      // live tile j goes to warpgroup j % W; the rings are filled in turn, a stage each
      const int r0 = (dsc.z & 0xffff) * a.chunk_rows;
      for (unsigned m = dsc.w; m;) {
        int row[2];
        int nw = 0;
        for (; nw < W && m; ++nw, m &= m - 1)
          row[nw] = dsc.y * a.cap + r0 + (__ffs(m) - 1) * kScanTile;
        for (int kc = 0; kc < nk; ++kc)
          for (int w = 0; w < nw; ++w) {
            const int st = w * stages + step[w] % stages;
            mbar_wait(empty + st, ((step[w] / stages) & 1) ^ 1);
            if (lane == 0) {
              mbar_arrive_tx(full + st, kStageTile);
              tma_load_2d(base + L.ring + size_t(st) * kStageTile, rows_map, kc * TT::E,
                          row[w], full + st);
            }
            __syncwarp();
            ++step[w];
          }
      }
    }
    return;
  }

  // ---- the consumer warpgroups -----------------------------------------------------
  const int wg = tid / kWG, ctid = tid % kWG;
  if (wg >= W) return;
  const int bar = 1 + wg;                      // this warpgroup's barrier
  const int warp = ctid >> 5, lane = ctid & 31, t4 = lane & 3;
  const int ra = 16 * warp + (lane >> 2);      // this thread's rows of a tile: ra, ra + 8
  const ScanSlots S(base, L, G, wg);
  unsigned char* const ring = base + L.ring + size_t(wg) * stages * kStageTile;
  uint64_t* const wfull = full + wg * stages;
  uint64_t* const wempty = empty + wg * stages;

  int step = 0;
  for (int qstep = 0;; ++qstep) {
    const int qs = qstep & 1;
    mbar_wait(qfull + qs, (qstep >> 1) & 1);
    const int4 qv = queue[qs].desc;
    const int cl = qv.y, ch = qv.z & 0xffff;
    // every consumer is past the last item's products (B is rewritten below)
    named_sync(3, W * kWG);
    if (qv.x < 0) break;
    const int r0 = ch * a.chunk_rows, nrows = min(a.chunk_rows, a.cap - r0);
    // this warpgroup's tiles: the live tiles wg, wg + W, ... of the mask; this thread's
    // two rows of a tile (ids, locations, scales, attributes) are read a tile ahead,
    // the first under the item's setup, so the loads land under the products
    unsigned mine = 0;
    {
      unsigned m = qv.w;
      for (int j = 0; m; ++j, m &= m - 1)
        if (j % W == wg) mine |= m & (0u - m);
    }
    const size_t rowbase = size_t(cl) * a.cap + r0;
    RowPair<F> cur, nxt;
    if (mine) cur.load(a, rowbase, (__ffs(mine) - 1) * kScanTile + ra, nrows, TT::DQ);
    if (ctid < kSlotMax) {                     // the item's slots, this warpgroup's view
      const int p = queue[qs].pairs[ctid];
      const int qr = p >= 0 ? p / R.cr : -1;
      S.q[ctid] = qr;
      S.out[ctid] = p >= 0 ? ((long long)p * n_chunks + ch) * W + wg : -1;
      S.pos[ctid] = R.routed && p >= 0 ? (p % R.cr) * a.cap : 0;
      S.nreal[ctid] = 0;
      S.sel[ctid] = 0;
      S.cand_n[ctid] = 0;
      S.thresh[ctid] = 0;
      if (qr >= 0) {
        S.par[ctid] = make_float4(a.q_loc[2 * qr], a.q_loc[2 * qr + 1], a.w[2 * qr],
                                  a.w[2 * qr + 1]);
        if (F)
          S.filt[ctid] = make_int4(a.q_filt[4 * qr], a.q_filt[4 * qr + 1],
                                   a.q_filt[4 * qr + 2], a.q_filt[4 * qr + 3]);
      }
    }
    if (cl < 0 || cl >= R.c) {                 // routes to no cluster: empty partials
      named_sync(3, W * kWG);
      if (tid == 0) mbar_arrive(qempty + qs);
      for (int j = 0; j < G; ++j)
        if (S.q[j] >= 0) write_empty(a, S.out[j], ctid, kWG);
      continue;
    }
    // B: the slots' query terms, rows of 128 bytes swizzled as TMA swizzles A (the
    // pairs read from the queue entry, so these loads go out with the slots' own);
    // eight pieces a thread a round, all loaded before any is stored
    const int pieces = kb * 3 * N * 8, stride = W * kWG;
    for (int f0 = tid; f0 < pieces; f0 += 8 * stride) {
      uint4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int f = f0 + u * stride;
        const int row = (f >> 3) % (3 * N), n = row % N;
        const int pn = f < pieces && n < G ? queue[qs].pairs[n] : -1;
        v[u] = make_uint4(0, 0, 0, 0);
        if (pn >= 0)
          v[u] = __ldg(reinterpret_cast<const uint4*>(
              qsplit + (size_t(pn / R.cr) * 3 + row / N) * kb * 64 +
              (f >> 3) / (3 * N) * 64 + (f & 7) * 8));
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int f = f0 + u * stride;
        if (f >= pieces) break;
        const int row = (f >> 3) % (3 * N);
        *reinterpret_cast<uint4*>(bmat + (size_t((f >> 3) / (3 * N)) * 3 * N + row) * 128 +
                                  (((f & 7) ^ (row & 7)) << 4)) = v[u];
      }
    }
    fence_proxy_async();
    named_sync(3, W * kWG);
    if (tid == 0) mbar_arrive(qempty + qs);    // the entry is read

    for (unsigned m = mine; m; m &= m - 1) {
      const int tt = __ffs(m) - 1;
      const int na = tt * kScanTile + ra, nb = na + 8;   // rows within the chunk
      const unsigned rest = m & (m - 1);
      if (rest) nxt.load(a, rowbase, (__ffs(rest) - 1) * kScanTile + ra, nrows, TT::DQ);

      // the products: up to `depth` stages' groups in flight, the next stage's A read
      // under them; a stage is freed once its group is done
      float acc[3 * N / 2];
      uint32_t ar[TT::DEPTH][AR];
      auto run_stage = [&](auto buf, int kc) {
        constexpr int B_ = decltype(buf)::value;
        const int st = step % stages;
        mbar_wait(wfull + st, (step / stages) & 1);
        const unsigned char* stage = ring + st * kStageTile;
        if constexpr (TT::REG) load_a<T>(stage, ra, t4, ar[B_]);
        wgmma_fence();
        stage_products<T, N>(stage, bmat, kc * TT::KS, kc == 0, ar[B_], acc);
        wgmma_commit();
        if (kc >= depth - 1) {                 // stage kc - depth + 1 is read: free it
          wgmma_wait_n(depth - 1);
          if constexpr (TT::REG) {
#pragma unroll
            for (int b = 0; b < TT::DEPTH; ++b) reg_fence(ar[b]);
          }
          if (lane == 0) mbar_arrive(wempty + (step + stages - depth + 1) % stages);
        }
        ++step;
      };
      static_assert(TT::DEPTH >= 2 && TT::DEPTH <= 4, "unrolled for 2 to 4 buffers");
      for (int kc = 0; kc < nk; kc += TT::DEPTH) {
        run_stage(IntC<0>(), kc);
        if (kc + 1 < nk) run_stage(IntC<1>(), kc + 1);
        if constexpr (TT::DEPTH > 2)
          if (kc + 2 < nk) run_stage(IntC<2>(), kc + 2);
        if constexpr (TT::DEPTH > 3)
          if (kc + 3 < nk) run_stage(IntC<3>(), kc + 3);
      }
      wgmma_wait<0>();
      reg_fence(acc);
      if constexpr (TT::REG) {
#pragma unroll
        for (int b = 0; b < TT::DEPTH; ++b) reg_fence(ar[b]);
      }
      if (lane == 0)                           // the stages still held, oldest first
        for (int r = min(depth - 1, nk); r > 0; --r)
          mbar_arrive(wempty + (step + stages - r) % stages);

      // the tile's scores: each (row, slot) pair once, its three query terms' sums
      // added as (hi + mid) + lo
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int slot = 8 * j + 2 * t4 + e;
          if (slot >= G || S.q[slot] < 0) continue;
          const float4 p = S.par[slot];
          const uint64_t thr = S.thresh[slot];
          const int pos0 = S.pos[slot] + r0;
          int4 fl = make_int4(0, 0, 0, 0);
          if (F) fl = S.filt[slot];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (cur.id[h] < 0) continue;
            if (F && !passes3(cur.at[h].x, cur.at[h].y, cur.at[h].z, fl)) continue;
            const int c0 = 4 * j + 2 * h + e;
            float dot = __fadd_rn(__fadd_rn(acc[c0], acc[c0 + N / 2]), acc[c0 + N]);
            if (TT::DQ) dot = __fmul_rn(dot, cur.sc[h]);
            const float stv = __fadd_rn(
                __fmul_rn(p.z, dot),
                spatial_term(p.x, p.y, cur.loc[h].x, cur.loc[h].y, p.w, a.dist_max, a.t,
                             a.w_hat));
            const uint64_t key = make_key(stv, uint32_t(pos0 + (h ? nb : na)));
            if (key > thr) S.cand[slot * kScanTile + atomicAdd(S.cand_n + slot, 1)] = key;
          }
        }
      scan_flush(S, k, G, ctid, bar);
      cur = nxt;
    }

    // one sorted partial list per live slot
    for (int f = ctid; f < G * k; f += kWG) {
      const int j = f / k, e = f % k;
      if (S.q[j] < 0) continue;
      const long long o = S.out[j];
      const uint64_t x =
          e < S.nreal[j] ? S.lists[(size_t(S.sel[j]) * G + j) * k + e] : 0;
      a.part_key[o * k + e] = x;
      a.part_id[o * k + e] = x ? a.ids[size_t(cl) * a.cap + (key_pos(x) - S.pos[j])] : -1;
    }
  }
}

// ---- merge of the partial lists ------------------------------------------------------
// One warp per output row: the top k of its n_lists sorted partial lists (k
// keys each, 0 past the last real one) by key, as (score, id) or, with POS,
// (score, scan position); (NEG_INF, -1) past the last real key. Each lane
// keeps the best head of its lists l = lane, lane + 32, ...; only the
// winner's lane looks again.

constexpr int kMergeWarps = 4;

template <bool POS>
__global__ void __launch_bounds__(kMergeWarps * 32)
merge_kernel(const uint64_t* __restrict__ part_key, const int* __restrict__ part_id, int rows,
             int n_lists, int k, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ int heads[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kMergeWarps + warp;
  if (row >= rows) return;                   // no block-wide barrier below
  int* pos = heads + warp * n_lists;
  const uint64_t* pk = part_key + size_t(row) * n_lists * k;
  const int* pi = POS ? nullptr : part_id + size_t(row) * n_lists * k;
  for (int l = lane; l < n_lists; l += 32) pos[l] = 0;
  __syncwarp();
  auto lane_best = [&](uint64_t& best, int& bl) {
    best = 0;
    bl = -1;
    for (int l = lane; l < n_lists; l += 32) {
      const int p = pos[l];
      const uint64_t x = p < k ? pk[size_t(l) * k + p] : 0;
      if (x > best) { best = x; bl = l; }
    }
  };
  uint64_t mine;
  int mine_l;
  lane_best(mine, mine_l);
  for (int s = 0; s < k; ++s) {
    uint64_t best = mine;
    int bl = mine_l;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const uint64_t ob = __shfl_xor_sync(kFull, best, off);
      const int ol = __shfl_xor_sync(kFull, bl, off);
      if (ob > best) { best = ob; bl = ol; }
    }
    if (best == 0) {                         // every list is spent
      for (int e = s + lane; e < k; e += 32) {
        out_s[size_t(row) * k + e] = kNegInf;
        out_i[size_t(row) * k + e] = -1;
      }
      return;
    }
    if ((bl & 31) == lane) {                 // keys are unique: one owner
      const int p = pos[bl];
      out_s[size_t(row) * k + s] = key_score(best);
      out_i[size_t(row) * k + s] = POS ? int(key_pos(best)) : pi[size_t(bl) * k + p];
      pos[bl] = p + 1;
      lane_best(mine, mine_l);
    }
    __syncwarp();
  }
}


// ---- launchers ------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

// the list heads take kMergeWarps * n_lists ints of shared memory: the
// wrapper caps n_lists there (launch_shape's merge_lists_max)
template <bool POS>
cudaError_t merge(const ScanArgs& a, int rows, int n_lists, float* out_s, int* out_i,
                  cudaStream_t stream) {
  const size_t smem = size_t(kMergeWarps) * n_lists * 4;
  cudaError_t e = set_smem(merge_kernel<POS>, smem);
  if (e != cudaSuccess) return e;
  merge_kernel<POS><<<(rows + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, smem, stream>>>(
      a.part_key, a.part_id, rows, n_lists, a.k, out_s, out_i);
  return cudaGetLastError();
}

// the launch shape the wrapper computed must be the kernel's own

// the launch shape the wrapper computed must be the gather kernel's own
template <typename T>
bool gather_shape_ok(const ScanArgs& a, size_t smem) {
  return a.chunk_rows > 0 && a.chunk_rows % kTile == 0 && a.slots == 1 &&
         tile_smem(a.chunk_rows, a.k, kChunkBytes / sizeof(T), 1).total == smem;
}

// persistent blocks: as many as the card holds at once
template <typename K>
cudaError_t persistent_grid(K kernel, int threads, size_t smem, int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  grid = sms * per_sm;
  return cudaSuccess;
}

template <typename T, bool DQ>
cudaError_t gather(const ScanArgs& a, int B, int* counter, size_t smem, float* out_s,
                   int* out_i, cudaStream_t stream) {
  if (!gather_shape_ok<T>(a, smem)) return cudaErrorInvalidValue;
  const int n_chunks = (a.cap + a.chunk_rows - 1) / a.chunk_rows;
  cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return e;
  auto kernel = gather_kernel<T, DQ>;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  int grid = 0;
  if ((e = persistent_grid(kernel, kThreads, smem, grid)) != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a, counter, B, n_chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return merge<true>(a, B, n_chunks, out_s, out_i, stream);
}

// cuTensorMapEncodeTiled, reached through the runtime (no link against libcuda)
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

CUtensorMapDataType map_type(float) { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
CUtensorMapDataType map_type(__nv_bfloat16) { return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16; }
CUtensorMapDataType map_type(int8_t) { return CU_TENSOR_MAP_DATA_TYPE_UINT8; }

// the buffers (c, cap, d) as (c * cap, d) → boxes of 64 rows x 128 bytes, the 128-byte
// swizzle; elements past d and rows past c * cap read as zeros
template <typename T>
bool rows_map(CUtensorMap* m, const void* emb, int d, long long rows) {
  const cuuint64_t dims[2] = {cuuint64_t(d), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(d) * sizeof(T)};
  const cuuint32_t box[2] = {cuuint32_t(Tier<T>::E), cuuint32_t(kScanTile)}, unit[2] = {1, 1};
  return encode_tiled() &&
         encode_tiled()(m, map_type(T()), 2, const_cast<void*>(emb), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The engine scan itself: the split of the queries, then the persistent scan. G (the
// slots), the ring's stages and smem come from launch_shape in
// kernels/fused_topk_score.py; the layout must be the kernel's own.
// the item records' place in the int32 scratch: after `used` ints, 16-byte aligned
inline ItemRecord* records_at(int* work, size_t used) {
  return reinterpret_cast<ItemRecord*>(work + ((used + 3) & ~size_t(3)));
}

template <typename T, bool F>
cudaError_t engine_scan(const ScanArgs& a, const Roster& R, int c, ItemRecord* recs,
                        int max_items, uint16_t* qsplit, int B, int stages, int W, size_t smem,
                        int n_chunks, int* counter, cudaStream_t stream) {
  const int G = a.slots;
  if (a.chunk_rows < kScanTile || a.chunk_rows % kScanTile || a.chunk_rows > 32 * kScanTile ||
      G < 1 || G > kSlotMax || (G > 8 && G != 16 && G != 32) || stages < 2 || stages > 16 ||
      W < 1 || W > 2 || scan_smem(a.d, a.k, sizeof(T), G, stages, W).total != smem ||
      max_items < 1)
    return cudaErrorInvalidValue;
  CUtensorMap map;
  if (!rows_map<T>(&map, a.emb, a.d, (long long)c * a.cap)) return cudaErrorInvalidValue;
  split_q_kernel<<<B, 256, 0, stream>>>(a.q, a.d, sizeof(T), b_blocks(a.d, sizeof(T)), qsplit);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  items_kernel<<<unsigned((max_items + 7) / 8), 256, 0, stream>>>(R, a.ids, a.cap,
                                                                  a.chunk_rows, G, max_items,
                                                                  recs);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  auto kernel = G > 16 ? engine_scan_kernel<T, F, 32>
                       : G > 8 ? engine_scan_kernel<T, F, 16> : engine_scan_kernel<T, F, 8>;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  int grid = 0;
  if ((e = persistent_grid(kernel, kScanThreads, smem, grid)) != cudaSuccess) return e;
  kernel<<<grid, kScanThreads, smem, stream>>>(map, a, R, recs, qsplit, stages, W, n_chunks,
                                               counter);
  return cudaGetLastError();
}

template <typename T, bool F>
cudaError_t routed(const ScanArgs& a, const int* top_c, int B, int cr, int c, int* work,
                   int max_items, uint16_t* qsplit, int stages, int W, size_t smem,
                   float* out_s, int* out_i, cudaStream_t stream) {
  if (cr < 1 || c < 1) return cudaErrorInvalidValue;
  const int n_pairs = B * cr, rows = c + 1;
  const int n_chunks = (a.cap + a.chunk_rows - 1) / a.chunk_rows;
  int* count = work;
  int* start = count + rows;
  int* fill = start + rows + 1;
  int* groups = fill + rows;
  int* offsets = groups + rows;
  int* counter = offsets + rows + 1;
  int* order = counter + 1;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int) * rows, stream);
  if (e != cudaSuccess) return e;
  const int pb = (n_pairs + 255) / 256;
  route_count_kernel<<<pb, 256, 0, stream>>>(top_c, n_pairs, c, count);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  route_offsets_kernel<<<1, 1024, 0, stream>>>(count, c, a.slots, n_chunks, start, groups,
                                               offsets, fill, counter);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  route_scatter_kernel<<<pb, 256, 0, stream>>>(top_c, n_pairs, c, start, fill, order);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const Roster R{nullptr, order, start, count, groups, offsets, rows, 0, cr, n_pairs, c, 1};
  ItemRecord* recs = records_at(work, size_t(5) * rows + 3 + n_pairs);
  if ((e = engine_scan<T, F>(a, R, c, recs, max_items, qsplit, B, stages, W, smem, n_chunks,
                             counter, stream)) != cudaSuccess)
    return e;
  return merge<false>(a, B, cr * n_chunks * W, out_s, out_i, stream);
}

template <typename T, bool F>
cudaError_t cluster_major(const ScanArgs& a, const int* u, const int* roster, int u_max,
                          int qcap, int cr, int n_total, int c, int B, int* work, int max_items,
                          uint16_t* qsplit, int stages, int W, size_t smem, float* out_s,
                          int* out_i, cudaStream_t stream) {
  const int n_chunks = (a.cap + a.chunk_rows - 1) / a.chunk_rows;
  int* groups = work;
  int* offsets = work + u_max;
  int* counter = work + 2 * u_max + 1;
  cm_groups_kernel<<<u_max, kThreads, 0, stream>>>(roster, qcap, n_total, a.slots, groups);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  offsets_kernel<<<1, 1024, 0, stream>>>(groups, u_max, n_chunks, offsets, counter);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const Roster R{u, roster, nullptr, nullptr, groups, offsets, u_max, qcap, cr, n_total, c, 0};
  ItemRecord* recs = records_at(work, size_t(2) * u_max + 2);
  if ((e = engine_scan<T, F>(a, R, c, recs, max_items, qsplit, B, stages, W, smem, n_chunks,
                             counter, stream)) != cudaSuccess)
    return e;
  return merge<false>(a, n_total, n_chunks * W, out_s, out_i, stream);
}

ScanArgs scan_args(const void* q, const void* q_loc, const void* w, const void* emb,
                   const void* scale, const void* loc, const void* ids, const void* attrs,
                   const void* q_filt, const void* w_hat, int cap, int d, int t, int k,
                   int chunk_rows, int slots, float dist_max, void* part_key, void* part_id) {
  ScanArgs a;
  a.q = static_cast<const float*>(q);
  a.q_loc = static_cast<const float*>(q_loc);
  a.w = static_cast<const float*>(w);
  a.emb = emb;
  a.scale = static_cast<const float*>(scale);
  a.loc = static_cast<const float*>(loc);
  a.ids = static_cast<const int*>(ids);
  a.attrs = static_cast<const int*>(attrs);
  a.q_filt = static_cast<const int*>(q_filt);
  a.w_hat = static_cast<const float*>(w_hat);
  a.cap = cap; a.d = d; a.t = t; a.k = k; a.chunk_rows = chunk_rows; a.slots = slots;
  a.dist_max = dist_max;
  a.part_key = static_cast<uint64_t*>(part_key);
  a.part_id = static_cast<int*>(part_id);
  return a;
}

}  // namespace

// emb_kind: 0 = float32, 1 = bfloat16, 2 = int8 (requires scale: the dequant body).
// chunk_rows, slots (G), stages, warpgroups (W) and smem_bytes come from launch_shape in
// kernels/fused_topk_score.py; part_key (int64) / part_id (int32) hold
// (B * cr * n_chunks * W, k) partial lists, n_chunks = ceil(cap / chunk_rows);
// qsplit: (B, 3, 64 * b_blocks) 16-bit scratch (the query terms); work: int32 scratch
// of 5 * (c + 1) + 3 + B * cr (the counting sort's counts, starts, fill, slot groups,
// item offsets, the work counter and the sorted pairs), then, 16-byte aligned, 36 *
// max_items (the item records; max_items bounds the items, (ceil(B * cr / G) + c +
// 1) * n_chunks).
extern "C" int fts_routed(const void* q, const void* q_loc, const void* w, const void* top_c,
                          const void* emb, int emb_kind, const void* scale, const void* loc,
                          const void* ids, const void* attrs, const void* q_filt,
                          const void* w_hat, int filtered, int B, int cr, int c, int cap, int d,
                          int t, int k, float dist_max, int chunk_rows, int slots, int stages,
                          int W, long long smem_bytes, void* work, int max_items, void* qsplit,
                          void* part_key, void* part_id, void* out_s, void* out_i,
                          void* stream) {
  const ScanArgs a = scan_args(q, q_loc, w, emb, scale, loc, ids, attrs, q_filt, w_hat, cap, d,
                               t, k, chunk_rows, slots, dist_max, part_key, part_id);
#define FTS_ROUTED(T, F)                                                                      \
  routed<T, F>(a, (const int*)top_c, B, cr, c, (int*)work, max_items, (uint16_t*)qsplit,       \
               stages, W, size_t(smem_bytes), (float*)out_s, (int*)out_i, (cudaStream_t)stream)
  switch (emb_kind * 2 + (filtered ? 1 : 0)) {
    case 0: return FTS_ROUTED(float, false);
    case 1: return FTS_ROUTED(float, true);
    case 2: return FTS_ROUTED(__nv_bfloat16, false);
    case 3: return FTS_ROUTED(__nv_bfloat16, true);
    case 4: return FTS_ROUTED(int8_t, false);
    case 5: return FTS_ROUTED(int8_t, true);
  }
#undef FTS_ROUTED
  return int(cudaErrorInvalidValue);
}

// work: int32 scratch of 2 * u_max + 2 (slot groups, item offsets, work counter), then,
// 16-byte aligned, 36 * max_items (u_max * ceil(qcap / G) * n_chunks item records);
// qsplit as fts_routed's; part_key / part_id: (B * cr * n_chunks * W, k).
extern "C" int fts_cluster_major(const void* q, const void* q_loc, const void* w,
                                 const void* u, const void* roster, const void* emb,
                                 int emb_kind, const void* scale, const void* loc,
                                 const void* ids, const void* attrs, const void* q_filt,
                                 const void* w_hat, int filtered, int B, int u_max, int qcap,
                                 int cr, int c, int cap, int d, int t, int k, float dist_max,
                                 int chunk_rows, int slots, int stages, int W,
                                 long long smem_bytes, void* work, int max_items, void* qsplit,
                                 void* part_key, void* part_id, void* out_s, void* out_i,
                                 void* stream) {
  const ScanArgs a = scan_args(q, q_loc, w, emb, scale, loc, ids, attrs, q_filt, w_hat, cap, d,
                               t, k, chunk_rows, slots, dist_max, part_key, part_id);
#define FTS_CM(T, F)                                                                          \
  cluster_major<T, F>(a, (const int*)u, (const int*)roster, u_max, qcap, cr, B * cr, c, B,    \
                      (int*)work, max_items, (uint16_t*)qsplit, stages, W,                     \
                      size_t(smem_bytes), (float*)out_s, (int*)out_i, (cudaStream_t)stream)
  switch (emb_kind * 2 + (filtered ? 1 : 0)) {
    case 0: return FTS_CM(float, false);
    case 1: return FTS_CM(float, true);
    case 2: return FTS_CM(__nv_bfloat16, false);
    case 3: return FTS_CM(__nv_bfloat16, true);
    case 4: return FTS_CM(int8_t, false);
    case 5: return FTS_CM(int8_t, true);
  }
#undef FTS_CM
  return int(cudaErrorInvalidValue);
}

// The engine scan's shared bytes for (d, k, element size, slots, stages, warpgroups):
// the layout the kernel computes, for the wrapper's mirror to be held against.
extern "C" long long fts_scan_smem(int d, int k, int elem, int slots, int stages, int W) {
  return (long long)scan_smem(d, k, elem, slots, stages, W).total;
}

// Gather path: cand (B, n, d) of emb_kind (int8 requires scale (B, n)),
// cand_loc (B, n, 2), cand_ids (B, n); outputs local positions (B, k).
// chunk_rows and smem_bytes from gather_launch_shape; work: one int32 (the
// work counter); part_key (B * n_chunks, k) int64.
extern "C" int fts_gather(const void* q, const void* q_loc, const void* w, const void* emb,
                          int emb_kind, const void* scale, const void* loc, const void* ids,
                          const void* w_hat, int B, int n, int d, int t, int k,
                          float dist_max, int chunk_rows, long long smem_bytes, void* work,
                          void* part_key, void* out_s, void* out_i, void* stream) {
  const ScanArgs a = scan_args(q, q_loc, w, emb, scale, loc, ids, nullptr, nullptr, w_hat, n,
                               d, t, k, chunk_rows, 1, dist_max, part_key, nullptr);
#define FTS_GATHER(T, DQ)                                                                     \
  gather<T, DQ>(a, B, (int*)work, size_t(smem_bytes), (float*)out_s, (int*)out_i,            \
                (cudaStream_t)stream)
  switch (emb_kind) {
    case 0: return FTS_GATHER(float, false);
    case 1: return FTS_GATHER(__nv_bfloat16, false);
    case 2: return FTS_GATHER(int8_t, true);
  }
#undef FTS_GATHER
  return int(cudaErrorInvalidValue);
}
