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
// What bounds the three scans on an H100: the bytes of the scanned live rows
// (an f32 768-wide row is 3 KB; a (query, row) pair is 2 flops per f32 byte
// read once, so even the random router's 181-pair hot cluster needs ~0.2 ms of
// f32 FMAs at 67 TFLOP/s against a 0.575 ms byte bound; a gather row serves one
// query). All run on the FP32 CUDA cores: TF32 tensor cores would round the
// operands to 10 mantissa bits and break the 1e-4 + 1e-5·|s| contract against
// the plain version, and the work is not operation-bound.
//
// The design (the tiled scan below), shared by all three:
// - A work item scores one chunk of 1024 rows of one cluster against up to
//   G query slots (G = 16 at the main path's k; launch_shape halves it to 8,
//   4, 2, 1 as k grows, so the slots' sorted lists still fit shared memory):
//   cluster-major, G roster slots of a distinct cluster of the batch plan;
//   routed, the pairs of one group of max(1, G / cr) queries that route to
//   one cluster; gather, one query's own candidate copy (a "cluster" of
//   capacity N that only query b reads), one slot. A hot cluster spreads over
//   many items instead of one serial walk, and an item reads its chunk once
//   for all its slots. Items are built on the device (slot groups or the
//   query groups' distinct clusters, then a prefix sum; gather items are
//   plain arithmetic, b * n_chunks + ch) and walked by persistent blocks
//   through an atomic counter; no host sync. Routed items run chunk-major
//   across the batch, so the groups reading one cluster chunk run together
//   and share it through L2.
// - Rows travel in their stored type (f32, bf16 or int8) through a cp.async
//   double buffer of 256 rows x 128 bytes (+ the slots' query floats for those
//   128 bytes); a tile that is all padding is skipped by its ids before any
//   of its rows is fetched, and so is each padding row. Rows are widened
//   (int8: dequantized, float(o) * scale) in registers.
// - Thread t owns row t of a tile and a register dot product per live slot
//   (a 1 x G tile): one row load and widening serve every slot, the slots'
//   query floats are warp-wide broadcasts, and no (query, row) pair pays a
//   warp reduction. The thread computes each of its pairs' spatial term and
//   filter test once.
// - Top-k: a pair enters its slot's candidate buffer only if its key beats
//   the slot's k-th key (a threshold in shared memory); twice per tile the
//   buffers are merged into the sorted lists by rank.
// - Each item writes one sorted partial list per slot and chunk; a merge
//   kernel (a warp per output row) folds them by key into (B, k) (routed,
//   gather: the scan position, which is the local position, in place of an
//   id) or (B * cr, k) pairs (cluster-major), which engine.merge_cluster_major
//   folds.
//
// Numerics: the spatial bucket uses IEEE sqrt and division with explicit
// _rn intrinsics (no contraction, no fast-math), so S_in, the bucket and
// w1 * srel are bit-identical to the reference; int8 is dequantized
// element-wise as float(o) * scale[row] before the dot product, like the
// reference. Only the order of the dot product's sum differs.

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

template <> struct Row<int8_t> {
  static constexpr int V = 16;
  // float(b) exactly, without a conversion instruction: byte b ^ 0x80 = b + 128
  // becomes the mantissa of 2^23 + b + 128, and 2^23 + 128 is subtracted.
  __device__ static void unpack(const uint4& r, float (&v)[16]) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u, r.z ^ 0x80808080u,
                           r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * i + j] =
            __fsub_rn(__uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7440u | j)), 8388736.f);
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

// ---- tiled scan: the routed, cluster-major and gather kernels -------------------
//
// A work item scores rows [r0, r0 + nrows) of one cluster buffer (one chunk)
// against up to G query slots (ScanArgs::slots), prepared in shared memory by
// the caller (query row, output row, scan-position offset, q_loc and weights,
// filter), and writes each live slot's sorted partial list of k keys (and ids,
// where part_id is given) to part_key/part_id row `out`. Thread t owns row t
// of every 256-row tile and a register dot product for each live slot: a
// 1 x G register tile.

constexpr int kTile = 256;                   // rows per tile: one row per thread
constexpr int kChunkBytes = 128;             // bytes of each row one stage holds
constexpr int kStages = 2;                   // the cp.async ring
constexpr int kCandCap = kTile / 2;          // candidates a slot takes per half tile
constexpr int kGroup = 16;                   // the most query slots of a work item
static_assert(kThreads == kTile, "one thread per row of a tile");

// Shared-memory layout of an item with G slots, in bytes (mirrored by
// launch_shape in kernels/fused_topk_score.py, which passes the total; the
// launcher checks it). A stage holds 256 rows x 128 bytes, 16-byte piece s of
// row r at piece s ^ (r & 7) (8 neighbouring rows read one piece each from 8
// bank groups), then the slots' query floats for the same 128 bytes of the row.
// Stages, candidate buffers and lists scale with G; the small per-slot fields
// keep kGroup entries, so their views sit at fixed offsets from one another.
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

struct ScanArgs {
  const float* q; const float* q_loc; const float* w; const void* emb;
  const float* scale; const float* loc; const int* ids; const int* attrs;
  const int* q_filt; const float* w_hat;
  int cap, d, t, k, chunk_rows, slots;
  float dist_max;
  uint64_t* part_key; int* part_id;
};

struct Slots {                                // views of an item's shared memory
  int* ids; int* tiles; uint64_t* cand; uint64_t* lists; uint64_t* thresh;
  long long* out; float4* par; int4* filt; int* q; int* nreal; int* sel; int* cand_n;
  int* pos;
  __device__ Slots(unsigned char* smem, const TileSmem& L)
      : ids(reinterpret_cast<int*>(smem + L.ids)),
        tiles(reinterpret_cast<int*>(smem + L.tiles)),
        cand(reinterpret_cast<uint64_t*>(smem + L.cand)),
        lists(reinterpret_cast<uint64_t*>(smem + L.lists)),
        thresh(reinterpret_cast<uint64_t*>(smem + L.thresh)),
        out(reinterpret_cast<long long*>(smem + L.out)),
        par(reinterpret_cast<float4*>(smem + L.par)),
        filt(reinterpret_cast<int4*>(smem + L.filt)),
        q(reinterpret_cast<int*>(smem + L.ints)), nreal(q + kGroup), sel(q + 2 * kGroup),
        cand_n(q + 3 * kGroup), pos(q + 4 * kGroup) {}
};

// slot j <- query row qrow (or -1: an empty slot), partial row out_row, scan
// positions pos0 + row
template <bool F>
__device__ __forceinline__ void set_slot(const Slots& S, const ScanArgs& a, int j, int qrow,
                                         long long out_row, int pos0) {
  S.q[j] = qrow;
  S.out[j] = out_row;
  S.pos[j] = pos0;
  if (qrow >= 0) {
    S.par[j] = make_float4(a.q_loc[2 * qrow], a.q_loc[2 * qrow + 1], a.w[2 * qrow],
                           a.w[2 * qrow + 1]);
    if (F)
      S.filt[j] = make_int4(a.q_filt[4 * qrow], a.q_filt[4 * qrow + 1],
                            a.q_filt[4 * qrow + 2], a.q_filt[4 * qrow + 3]);
  }
}

// an empty partial list (a route to no cluster): keys 0, ids -1
__device__ __forceinline__ void write_empty(const ScanArgs& a, long long out_row) {
  for (int e = threadIdx.x; e < a.k; e += blockDim.x) {
    a.part_key[out_row * a.k + e] = 0;
    a.part_id[out_row * a.k + e] = -1;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ bool passes3(int tenant, int cat, int ts, int4 f) {
  return (f.x < 0 || tenant == f.x) && (f.y == 0 || (cat & f.y) != 0) && ts >= f.z &&
         ts <= f.w;
}

// acc[j] += q_slot(j) . row(tid) over one stage (nsteps 16-byte pieces of the
// row) for the first NQL slots: one row load and its widening serve NQL slots,
// whose query floats are the same address for the whole warp (a broadcast).
template <typename T, bool DQ, int NQL, int MAXQ>
__device__ __forceinline__ void tile_dots(const unsigned char* rs, const float* qs, int nsteps,
                                          int tid, float sc, float (&acc)[MAXQ]) {
  constexpr int V = Row<T>::V;
  constexpr int kce = kChunkBytes / sizeof(T);
  const unsigned char* row = rs + tid * kChunkBytes;
  for (int ks = 0; ks < nsteps; ++ks) {
    float v[V];
    Row<T>::unpack(*reinterpret_cast<const uint4*>(row + ((ks ^ (tid & 7)) << 4)), v);
    if (DQ) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = __fmul_rn(v[e], sc);
    }
#pragma unroll
    for (int j = 0; j < NQL; ++j) {
      const float* qrow = qs + j * kce + ks * V;
#pragma unroll
      for (int e4 = 0; e4 < V / 4; ++e4) {
        const float4 qq = *reinterpret_cast<const float4*>(qrow + 4 * e4);
        acc[j] = fmaf(qq.x, v[4 * e4], acc[j]);
        acc[j] = fmaf(qq.y, v[4 * e4 + 1], acc[j]);
        acc[j] = fmaf(qq.z, v[4 * e4 + 2], acc[j]);
        acc[j] = fmaf(qq.w, v[4 * e4 + 3], acc[j]);
      }
    }
  }
}

// nql (1 + the last live slot) rounded up to 1, 2, 4, 8 or 16 slots
template <typename T, bool DQ, int MAXQ>
__device__ __forceinline__ void tile_dots_n(int nql, const unsigned char* rs, const float* qs,
                                            int nsteps, int tid, float sc,
                                            float (&acc)[MAXQ]) {
  if (MAXQ == 1) {
    tile_dots<T, DQ, 1>(rs, qs, nsteps, tid, sc, acc);
    return;
  }
  if (nql > 8) tile_dots<T, DQ, (MAXQ < 16 ? MAXQ : 16)>(rs, qs, nsteps, tid, sc, acc);
  else if (nql > 4) tile_dots<T, DQ, (MAXQ < 8 ? MAXQ : 8)>(rs, qs, nsteps, tid, sc, acc);
  else if (nql > 2) tile_dots<T, DQ, (MAXQ < 4 ? MAXQ : 4)>(rs, qs, nsteps, tid, sc, acc);
  else if (nql > 1) tile_dots<T, DQ, (MAXQ < 2 ? MAXQ : 2)>(rs, qs, nsteps, tid, sc, acc);
  else if (nql > 0) tile_dots<T, DQ, 1>(rs, qs, nsteps, tid, sc, acc);
}

// Merge each slot's candidates into its sorted list by rank (keys are unique):
// an entry's new rank is its rank among the list plus its rank among the
// candidates. Lists are double-buffered (sel); thresh becomes the k-th key.
__device__ void flush_candidates(const Slots& S, int k, int G) {
  const int tid = threadIdx.x;
  __syncthreads();                            // every push has landed
  for (int j = 0; j < G; ++j) {
    const int nc = S.cand_n[j];
    if (nc == 0) continue;
    const int nr = S.nreal[j];
    const uint64_t* cur = S.lists + (size_t(S.sel[j]) * G + j) * k;
    uint64_t* nxt = S.lists + (size_t(S.sel[j] ^ 1) * G + j) * k;
    const uint64_t* cj = S.cand + size_t(j) * kCandCap;
    for (int e = tid; e < nr + nc; e += kThreads) {
      const uint64_t x = e < nr ? cur[e] : cj[e - nr];
      int rank = 0;
      for (int m = 0; m < nc; ++m) rank += cj[m] > x;
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
  if (tid < G && S.cand_n[tid] > 0) {
    const int j = tid;
    const int nn = min(k, S.nreal[j] + S.cand_n[j]);
    S.nreal[j] = nn;
    S.sel[j] ^= 1;
    S.thresh[j] = nn == k ? S.lists[(size_t(S.sel[j]) * G + j) * k + k - 1] : 0;
    S.cand_n[j] = 0;
  }
  __syncthreads();
}

// MAXQ: the most slots the caller's items have (16 for the engine scans, 1
// for the gather scan, whose register tile is then one accumulator). GS: the
// slot count G when it is known at compile time (the engine scans at 16, the
// main path's k), else 0 and G = a.slots: a runtime G costs registers and
// made the routed scan 1-5% slower at k 20.
template <typename T, bool DQ, bool F, int MAXQ = kGroup, int GS = 0>
__device__ void scan_item(const ScanArgs& a, unsigned char* smem, const TileSmem& L,
                          const Slots& S, size_t base, int r0, int nrows) {
  constexpr int kce = kChunkBytes / sizeof(T);
  constexpr int kQSegs = kce / 4;            // 16-byte pieces of a slot's stage floats
  const int tid = threadIdx.x;
  const int k = a.k, G = GS ? GS : a.slots;

  // 1. the chunk's ids, its live tiles, empty lists
  for (int n = tid; n < nrows; n += kThreads) S.ids[n] = a.ids[base + r0 + n];
  if (tid < G) {
    S.nreal[tid] = 0;
    S.sel[tid] = 0;
    S.cand_n[tid] = 0;
    S.thresh[tid] = 0;
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
  int nql = 0;                               // 1 + the last live slot
  for (int j = 0; j < G; ++j)
    if (S.q[j] >= 0) nql = j + 1;
  __syncthreads();

  const int rowbytes = a.d * int(sizeof(T));
  const int nk = (rowbytes + kChunkBytes - 1) / kChunkBytes;
  const int steps = n_live * nk;
  const char* emb = static_cast<const char*>(a.emb);

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
      for (int e = tid; e < G * kQSegs; e += kThreads) {
        const int j = e / kQSegs, sg = e % kQSegs, qr = S.q[j];
        if (sg * 4 < qfloats && qr >= 0)
          cp_async16(qs + j * kce + sg * 4, a.q + size_t(qr) * a.d + kc * kce + sg * 4);
      }
    }
    cp_commit();
  };

  float acc[MAXQ];
#pragma unroll
  for (int j = 0; j < MAXQ; ++j) acc[j] = 0.f;
  float sc = 1.f;

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
    tile_dots_n<T, DQ, MAXQ>(nql, rs, reinterpret_cast<const float*>(rs + kTile * kChunkBytes),
                             bytes / 16, tid, sc, acc);
    if (kc != nk - 1) continue;

    // 3. the tile is scored: each thread scores its row's pairs once; the
    // candidates enter in two halves of the tile, so a slot takes <= 128
    const bool live = n < nrows && S.ids[n] >= 0;
    float ox = 0.f, oy = 0.f;
    int a0 = 0, a1 = 0, a2 = 0;
    if (live) {
      const size_t row = base + r0 + n;
      ox = a.loc[row * 2];
      oy = a.loc[row * 2 + 1];
      if (F) {
        a0 = a.attrs[row * 3];
        a1 = a.attrs[row * 3 + 1];
        a2 = a.attrs[row * 3 + 2];
      }
    }
    for (int half = 0; half < 2; ++half) {
      if (live && (tid / kCandCap) == half) {
#pragma unroll
        for (int j = 0; j < MAXQ; ++j) {
          if (j < nql && S.q[j] >= 0 && (!F || passes3(a0, a1, a2, S.filt[j]))) {
            const float4 p = S.par[j];
            const float sterm = spatial_term(p.x, p.y, ox, oy, p.w, a.dist_max, a.t, a.w_hat);
            const float stv = __fadd_rn(__fmul_rn(p.z, acc[j]), sterm);
            const uint64_t key = make_key(stv, uint32_t(S.pos[j] + r0 + n));
            if (key > S.thresh[j]) {
              const int c = atomicAdd(S.cand_n + j, 1);
              S.cand[size_t(j) * kCandCap + c] = key;
            }
          }
        }
      }
      flush_candidates(S, k, G);
    }
#pragma unroll
    for (int j = 0; j < MAXQ; ++j) acc[j] = 0.f;
  }
  cp_wait<0>();
  __syncthreads();

  // 4. one sorted partial list per live slot
  for (int j = 0; j < G; ++j) {
    if (S.q[j] < 0) continue;
    const long long o = S.out[j];
    const int nr = S.nreal[j];
    const uint64_t* cur = S.lists + (size_t(S.sel[j]) * G + j) * k;
    for (int e = tid; e < k; e += kThreads) {
      const uint64_t x = e < nr ? cur[e] : 0;
      a.part_key[o * k + e] = x;
      if (a.part_id) a.part_id[o * k + e] = x ? S.ids[int(key_pos(x)) - S.pos[j] - r0] : -1;
    }
  }
  __syncthreads();                           // the smem is the next item's
}

// ---- routed (query-major) kernels ---------------------------------------------
// Queries are taken in groups of qg = max(1, G / cr), so a group holds at most
// ent = max(G, cr) (query, route) pairs. Group grp's pairs p0 = grp * qg * cr,
// ... are split into entries: in order, each pair joins the first entry of its
// cluster that has a free slot, or opens a new one, so an entry is one cluster
// with at most G of the group's pairs (cr > G: one query, one entry per
// distinct cluster of its routes). gcount[grp] entries; an item is (chunk ch,
// group grp, entry dd) with slots = the entry's pairs, numbered chunk-major
// across the batch: item = ch * total + offsets[grp] + dd. Built on the device
// from top_c alone (no plan); kernels/fused_topk_score.py (routed_items) is
// the same arithmetic. Pair p's partial is row p * n_chunks + ch, scan
// positions (p % cr) * cap + row.

__global__ void routed_groups_kernel(const int* __restrict__ top_c, int n_pairs, int cr,
                                     int qg, int G, int ent, int* __restrict__ gcount,
                                     int* __restrict__ gcl, int* __restrict__ gslots) {
  const int grp = blockIdx.x * blockDim.x + threadIdx.x;
  if (size_t(grp) * qg * cr >= size_t(n_pairs)) return;
  const int p0 = grp * qg * cr, np = min(n_pairs - p0, qg * cr);
  int* cls = gcl + size_t(grp) * ent;
  int* slots = gslots + size_t(grp) * ent * G;
  int m = 0;
  if (ent <= kGroup) {            // the entries' clusters and fill in registers
    int mine[kGroup], fill[kGroup];
    for (int p = 0; p < np; ++p) {
      const int cl = top_c[p0 + p];
      int dd = 0;
      while (dd < m && !(mine[dd] == cl && fill[dd] < G)) ++dd;
      if (dd == m) {
        mine[m] = cl;
        fill[m] = 0;
        cls[m++] = cl;
        for (int j = 0; j < G; ++j) slots[size_t(dd) * G + j] = -1;
      }
      slots[size_t(dd) * G + fill[dd]++] = p0 + p;
    }
  } else {                        // one query's cr > G routes: entries in global memory
    for (int p = 0; p < np; ++p) {
      const int cl = top_c[p0 + p];
      int dd = 0;
      while (dd < m && !(cls[dd] == cl && slots[size_t(dd) * G + G - 1] < 0)) ++dd;
      int* row = slots + size_t(dd) * G;
      if (dd == m) {
        cls[m++] = cl;
        for (int j = 0; j < G; ++j) row[j] = -1;
      }
      int j = 0;
      while (row[j] >= 0) ++j;
      row[j] = p0 + p;
    }
  }
  gcount[grp] = m;
}

template <typename T, bool DQ, bool F, int GS>
__global__ void __launch_bounds__(kThreads, 2)
routed_kernel(ScanArgs a, const int* __restrict__ gcount, const int* __restrict__ gcl,
              const int* __restrict__ gslots, const int* __restrict__ offsets,
              int* __restrict__ counter, int n_groups, int ent, int cr, int c, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int item_s;
  const int G = GS ? GS : a.slots;
  const TileSmem L = tile_smem(a.chunk_rows, a.k, kChunkBytes / sizeof(T), G);
  const Slots S(smem, L);
  const int tid = threadIdx.x;
  const int per_chunk = offsets[n_groups];
  const int total = per_chunk * n_chunks;
  for (;;) {
    if (tid == 0) item_s = atomicAdd(counter, 1);
    __syncthreads();
    const int item = item_s;
    if (item >= total) return;
    const int ch = item / per_chunk, rem = item % per_chunk;
    int lo = 0, hi = n_groups;               // offsets[lo] <= rem < offsets[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (offsets[mid] <= rem) lo = mid; else hi = mid;
    }
    const size_t dd = size_t(lo) * ent + (rem - offsets[lo]);
    const int cl = gcl[dd];
    if (tid < G) {
      const int p = gslots[dd * G + tid];
      set_slot<F>(S, a, tid, p >= 0 ? p / cr : -1, p >= 0 ? (long long)p * n_chunks + ch : -1,
                  p >= 0 ? (p % cr) * a.cap : 0);
    }
    __syncthreads();
    if (cl < 0 || cl >= c) {                 // routes the kernel skips
      for (int j = 0; j < G; ++j)
        if (S.q[j] >= 0) write_empty(a, S.out[j]);
      __syncthreads();
      continue;
    }
    const int r0 = ch * a.chunk_rows;
    scan_item<T, DQ, F, kGroup, GS>(a, smem, L, S, size_t(cl) * a.cap, r0,
                                    min(a.chunk_rows, a.cap - r0));
  }
}

// ---- cluster-major kernels -----------------------------------------------------
// The items: distinct cluster i (u[i], roster row i) has groups[i] =
// ceil((last live slot + 1) / G) slot groups and n_chunks chunks, so
// groups[i] * n_chunks items, numbered from offsets[i], chunk-major:
// item offsets[i] + ch * groups[i] + g. kernels/fused_topk_score.py
// (cluster_major_items) is the same arithmetic on the host.

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

// one block of 1024: offsets[0..u_max] = exclusive prefix sum of groups * n_chunks;
// resets the work counter
__global__ void __launch_bounds__(1024)
offsets_kernel(const int* __restrict__ groups, int u_max, int n_chunks,
                  int* __restrict__ offsets, int* __restrict__ counter) {
  __shared__ int part[1024];
  const int tid = threadIdx.x;
  const int per = (u_max + 1023) / 1024;
  const int lo = min(u_max, tid * per), hi = min(u_max, lo + per);
  int sum = 0;
  for (int x = lo; x < hi; ++x) sum += groups[x] * n_chunks;
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
    offsets[x] = run;
    run += groups[x] * n_chunks;
  }
  if (tid == 1023) {
    offsets[u_max] = part[1023];
    *counter = 0;
  }
}

// persistent: each block takes the next item from the counter until none is left
template <typename T, bool DQ, bool F, int GS>
__global__ void __launch_bounds__(kThreads, 2)
cluster_major_kernel(ScanArgs a, const int* __restrict__ u, const int* __restrict__ roster,
                     const int* __restrict__ groups, const int* __restrict__ offsets,
                     int* __restrict__ counter, int u_max, int qcap, int cr, int n_total,
                     int c, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int item_s;
  const int G = GS ? GS : a.slots;
  const TileSmem L = tile_smem(a.chunk_rows, a.k, kChunkBytes / sizeof(T), G);
  const Slots S(smem, L);
  const int tid = threadIdx.x;
  const int total = offsets[u_max];
  for (;;) {
    if (tid == 0) item_s = atomicAdd(counter, 1);
    __syncthreads();
    const int item = item_s;
    if (item >= total) return;
    int lo = 0, hi = u_max;                  // offsets[lo] <= item < offsets[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (offsets[mid] <= item) lo = mid; else hi = mid;
    }
    const int gi = groups[lo], local = item - offsets[lo];
    const int ch = local / gi, g = local % gi;
    const int cl = u[lo];
    if (tid < G) {
      const int s = g * G + tid;
      const int o = s < qcap ? roster[size_t(lo) * qcap + s] : -1;
      const bool live = o >= 0 && o < n_total;
      set_slot<F>(S, a, tid, live ? o / cr : -1, live ? (long long)o * n_chunks + ch : -1, 0);
    }
    __syncthreads();
    if (cl < 0 || cl >= c) {                 // block-uniform: empty partials
      for (int j = 0; j < G; ++j)
        if (S.q[j] >= 0) write_empty(a, S.out[j]);
      __syncthreads();
      continue;
    }
    const int r0 = ch * a.chunk_rows;
    scan_item<T, DQ, F, kGroup, GS>(a, smem, L, S, size_t(cl) * a.cap, r0,
                                    min(a.chunk_rows, a.cap - r0));
  }
}

// ---- gather kernel -----------------------------------------------------------------
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
    if (tid == 0) set_slot<false>(S, a, 0, b, item, 0);
    __syncthreads();
    const int r0 = ch * a.chunk_rows;
    scan_item<T, DQ, false, 1>(a, smem, L, S, size_t(b) * a.cap, r0,
                               min(a.chunk_rows, a.cap - r0));
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
template <typename T>
bool shape_ok(const ScanArgs& a, size_t smem) {
  return a.chunk_rows > 0 && a.chunk_rows % kTile == 0 && a.slots >= 1 &&
         a.slots <= kGroup &&
         tile_smem(a.chunk_rows, a.k, kChunkBytes / sizeof(T), a.slots).total == smem;
}

// persistent blocks: as many as the card holds at once
template <typename K>
cudaError_t persistent_grid(K kernel, size_t smem, int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  grid = sms * per_sm;
  return cudaSuccess;
}

template <typename T, bool DQ, bool F>
cudaError_t routed(const ScanArgs& a, const int* top_c, int B, int cr, int c, int* work,
                   size_t smem, float* out_s, int* out_i, cudaStream_t stream) {
  if (!shape_ok<T>(a, smem) || cr < 1) return cudaErrorInvalidValue;
  const int G = a.slots;
  const int n_chunks = (a.cap + a.chunk_rows - 1) / a.chunk_rows;
  const int qg = max(1, G / cr), ent = max(G, cr), n_groups = (B + qg - 1) / qg;
  int* gcount = work;
  int* offsets = gcount + n_groups;
  int* counter = offsets + n_groups + 1;
  int* gcl = counter + 1;
  int* gslots = gcl + size_t(n_groups) * ent;
  routed_groups_kernel<<<(n_groups + 127) / 128, 128, 0, stream>>>(top_c, B * cr, cr, qg, G,
                                                                    ent, gcount, gcl, gslots);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  offsets_kernel<<<1, 1024, 0, stream>>>(gcount, n_groups, 1, offsets, counter);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  auto kernel =
      a.slots == kGroup ? routed_kernel<T, DQ, F, kGroup> : routed_kernel<T, DQ, F, 0>;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  int grid = 0;
  if ((e = persistent_grid(kernel, smem, grid)) != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a, gcount, gcl, gslots, offsets, counter, n_groups,
                                           ent, cr, c, n_chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return merge<false>(a, B, cr * n_chunks, out_s, out_i, stream);
}

template <typename T, bool DQ, bool F>
cudaError_t cluster_major(const ScanArgs& a, const int* u, const int* roster, int u_max,
                          int qcap, int cr, int n_total, int c, int* work, size_t smem,
                          float* out_s, int* out_i, cudaStream_t stream) {
  if (!shape_ok<T>(a, smem)) return cudaErrorInvalidValue;
  const int n_chunks = (a.cap + a.chunk_rows - 1) / a.chunk_rows;
  int* groups = work;
  int* offsets = work + u_max;
  int* counter = work + 2 * u_max + 1;
  cm_groups_kernel<<<u_max, kThreads, 0, stream>>>(roster, qcap, n_total, a.slots, groups);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  offsets_kernel<<<1, 1024, 0, stream>>>(groups, u_max, n_chunks, offsets, counter);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kernel = a.slots == kGroup ? cluster_major_kernel<T, DQ, F, kGroup>
                                   : cluster_major_kernel<T, DQ, F, 0>;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  int grid = 0;
  if ((e = persistent_grid(kernel, smem, grid)) != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a, u, roster, groups, offsets, counter, u_max, qcap,
                                           cr, n_total, c, n_chunks);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return merge<false>(a, n_total, n_chunks, out_s, out_i, stream);
}

template <typename T, bool DQ>
cudaError_t gather(const ScanArgs& a, int B, int* counter, size_t smem, float* out_s,
                   int* out_i, cudaStream_t stream) {
  if (!shape_ok<T>(a, smem) || a.slots != 1) return cudaErrorInvalidValue;
  const int n_chunks = (a.cap + a.chunk_rows - 1) / a.chunk_rows;
  cudaError_t e = cudaMemsetAsync(counter, 0, sizeof(int), stream);
  if (e != cudaSuccess) return e;
  auto kernel = gather_kernel<T, DQ>;
  if ((e = set_smem(kernel, smem)) != cudaSuccess) return e;
  int grid = 0;
  if ((e = persistent_grid(kernel, smem, grid)) != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(a, counter, B, n_chunks);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return merge<true>(a, B, n_chunks, out_s, out_i, stream);
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
// chunk_rows, slots (G) and smem_bytes come from launch_shape in
// kernels/fused_topk_score.py; part_key (int64) / part_id (int32) hold
// (B * cr * n_chunks, k) partial lists, n_chunks = ceil(cap / chunk_rows).
// work: int32 scratch of n_groups * (2 + ent + ent * G) + 2, ent = max(G, cr)
// (routed_groups in the wrapper).
extern "C" int fts_routed(const void* q, const void* q_loc, const void* w, const void* top_c,
                          const void* emb, int emb_kind, const void* scale, const void* loc,
                          const void* ids, const void* attrs, const void* q_filt,
                          const void* w_hat, int filtered, int B, int cr, int c, int cap, int d,
                          int t, int k, float dist_max, int chunk_rows, int slots,
                          long long smem_bytes, void* work, void* part_key, void* part_id,
                          void* out_s, void* out_i, void* stream) {
  const ScanArgs a = scan_args(q, q_loc, w, emb, scale, loc, ids, attrs, q_filt, w_hat, cap, d,
                               t, k, chunk_rows, slots, dist_max, part_key, part_id);
#define FTS_ROUTED(T, DQ, F)                                                                  \
  routed<T, DQ, F>(a, (const int*)top_c, B, cr, c, (int*)work, size_t(smem_bytes),          \
                   (float*)out_s, (int*)out_i, (cudaStream_t)stream)
  switch (emb_kind * 2 + (filtered ? 1 : 0)) {
    case 0: return FTS_ROUTED(float, false, false);
    case 1: return FTS_ROUTED(float, false, true);
    case 2: return FTS_ROUTED(__nv_bfloat16, false, false);
    case 3: return FTS_ROUTED(__nv_bfloat16, false, true);
    case 4: return FTS_ROUTED(int8_t, true, false);
    case 5: return FTS_ROUTED(int8_t, true, true);
  }
#undef FTS_ROUTED
  return int(cudaErrorInvalidValue);
}

// work: int32 scratch of 2 * u_max + 2 (slot groups, item offsets, work counter);
// part_key / part_id: (B * cr * n_chunks, k).
extern "C" int fts_cluster_major(const void* q, const void* q_loc, const void* w,
                                 const void* u, const void* roster, const void* emb,
                                 int emb_kind, const void* scale, const void* loc,
                                 const void* ids, const void* attrs, const void* q_filt,
                                 const void* w_hat, int filtered, int u_max, int qcap, int cr,
                                 int n_total, int c, int cap, int d, int t, int k,
                                 float dist_max, int chunk_rows, int slots,
                                 long long smem_bytes, void* work, void* part_key,
                                 void* part_id, void* out_s, void* out_i, void* stream) {
  const ScanArgs a = scan_args(q, q_loc, w, emb, scale, loc, ids, attrs, q_filt, w_hat, cap, d,
                               t, k, chunk_rows, slots, dist_max, part_key, part_id);
#define FTS_CM(T, DQ, F)                                                                      \
  cluster_major<T, DQ, F>(a, (const int*)u, (const int*)roster, u_max, qcap, cr, n_total, c,   \
                          (int*)work, size_t(smem_bytes), (float*)out_s, (int*)out_i,          \
                          (cudaStream_t)stream)
  switch (emb_kind * 2 + (filtered ? 1 : 0)) {
    case 0: return FTS_CM(float, false, false);
    case 1: return FTS_CM(float, false, true);
    case 2: return FTS_CM(__nv_bfloat16, false, false);
    case 3: return FTS_CM(__nv_bfloat16, false, true);
    case 4: return FTS_CM(int8_t, true, false);
    case 5: return FTS_CM(int8_t, true, true);
  }
#undef FTS_CM
  return int(cudaErrorInvalidValue);
}

// Gather path: cand (B, n, d) of emb_kind (int8 requires scale (B, n)),
// cand_loc (B, n, 2), cand_ids (B, n); outputs local positions (B, k).
// chunk_rows and smem_bytes from launch_shape(slots=1); work: one int32 (the
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
