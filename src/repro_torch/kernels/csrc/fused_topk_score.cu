// Fused spatio-textual score + running top-k for Hopper (sm_90a).
//
// Replaces the three Pallas kernels in src/repro/kernels/fused_topk_score.py:
//   fts_routed         <- fused_topk_score_routed          (query-major)
//   fts_cluster_major  <- fused_topk_score_cluster_major   (cluster-major)
//   fts_gather         <- fused_topk_score                 (gather path)
// The gather kernel is the routed kernel's scan over a candidate copy the
// caller materialized, (B, n, d) with per-query loc/ids (and int8 scales); it
// returns local positions in [0, n) instead of ids.
//
// All compute, for a query q and a resident object o of a routed cluster,
//   ST = w0 * (q . o) + w1 * w_hat[clip(int(S_in * t), 0, t - 1)],
//   S_in = 1 - clip(|q_loc - o_loc| / dist_max, 0, 1),
// skip padding rows (id < 0) and rows failing the filter predicate (the
// reference scores them NEG_INF with id -1, which is exactly what an unfilled
// output slot holds), and keep the top k by (score desc, scan position asc):
// the order jax.lax.top_k gives over the reference's [running list, tile]
// concatenation, so ids are deterministic.
//
// What bounds them on an H100: the bytes of the routed clusters' embedding
// rows (f32 768-wide rows are 3 KB, and a query does 2 flops per byte at f32).
// The design reads only live rows: a warp loads 32 ids at once, ballots the
// live ones and streams just those rows with 16-byte vector loads; int8 and
// bf16 rows are dequantized in registers, so only compressed bytes cross HBM.
// The cluster-major kernel additionally reads each tile of a distinct cluster
// once for up to 8 queries of its roster (one warp per roster slot), reading
// the query rows through the roster instead of a gathered payload copy.
//
// Running top-k: each warp owns a k-slot list in shared memory holding
// 64-bit keys (order-preserving score bits << 32 | ~position); a candidate
// enters only if it beats the list's current minimum, so after the first k
// rows almost every row costs one compare. At the end the lists are sorted
// by rank and (routed) merged across the 8 warps by binary search.
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
constexpr int kTileRows = 16;        // cluster-major: rows per shared tile
constexpr int kMaxD = 1024;          // query held in 8 float4 per lane
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

// ---- per-warp running top-k list --------------------------------------------

__device__ __forceinline__ void list_min(const uint64_t* slots, int k, int lane,
                                         uint64_t& min_key, int& min_slot) {
  uint64_t mk = ~0ull;
  int ms = 0;
  for (int s = lane; s < k; s += 32) {
    const uint64_t v = slots[s];
    if (v < mk) { mk = v; ms = s; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const uint64_t ok = __shfl_xor_sync(kFull, mk, off);
    const int os = __shfl_xor_sync(kFull, ms, off);
    if (ok < mk || (ok == mk && os < ms)) { mk = ok; ms = os; }
  }
  min_key = mk;
  min_slot = ms;
}

// every lane of the warp calls this with the same key
__device__ __forceinline__ void list_push(uint64_t* slots, int k, int lane, uint64_t key,
                                          uint64_t& min_key, int& min_slot) {
  if (key > min_key) {
    if (lane == 0) slots[min_slot] = key;
    __syncwarp();
    list_min(slots, k, lane, min_key, min_slot);
    __syncwarp();
  }
}

// sorted[0, n) = the list's real keys, descending; sorted[n, k) = 0. Returns n.
__device__ int list_sort(const uint64_t* slots, uint64_t* sorted, int k, int lane) {
  int n = 0;
  for (int s = lane; s < k; s += 32) {
    const uint64_t v = slots[s];
    if (v) {
      int rank = 0;
      for (int j = 0; j < k; ++j) rank += slots[j] > v;   // keys are unique
      sorted[rank] = v;
      ++n;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(kFull, n, off);
  __syncwarp();
  for (int s = n + lane; s < k; s += 32) sorted[s] = 0;
  __syncwarp();
  return n;
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
  __device__ static void unpack(const uint4& r, float (&v)[16]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * i + j] = float(int8_t((w[i] >> (8 * j)) & 0xffu));
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// one lane's share of q . row, the query in shared memory as floats
template <typename T, bool DEQUANT>
__device__ __forceinline__ float dot_row(const T* __restrict__ row, const float* qs, int d,
                                         int lane, float scale) {
  constexpr int V = Row<T>::V;
  const uint4* rv = reinterpret_cast<const uint4*>(row);
  float acc = 0.f;
  for (int c = lane; c < d / V; c += 32) {
    float v[V];
    Row<T>::unpack(__ldg(rv + c), v);
    const float4* q4 = reinterpret_cast<const float4*>(qs + c * V);
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const float4 qq = q4[j];
      float e0 = v[4 * j], e1 = v[4 * j + 1], e2 = v[4 * j + 2], e3 = v[4 * j + 3];
      if (DEQUANT) {
        e0 = __fmul_rn(e0, scale); e1 = __fmul_rn(e1, scale);
        e2 = __fmul_rn(e2, scale); e3 = __fmul_rn(e3, scale);
      }
      acc = fmaf(qq.x, e0, acc); acc = fmaf(qq.y, e1, acc);
      acc = fmaf(qq.z, e2, acc); acc = fmaf(qq.w, e3, acc);
    }
  }
  return acc;
}

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

__device__ __forceinline__ bool passes(const int* __restrict__ a, int4 f) {
  const int tenant = a[0], cat = a[1], ts = a[2];
  return (f.x < 0 || tenant == f.x) && (f.y == 0 || (cat & f.y) != 0) &&
         ts >= f.z && ts <= f.w;
}

// ---- query-major scan: shared by the routed and the gather kernels ------------

// Warp `warp` of the block scans the 32-row chunks warp, warp+8, ... of the
// `rows` rows at `base` (one routed cluster, or one query's candidate copy) and
// pushes each live row's score into its list, keyed by scan position pos0+row.
template <typename T, bool DEQUANT, bool FILTERED>
__device__ __forceinline__ void scan_rows(
    const T* __restrict__ emb, const float* __restrict__ scale,
    const float* __restrict__ loc, const int* __restrict__ ids,
    const int* __restrict__ attrs, int4 f, size_t base, int rows, uint32_t pos0,
    const float* qs, float qx, float qy, float w0, float w1, int d, int t,
    float dist_max, const float* __restrict__ w_hat, int warp, int lane,
    uint64_t* mine, int k, uint64_t& min_key, int& min_slot) {
  const int n_chunks = (rows + 31) / 32;
  for (int ch = warp; ch < n_chunks; ch += kWarps) {
    const int n = ch * 32 + lane;
    bool live = false;
    float sterm = 0.f;
    if (n < rows) {
      live = ids[base + n] >= 0;
      if (FILTERED && live) live = passes(attrs + (base + n) * 3, f);
      if (live)
        sterm = spatial_term(qx, qy, loc[(base + n) * 2], loc[(base + n) * 2 + 1], w1,
                             dist_max, t, w_hat);
    }
    unsigned todo = __ballot_sync(kFull, live);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      const int row = ch * 32 + j;
      const float sc = DEQUANT ? scale[base + row] : 1.f;
      const float trel = warp_sum(dot_row<T, DEQUANT>(emb + (base + row) * size_t(d), qs, d, lane, sc));
      const float st = __fadd_rn(__fmul_rn(w0, trel), __shfl_sync(kFull, sterm, j));
      list_push(mine, k, lane, make_key(st, pos0 + uint32_t(row)), min_key, min_slot);
    }
  }
}

// Merge the 8 warp lists into out_s/out_i[0, k) (this block's output row):
// sort each, then rank every entry by binary search in the others. The slot
// of a real entry gets id_of(scan position); slots past the last real entry
// get (NEG_INF, -1).
template <typename IdOf>
__device__ __forceinline__ void merge_warp_lists(const uint64_t* mine, uint64_t* sorted,
                                                 int* n_real, int k, int warp, int lane,
                                                 int tid, float* __restrict__ out_s,
                                                 int* __restrict__ out_i, IdOf id_of) {
  const int n_mine = list_sort(mine, sorted + warp * k, k, lane);
  if (lane == 0) n_real[warp] = n_mine;
  __syncthreads();
  int total = 0;
  for (int o = 0; o < kWarps; ++o) total += n_real[o];
  for (int e = tid; e < kWarps * k; e += kThreads) {
    const int ow = e / k, j = e % k;
    if (j >= n_real[ow]) continue;
    const uint64_t key = sorted[e];
    int rank = j;
    for (int o = 0; o < kWarps; ++o) {
      if (o == ow) continue;
      const uint64_t* so = sorted + o * k;
      int lo = 0, hi = n_real[o];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (so[mid] > key) lo = mid + 1; else hi = mid;
      }
      rank += lo;
    }
    if (rank < k) {
      out_s[rank] = key_score(key);
      out_i[rank] = id_of(key_pos(key));
    }
  }
  for (int s = total + tid; s < k; s += kThreads) {
    out_s[s] = kNegInf;
    out_i[s] = -1;
  }
}

// ---- routed (query-major) kernel ---------------------------------------------
// grid (B); block 256. The block scans its query's cr routed clusters; warp w
// takes the 32-row chunks w, w+8, ... of each cluster.

template <typename T, bool DEQUANT, bool FILTERED>
__global__ void __launch_bounds__(kThreads)
routed_kernel(const float* __restrict__ q, const float* __restrict__ q_loc,
              const float* __restrict__ w, const int* __restrict__ top_c,
              const T* __restrict__ emb, const float* __restrict__ scale,
              const float* __restrict__ loc, const int* __restrict__ ids,
              const int* __restrict__ attrs, const int* __restrict__ q_filt,
              const float* __restrict__ w_hat, int cr, int c, int cap, int d, int t,
              int k, float dist_max, float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + align16(size_t(d) * 4));
  uint64_t* sorted = lists + kWarps * k;
  int* n_real = reinterpret_cast<int*>(sorted + kWarps * k);

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < d; i += kThreads) qs[i] = q[size_t(b) * d + i];
  const float qx = q_loc[2 * b], qy = q_loc[2 * b + 1];
  const float w0 = w[2 * b], w1 = w[2 * b + 1];
  int4 f = make_int4(0, 0, 0, 0);
  if (FILTERED) f = make_int4(q_filt[4 * b], q_filt[4 * b + 1], q_filt[4 * b + 2], q_filt[4 * b + 3]);
  uint64_t* mine = lists + warp * k;
  for (int s = lane; s < k; s += 32) mine[s] = 0;
  uint64_t min_key = 0;
  int min_slot = 0;
  __syncthreads();

  for (int r = 0; r < cr; ++r) {
    const int cl = top_c[b * cr + r];
    if (cl < 0 || cl >= c) continue;
    scan_rows<T, DEQUANT, FILTERED>(emb, scale, loc, ids, attrs, f, size_t(cl) * cap, cap,
                                    uint32_t(r * cap), qs, qx, qy, w0, w1, d, t, dist_max,
                                    w_hat, warp, lane, mine, k, min_key, min_slot);
  }
  merge_warp_lists(mine, sorted, n_real, k, warp, lane, tid, out_s + size_t(b) * k,
                   out_i + size_t(b) * k, [&](uint32_t pos) {
                     const int r = pos / cap, row = pos % cap;
                     return ids[size_t(top_c[b * cr + r]) * cap + row];
                   });
}

// ---- gather kernel ---------------------------------------------------------------
// grid (B); block 256. The routed kernel's scan over one query's materialized
// candidate copy (n rows at b * n): the same helpers, so a row scores
// bit-identically in both. Outputs local positions in [0, n), not ids.

template <typename T, bool DEQUANT>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ q, const float* __restrict__ q_loc,
              const float* __restrict__ w, const T* __restrict__ emb,
              const float* __restrict__ scale, const float* __restrict__ loc,
              const int* __restrict__ ids, const float* __restrict__ w_hat, int n, int d,
              int t, int k, float dist_max, float* __restrict__ out_s,
              int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + align16(size_t(d) * 4));
  uint64_t* sorted = lists + kWarps * k;
  int* n_real = reinterpret_cast<int*>(sorted + kWarps * k);

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < d; i += kThreads) qs[i] = q[size_t(b) * d + i];
  uint64_t* mine = lists + warp * k;
  for (int s = lane; s < k; s += 32) mine[s] = 0;
  uint64_t min_key = 0;
  int min_slot = 0;
  __syncthreads();

  scan_rows<T, DEQUANT, false>(emb, scale, loc, ids, nullptr, make_int4(0, 0, 0, 0),
                               size_t(b) * n, n, 0u, qs, q_loc[2 * b], q_loc[2 * b + 1],
                               w[2 * b], w[2 * b + 1], d, t, dist_max, w_hat, warp, lane,
                               mine, k, min_key, min_slot);
  merge_warp_lists(mine, sorted, n_real, k, warp, lane, tid, out_s + size_t(b) * k,
                   out_i + size_t(b) * k, [](uint32_t pos) { return int(pos); });
}

// ---- cluster-major kernel ------------------------------------------------------
// grid (ceil(qcap / 8), u_max); block 256. Block (x, i) scores distinct cluster
// u[i] against roster slots [8x, 8x + 8); warp w owns slot 8x + w and reads its
// query row q[roster / cr] directly. Tiles of 16 rows are staged in shared
// memory as f32 (dequantized once) and shared by the 8 warps. The partial list
// of a slot is written to out[roster value]: one row per (query, route) pair.

template <typename T, bool DEQUANT, bool FILTERED>
__global__ void __launch_bounds__(kThreads)
cluster_major_kernel(const float* __restrict__ q, const float* __restrict__ q_loc,
                     const float* __restrict__ w, const int* __restrict__ u,
                     const int* __restrict__ roster, const T* __restrict__ emb,
                     const float* __restrict__ scale, const float* __restrict__ loc,
                     const int* __restrict__ ids, const int* __restrict__ attrs,
                     const int* __restrict__ q_filt, const float* __restrict__ w_hat,
                     int qcap, int cr, int n_total, int c, int cap, int d, int t, int k,
                     float dist_max, float* __restrict__ out_s, int* __restrict__ out_i) {
  constexpr int V = Row<T>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  size_t off = align16(size_t(kTileRows) * d * 4);
  int* t_ids = reinterpret_cast<int*>(smem + off);
  off += align16(kTileRows * 4);
  float* t_loc = reinterpret_cast<float*>(smem + off);
  off += align16(kTileRows * 8);
  int* t_attr = reinterpret_cast<int*>(smem + off);
  off += align16(kTileRows * 12);
  uint64_t* lists = reinterpret_cast<uint64_t*>(smem + off);
  uint64_t* sorted = lists + kWarps * k;

  const int i = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot = blockIdx.x * kWarps + warp;
  const int o = slot < qcap ? roster[size_t(i) * qcap + slot] : n_total;
  const bool live = o >= 0 && o < n_total;
  if (!__syncthreads_or(live)) return;              // empty part of the roster
  const int cl = u[i];
  if (cl < 0 || cl >= c) return;                    // block-uniform

  const int qrow = live ? o / cr : 0;
  const float qx = q_loc[2 * qrow], qy = q_loc[2 * qrow + 1];
  const float w0 = w[2 * qrow], w1 = w[2 * qrow + 1];
  int4 f = make_int4(0, 0, 0, 0);
  if (FILTERED)
    f = make_int4(q_filt[4 * qrow], q_filt[4 * qrow + 1], q_filt[4 * qrow + 2], q_filt[4 * qrow + 3]);
  float4 qr[kMaxD / 128];
  const int d4 = d / 4;
#pragma unroll
  for (int m = 0; m < kMaxD / 128; ++m) {
    const int cidx = lane + 32 * m;
    qr[m] = cidx < d4 ? reinterpret_cast<const float4*>(q + size_t(qrow) * d)[cidx]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  uint64_t* mine = lists + warp * k;
  for (int s = lane; s < k; s += 32) mine[s] = 0;
  uint64_t min_key = 0;
  int min_slot = 0;

  const size_t base = size_t(cl) * cap;
  const int dv = d / V;
  for (int n0 = 0; n0 < cap; n0 += kTileRows) {
    bool row_live = false;
    if (tid < kTileRows) {
      const int n = n0 + tid;
      const int id = n < cap ? ids[base + n] : -1;
      t_ids[tid] = id;
      row_live = id >= 0;
      if (row_live) {
        t_loc[2 * tid] = loc[(base + n) * 2];
        t_loc[2 * tid + 1] = loc[(base + n) * 2 + 1];
        if (FILTERED) {
          t_attr[3 * tid] = attrs[(base + n) * 3];
          t_attr[3 * tid + 1] = attrs[(base + n) * 3 + 1];
          t_attr[3 * tid + 2] = attrs[(base + n) * 3 + 2];
        }
      }
    }
    if (!__syncthreads_or(row_live)) continue;      // an all-padding tile
    for (int e = tid; e < kTileRows * dv; e += kThreads) {
      const int rr = e / dv, cc = e % dv;
      if (t_ids[rr] < 0) continue;                  // padding rows are never read
      const size_t row = base + n0 + rr;
      float v[V];
      Row<T>::unpack(__ldg(reinterpret_cast<const uint4*>(emb + row * d) + cc), v);
      if (DEQUANT) {
        const float sc = scale[row];
#pragma unroll
        for (int j = 0; j < V; ++j) v[j] = __fmul_rn(v[j], sc);
      }
      float4* dst = reinterpret_cast<float4*>(tile + size_t(rr) * d + cc * V);
#pragma unroll
      for (int j = 0; j < V / 4; ++j)
        dst[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
    __syncthreads();
    if (live) {
      for (int rr = 0; rr < kTileRows; ++rr) {
        if (t_ids[rr] < 0) continue;
        if (FILTERED && !passes(t_attr + 3 * rr, f)) continue;
        const float4* row4 = reinterpret_cast<const float4*>(tile + size_t(rr) * d);
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < kMaxD / 128; ++m) {
          const int cidx = lane + 32 * m;
          if (cidx < d4) {
            const float4 e = row4[cidx];
            acc = fmaf(qr[m].x, e.x, acc); acc = fmaf(qr[m].y, e.y, acc);
            acc = fmaf(qr[m].z, e.z, acc); acc = fmaf(qr[m].w, e.w, acc);
          }
        }
        const float trel = warp_sum(acc);
        const float sterm = spatial_term(qx, qy, t_loc[2 * rr], t_loc[2 * rr + 1], w1,
                                         dist_max, t, w_hat);
        const float st = __fadd_rn(__fmul_rn(w0, trel), sterm);
        list_push(mine, k, lane, make_key(st, uint32_t(n0 + rr)), min_key, min_slot);
      }
    }
    __syncthreads();
  }

  if (live) {
    uint64_t* out = sorted + warp * k;
    list_sort(mine, out, k, lane);
    for (int s = lane; s < k; s += 32) {
      const uint64_t key = out[s];
      out_s[size_t(o) * k + s] = key ? key_score(key) : kNegInf;
      out_i[size_t(o) * k + s] = key ? ids[base + key_pos(key)] : -1;
    }
  }
}

// ---- launchers ------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

template <typename T, bool DQ, bool F>
cudaError_t routed(const float* q, const float* q_loc, const float* w, const int* top_c,
                   const void* emb, const float* scale, const float* loc, const int* ids,
                   const int* attrs, const int* q_filt, const float* w_hat, int B, int cr,
                   int c, int cap, int d, int t, int k, float dist_max, float* out_s,
                   int* out_i, cudaStream_t stream) {
  const size_t smem = align16(size_t(d) * 4) + 2 * size_t(kWarps) * k * 8 + kWarps * 4;
  cudaError_t e = set_smem(routed_kernel<T, DQ, F>, smem);
  if (e != cudaSuccess) return e;
  routed_kernel<T, DQ, F><<<B, kThreads, smem, stream>>>(
      q, q_loc, w, top_c, static_cast<const T*>(emb), scale, loc, ids, attrs, q_filt, w_hat,
      cr, c, cap, d, t, k, dist_max, out_s, out_i);
  return cudaGetLastError();
}

template <typename T, bool DQ>
cudaError_t gather(const float* q, const float* q_loc, const float* w, const void* emb,
                   const float* scale, const float* loc, const int* ids, const float* w_hat,
                   int B, int n, int d, int t, int k, float dist_max, float* out_s,
                   int* out_i, cudaStream_t stream) {
  const size_t smem = align16(size_t(d) * 4) + 2 * size_t(kWarps) * k * 8 + kWarps * 4;
  cudaError_t e = set_smem(gather_kernel<T, DQ>, smem);
  if (e != cudaSuccess) return e;
  gather_kernel<T, DQ><<<B, kThreads, smem, stream>>>(
      q, q_loc, w, static_cast<const T*>(emb), scale, loc, ids, w_hat, n, d, t, k, dist_max,
      out_s, out_i);
  return cudaGetLastError();
}

template <typename T, bool DQ, bool F>
cudaError_t cluster_major(const float* q, const float* q_loc, const float* w, const int* u,
                          const int* roster, const void* emb, const float* scale,
                          const float* loc, const int* ids, const int* attrs,
                          const int* q_filt, const float* w_hat, int u_max, int qcap, int cr,
                          int n_total, int c, int cap, int d, int t, int k, float dist_max,
                          float* out_s, int* out_i, cudaStream_t stream) {
  const size_t smem = align16(size_t(kTileRows) * d * 4) + align16(kTileRows * 4) +
                      align16(kTileRows * 8) + align16(kTileRows * 12) +
                      2 * size_t(kWarps) * k * 8;
  cudaError_t e = set_smem(cluster_major_kernel<T, DQ, F>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((qcap + kWarps - 1) / kWarps, u_max);
  cluster_major_kernel<T, DQ, F><<<grid, kThreads, smem, stream>>>(
      q, q_loc, w, u, roster, static_cast<const T*>(emb), scale, loc, ids, attrs, q_filt,
      w_hat, qcap, cr, n_total, c, cap, d, t, k, dist_max, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace

// emb_kind: 0 = float32, 1 = bfloat16, 2 = int8 (requires scale: the dequant body)
extern "C" int fts_routed(const void* q, const void* q_loc, const void* w, const void* top_c,
                          const void* emb, int emb_kind, const void* scale, const void* loc,
                          const void* ids, const void* attrs, const void* q_filt,
                          const void* w_hat, int filtered, int B, int cr, int c, int cap, int d,
                          int t, int k, float dist_max, void* out_s, void* out_i,
                          void* stream) {
#define FTS_ROUTED(T, DQ, F)                                                                  \
  routed<T, DQ, F>((const float*)q, (const float*)q_loc, (const float*)w, (const int*)top_c, \
                   emb, (const float*)scale, (const float*)loc, (const int*)ids,            \
                   (const int*)attrs, (const int*)q_filt, (const float*)w_hat, B, cr, c,    \
                   cap, d, t, k, dist_max, (float*)out_s, (int*)out_i, (cudaStream_t)stream)
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

extern "C" int fts_cluster_major(const void* q, const void* q_loc, const void* w,
                                 const void* u, const void* roster, const void* emb,
                                 int emb_kind, const void* scale, const void* loc,
                                 const void* ids, const void* attrs, const void* q_filt,
                                 const void* w_hat, int filtered, int u_max, int qcap, int cr,
                                 int n_total, int c, int cap, int d, int t, int k,
                                 float dist_max, void* out_s, void* out_i, void* stream) {
#define FTS_CM(T, DQ, F)                                                                      \
  cluster_major<T, DQ, F>((const float*)q, (const float*)q_loc, (const float*)w,               \
                          (const int*)u, (const int*)roster, emb, (const float*)scale,         \
                          (const float*)loc, (const int*)ids, (const int*)attrs,               \
                          (const int*)q_filt, (const float*)w_hat, u_max, qcap, cr, n_total,   \
                          c, cap, d, t, k, dist_max, (float*)out_s, (int*)out_i,               \
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
extern "C" int fts_gather(const void* q, const void* q_loc, const void* w, const void* emb,
                          int emb_kind, const void* scale, const void* loc, const void* ids,
                          const void* w_hat, int B, int n, int d, int t, int k,
                          float dist_max, void* out_s, void* out_i, void* stream) {
#define FTS_GATHER(T, DQ)                                                                     \
  gather<T, DQ>((const float*)q, (const float*)q_loc, (const float*)w, emb,                  \
                (const float*)scale, (const float*)loc, (const int*)ids, (const float*)w_hat, \
                B, n, d, t, k, dist_max, (float*)out_s, (int*)out_i, (cudaStream_t)stream)
  switch (emb_kind) {
    case 0: return FTS_GATHER(float, false);
    case 1: return FTS_GATHER(__nv_bfloat16, false);
    case 2: return FTS_GATHER(int8_t, true);
  }
#undef FTS_GATHER
  return int(cudaErrorInvalidValue);
}
