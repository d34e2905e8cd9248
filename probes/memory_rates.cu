// Memory read-rate probes for chip_smoke.py (sm_90a). A measurement aid, not
// part of the port: no module of src/repro_torch builds or calls them.
//
// They set the denominator of embedding bag's L2 bound. Its 39,060 x 128 f32
// table (20 MB) stays in the 50 MB L2, so each (bag, index) pair's 512-byte
// row read is L2 traffic and the least time for the work is the gathered
// bytes over the rate the L2 can deliver. Two probes, each in a few variants;
// chip_smoke.py keeps the best rate any of them (or the kernel itself) shows:
//
// stream_read: the grid reads a buffer of n4 float4s `passes` times with
//   ld.global.cg (L2, not L1), LOADS independent 16-byte loads in flight per
//   thread, each pass starting at another offset. Over a buffer that fits in
//   L2 it reads L2; over one far larger, HBM.
// row_gather_read: embedding bag's own access pattern without the bags: the
//   rows table[idx[i]] (d4 float4s each) for i in [0, n), in the kernel's
//   order and with its load (ld.global.nc), a warp per ROWS rows, all ROWS
//   rows' loads issued before any is summed.
//
// Both keep one partial sum per thread in `out` so that no load is dead, and
// launch as many 256-thread blocks as fit on the card at once (at most
// out_len / 256), each walking the work with a grid stride.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int LOADS>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float4* __restrict__ buf, int n4, int passes, float* __restrict__ out) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x, nt = gridDim.x * blockDim.x;
  float acc = 0.f;
  for (int p = 0; p < passes; ++p) {
    const int off = int((long long)p * 65537 % n4);
    for (int i0 = tid; i0 < n4; i0 += LOADS * nt) {
      float4 v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * nt;
        int j = i + off;
        if (j >= n4) j -= n4;
        v[u] = i < n4 ? __ldcg(buf + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) acc += (v[u].x + v[u].y) + (v[u].z + v[u].w);
    }
  }
  out[tid] = acc;
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const float4* __restrict__ table, const int* __restrict__ idx, int n, int d4,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  float acc = 0.f;
  for (int base = warp * ROWS; base < n; base += n_warps * ROWS) {   // warp-uniform
    const int mine = lane < ROWS && base + lane < n ? __ldg(idx + base + lane) : -1;
    int rows[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) rows[r] = __shfl_sync(0xffffffffu, mine, r);
    for (int c = lane; c < d4; c += 32) {
      float4 v[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        v[r] = rows[r] >= 0 ? __ldg(table + size_t(rows[r]) * d4 + c)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc += (v[r].x + v[r].y) + (v[r].z + v[r].w);
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

// blocks of the kernel resident on the whole card at once, capped by out_len
template <typename K>
int full_grid(K kernel, int out_len) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int grid = sms * (per_sm > 0 ? per_sm : 1);
  return grid < out_len / kThreads ? grid : out_len / kThreads;
}

template <int LOADS>
int launch_stream(const void* buf, int n4, int passes, float* out, int out_len, cudaStream_t s) {
  const int grid = full_grid(stream_kernel<LOADS>, out_len);
  stream_kernel<LOADS><<<grid, kThreads, 0, s>>>(static_cast<const float4*>(buf), n4, passes, out);
  return grid;
}

template <int ROWS>
int launch_gather(const void* table, const int* idx, int n, int d4, float* out, int out_len,
                  cudaStream_t s) {
  const int grid = full_grid(row_gather_kernel<ROWS>, out_len);
  row_gather_kernel<ROWS><<<grid, kThreads, 0, s>>>(static_cast<const float4*>(table), idx, n,
                                                    d4, out);
  return grid;
}

}  // namespace

// buf: n4 float4s, 16-byte aligned; loads: 8 or 16. *grid gets the blocks
// launched. Returns the cudaError of the launch (-1: unknown variant).
extern "C" int stream_read(const void* buf, int n4, int passes, int loads, void* out,
                           int out_len, void* stream, int* grid) {
  const auto s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (loads) {
    case 8: *grid = launch_stream<8>(buf, n4, passes, o, out_len, s); break;
    case 16: *grid = launch_stream<16>(buf, n4, passes, o, out_len, s); break;
    default: return -1;
  }
  return int(cudaGetLastError());
}

// table: rows of d4 float4s, 16-byte aligned; idx: n int32 row numbers, each
// in [0, rows of table); rows: rows in flight per warp, 4, 8 or 16.
extern "C" int row_gather_read(const void* table, const int* idx, int n, int d4, int rows,
                               void* out, int out_len, void* stream, int* grid) {
  const auto s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  switch (rows) {
    case 4: *grid = launch_gather<4>(table, idx, n, d4, o, out_len, s); break;
    case 8: *grid = launch_gather<8>(table, idx, n, d4, o, out_len, s); break;
    case 16: *grid = launch_gather<16>(table, idx, n, d4, o, out_len, s); break;
    default: return -1;
  }
  return int(cudaGetLastError());
}
