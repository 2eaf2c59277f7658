// Merge-path cross rank, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel merge_rank_pallas (tez_tpu/ops/pallas_kernels.py:76,
// body _merge_rank_kernel :61), which delegates to the search body
// _rank_search (tez_tpu/ops/device.py:436) under the comparator _lex_lt
// (:423).
//
// Computes, for each of M query rows, its rank in a sorted run of N rows
// under the composite order (u32 lanes, lane 0 most significant, then the
// u32 length; 0xFFFFFFFF is the pad sentinel's length).  count_equal = 0
// counts run rows < query, count_equal = 1 counts rows <= query; the
// asymmetry is what makes equal keys of two merged runs come out in run
// order.  W (lanes per row) is read at run time: the generic merge prepends
// the partition as one extra lane.
//
// Bound on this card: bytes.  The run and the queries are read once
// ((N + M) * (W + 1) * 4 B) and the ranks written once (M * 4 B); the
// comparisons are a few integer ops per probed lane.  In practice the
// search is limited by L2 traffic instead: every level of every query
// touches a lane row (a 12-byte row straddles two 32-byte sectors one time
// in four), so it runs far above the byte bound; reading the length only
// on a lane tie keeps most probes to the lane row.
//
// Design: one thread per query, a plain binary search over the run in
// global memory.  The Pallas kernel copied the whole run into VMEM for
// every 256-row block; here the run stays in device memory and the upper
// levels of every thread's search -- the same few rows for all queries --
// stay hot in the 50 MB L2.  Any M is allowed (the ragged edge is masked),
// so no small-M fallback is needed.  For W <= 8 (one compiled flavour per
// W) the query row sits in registers.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// -1 / 0 / +1 as run row r compares to the query (lanes, then length).
// The length lives in a second array and is read only on a lane tie.
template <int kW>
__device__ __forceinline__ int compare_row(const uint32_t* __restrict__ r,
                                           const uint32_t* __restrict__ rlen,
                                           const uint32_t* q, uint32_t qlen,
                                           int w) {
  const int lanes = kW > 0 ? kW : w;
#pragma unroll
  for (int k = 0; k < lanes; ++k) {
    uint32_t a = __ldg(r + k), b = q[k];
    if (a != b) return a < b ? -1 : 1;
  }
  uint32_t len = __ldg(rlen);
  return len < qlen ? -1 : (len > qlen ? 1 : 0);
}

// kW > 0: W known at compile time, query held in registers.
// kW == 0: any W, query read from global memory.
template <int kW>
__global__ void merge_rank_kernel(const uint32_t* __restrict__ run_lanes,
                                  const uint32_t* __restrict__ run_lens,
                                  int64_t n,
                                  const uint32_t* __restrict__ q_lanes,
                                  const uint32_t* __restrict__ q_lens,
                                  int64_t m, int w, int count_equal,
                                  int32_t* __restrict__ out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m) return;
  uint32_t qreg[kW > 0 ? kW : 1];
  const uint32_t* q = q_lanes + i * static_cast<int64_t>(w);
  if constexpr (kW > 0) {
#pragma unroll
    for (int k = 0; k < kW; ++k) qreg[k] = q[k];
    q = qreg;
  }
  uint32_t qlen = q_lens[i];
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    int c = compare_row<kW>(run_lanes + mid * w, run_lens + mid, q, qlen, w);
    bool before = count_equal ? c <= 0 : c < 0;
    if (before) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = static_cast<int32_t>(lo);
}

template <int kW>
void launch(const void* run_lanes, const void* run_lens, long long n,
            const void* q_lanes, const void* q_lens, long long m, int w,
            int count_equal, void* out, cudaStream_t s) {
  unsigned blocks = static_cast<unsigned>((m + kThreads - 1) / kThreads);
  merge_rank_kernel<kW><<<blocks, kThreads, 0, s>>>(
      static_cast<const uint32_t*>(run_lanes),
      static_cast<const uint32_t*>(run_lens), n,
      static_cast<const uint32_t*>(q_lanes),
      static_cast<const uint32_t*>(q_lens), m, w, count_equal,
      static_cast<int32_t*>(out));
}

}  // namespace

extern "C" int tez_merge_rank(const void* run_lanes, const void* run_lens,
                              long long n, const void* q_lanes,
                              const void* q_lens, long long m, int w,
                              int count_equal, void* out, void* stream) {
  if (m <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 1: launch<1>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, count_equal, out, s); break;
    case 2: launch<2>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, count_equal, out, s); break;
    case 3: launch<3>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, count_equal, out, s); break;
    case 4: launch<4>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, count_equal, out, s); break;
    case 5: launch<5>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, count_equal, out, s); break;
    case 6: launch<6>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, count_equal, out, s); break;
    case 7: launch<7>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, count_equal, out, s); break;
    case 8: launch<8>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, count_equal, out, s); break;
    default: launch<0>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, count_equal, out, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
