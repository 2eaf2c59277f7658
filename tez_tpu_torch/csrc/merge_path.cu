// Merge-path pair merge, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel merge_rank_pallas (tez_tpu/ops/pallas_kernels.py:76)
// together with the scatter around it in _merge_path_pair
// (tez_tpu/ops/device.py:489): there, one merge level ranks every row of run
// A in run B (rows < it) and every row of B in A (rows <= it), then scatters
// lanes, lengths and the index column of both runs to i + rank.  Here the same
// permutation is computed as one merge (Green, McColl & Bader, "GPU Merge
// Path", 2012).
//
// Rows are ordered by the composite comparator of the port's sorts: u32 lanes,
// lane 0 most significant, then the u32 length (0xFFFFFFFF is the pad
// sentinel's length).  Both runs are sorted under it.  Ties go to A, which is
// exactly the </<= rank pair: pos(a_i) = i + |{b < a_i}| and
// pos(b_j) = j + |{a <= b_j}|.  Sentinel rows take part like any other row,
// so an A sentinel i lands at i + (real rows of B) and a B sentinel j at
// j + na, and the output is again a sorted run with every real row first.
//
// Two launches:
//   1. partition: for every output-tile boundary d = t * tile, a search on
//      diagonal d for i(d), the number of A rows among the first d outputs,
//      written to splits[t];
//   2. tile merge: one CTA per output tile.  A[i0:i1] and B[j0:j1], exactly
//      `count` rows together, are staged in shared memory; each thread
//      repeats the diagonal search in shared memory for its own first output
//      row, then merges rows_per_thread rows sequentially, writing only the
//      source of each output row; the CTA then stores lanes, lengths and
//      indices with coalesced 16-byte stores, gathering each word from shared
//      memory through the source list.
//
// Bound on this card: bytes.  Each input row is read once and each output row
// written once, 2 * (na + nb) * (4W + 8) bytes; the splits array and the
// comparisons are small beside that.  Two cross ranks as one binary search
// per query in global memory, which the ladder ran before, are limited by L2
// sector traffic: every one of ~25 dependent probes of every query reads a
// lane row.  Here only the tile boundaries search device memory; every other
// comparison reads shared memory, and device memory sees one coalesced pass
// in and one out.  What the design does to stay near that bound:
//   * the staging uses cp.async, so a thread's loads are all in flight at
//     once instead of one load's latency per word;
//   * shared memory holds the tile column by column (lane k of every row,
//     then the lengths, then the indices) at a skewed row index
//     (staging.cuh).  Threads search and merge at rows about
//     rows_per_thread / 2 apart; with rows stored whole (W words each) such
//     a stride put a warp's 32 reads on a few banks, and shared memory, not
//     device memory, limited the kernel;
//   * when tile boundaries are few, `group` lanes search one boundary
//     together, so the partition is a few memory round trips deep.
//
// W (lanes per row) is a template parameter for W = 1..8, where the two rows
// under comparison sit in registers; a flavour with W read at run time serves
// wider rows.  Any na, nb >= 0 is valid; the last tile is ragged.  The tile is
// threads * rows_per_thread rows, chosen by the caller and cut down by
// tez_merge_path_tile until the staging fits the shared memory a block may
// use.  TMA, multi-stage pipelining and persistent CTAs are left for later.
#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kPartitionThreads = 256;
// Shared memory one block may opt into on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;
// Shared memory a block gets without opting in.
constexpr int kDefaultSmem = 48 * 1024;
// Lanes searching one boundary together when few boundaries keep the
// partition latency-bound; boundaries beyond which one lane searches each.
constexpr int kWideGroup = 8;
constexpr long long kWideGroupBoundaries = 8192;

// W lane columns, the length and the index column, then the source list.
long long smem_bytes(int tile, int w) {
  return 4LL * (static_cast<long long>(column_pitch(tile, w)) * (w + 2) +
                skew(tile));
}

// a <= b under (lanes..., length); a and b point at W lanes each.
template <int kW>
__device__ __forceinline__ bool row_le(const uint32_t* a, uint32_t alen,
                                       const uint32_t* b, uint32_t blen,
                                       int w) {
  const int lanes = kW > 0 ? kW : w;
#pragma unroll
  for (int k = 0; k < lanes; ++k) {
    if (a[k] != b[k]) return a[k] < b[k];
  }
  return alen <= blen;
}

// a <= b for rows a and b of row-major global arrays.  With W known, both
// rows are loaded whole before the first comparison, one round trip.
template <int kW>
__device__ __forceinline__ bool global_le(const uint32_t* a,
                                          const uint32_t* alen,
                                          const uint32_t* b,
                                          const uint32_t* blen, int w) {
  if constexpr (kW > 0) {
    uint32_t ar[kW], br[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      ar[k] = a[k];
      br[k] = b[k];
    }
    return row_le<kW>(ar, *alen, br, *blen, kW);
  } else {
    return row_le<0>(a, *alen, b, *blen, w);
  }
}

// i(d): rows of A among the first d rows of the merge (ties to A), for
// every tile boundary d = t * tile.  `group` lanes of a warp (a power of two
// up to 32) search one boundary together: each step they probe `group`
// evenly spaced points of the interval at once and keep the piece between
// the last point that takes A and the first that does not, so a step costs
// one memory round trip and cuts the interval group + 1 ways.  group = 1 is
// a binary search.
template <int kW>
__global__ void partition_kernel(const uint32_t* __restrict__ a_lanes,
                                 const uint32_t* __restrict__ a_lens,
                                 int64_t na,
                                 const uint32_t* __restrict__ b_lanes,
                                 const uint32_t* __restrict__ b_lens,
                                 int64_t nb, int w, int64_t tile,
                                 int64_t tiles, int group,
                                 int32_t* __restrict__ splits) {
  const int lanes = kW > 0 ? kW : w;
  const int lane = threadIdx.x & 31, g = lane & (group - 1);
  const unsigned mask =
      (group == 32 ? 0xFFFFFFFFu : (1u << group) - 1) << (lane - g);
  const int64_t t =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / group;
  const bool valid = t <= tiles;
  const int64_t d = valid ? (t * tile < na + nb ? t * tile : na + nb) : 0;
  int64_t lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
  while (__any_sync(0xFFFFFFFFu, lo < hi)) {
    const int64_t len = hi - lo;
    bool take_a = false;
    if (lo < hi) {
      const int64_t p = lo + len * (g + 1) / (group + 1), bj = d - 1 - p;
      take_a = global_le<kW>(a_lanes + p * lanes, a_lens + p,
                             b_lanes + bj * lanes, b_lens + bj, lanes);
    }
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, take_a) & mask);
    if (lo < hi) {
      const int64_t new_lo = c > 0 ? lo + len * c / (group + 1) + 1 : lo;
      hi = c < group ? lo + len * (c + 1) / (group + 1) : hi;
      lo = new_lo;
    }
  }
  if (valid && g == 0) splits[t] = static_cast<int32_t>(lo);
}

// Staged row x <= staged row y.
template <int kW>
__device__ __forceinline__ bool staged_le(const uint32_t* cols,
                                          const uint32_t* lens, int pitch,
                                          int x, int y, int w) {
  if constexpr (kW > 0) {
    uint32_t xr[kW], yr[kW];
    load_row<kW>(xr, cols, pitch, x);
    load_row<kW>(yr, cols, pitch, y);
    return row_le<kW>(xr, lens[skew(x)], yr, lens[skew(y)], kW);
  } else {
    for (int k = 0; k < w; ++k) {
      const uint32_t a = cols[k * pitch + skew(x)];
      const uint32_t b = cols[k * pitch + skew(y)];
      if (a != b) return a < b;
    }
    return lens[skew(x)] <= lens[skew(y)];
  }
}

template <int kW>
__global__ void merge_tile_kernel(const uint32_t* __restrict__ a_lanes,
                                  const uint32_t* __restrict__ a_lens,
                                  const uint32_t* __restrict__ a_idx,
                                  const uint32_t* __restrict__ b_lanes,
                                  const uint32_t* __restrict__ b_lens,
                                  const uint32_t* __restrict__ b_idx,
                                  int64_t n, const int32_t* __restrict__ splits,
                                  int w, int rows_per_thread,
                                  uint32_t* __restrict__ out_lanes,
                                  uint32_t* __restrict__ out_lens,
                                  uint32_t* __restrict__ out_idx) {
  extern __shared__ uint32_t smem[];
  const int lanes = kW > 0 ? kW : w;
  const int tile = blockDim.x * rows_per_thread;
  const int pitch = column_pitch(tile, lanes);
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int count = static_cast<int>(n - d0 < tile ? n - d0 : tile);
  const int64_t i0 = splits[blockIdx.x], j0 = d0 - i0;
  const int nA = static_cast<int>(splits[blockIdx.x + 1] - i0);
  const int nB = count - nA;

  // Staged rows: A's at [0, nA), B's at [nA, count).
  uint32_t* cols = smem;
  uint32_t* lens = cols + lanes * pitch;
  uint32_t* idx = lens + pitch;
  int32_t* src = reinterpret_cast<int32_t*>(idx + pitch);
  stage_rows<kW>(cols, pitch, a_lanes + i0 * lanes, nA, 0, lanes);
  stage_rows<kW>(cols, pitch, b_lanes + j0 * lanes, nB, nA, lanes);
  stage_column(lens, a_lens + i0, nA, 0);
  stage_column(lens, b_lens + j0, nB, nA);
  stage_column(idx, a_idx + i0, nA, 0);
  stage_column(idx, b_idx + j0, nB, nA);
  cp_async_wait_all();
  __syncthreads();

  // This thread's output rows [diag, end) of the tile: co-rank, then merge.
  const int diag = min(static_cast<int>(threadIdx.x) * rows_per_thread, count);
  const int end = min(diag + rows_per_thread, count);
  int lo = diag > nB ? diag - nB : 0, hi = diag < nA ? diag : nA;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (staged_le<kW>(cols, lens, pitch, mid, nA + diag - 1 - mid, lanes)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ia = lo, ib = nA + diag - lo;
  if constexpr (kW > 0) {
    uint32_t ar[kW], br[kW];
    uint32_t alen = 0, blen = 0;
    if (ia < nA) {
      load_row<kW>(ar, cols, pitch, ia);
      alen = lens[skew(ia)];
    }
    if (ib < count) {
      load_row<kW>(br, cols, pitch, ib);
      blen = lens[skew(ib)];
    }
    for (int r = diag; r < end; ++r) {
      if (ib >= count || (ia < nA && row_le<kW>(ar, alen, br, blen, kW))) {
        src[skew(r)] = ia++;
        if (ia < nA) {
          load_row<kW>(ar, cols, pitch, ia);
          alen = lens[skew(ia)];
        }
      } else {
        src[skew(r)] = ib++;
        if (ib < count) {
          load_row<kW>(br, cols, pitch, ib);
          blen = lens[skew(ib)];
        }
      }
    }
  } else {
    for (int r = diag; r < end; ++r) {
      if (ib >= count ||
          (ia < nA && staged_le<0>(cols, lens, pitch, ia, ib, lanes))) {
        src[skew(r)] = ia++;
      } else {
        src[skew(r)] = ib++;
      }
    }
  }
  __syncthreads();

  // Coalesced stores, each word gathered from its source row.  d0 * lanes
  // words is a multiple of 4 (tile is), so 16-byte stores stay aligned.
  auto lane_word = [&](int e) -> uint32_t {
    const int row = e / lanes, k = e - row * lanes;
    return cols[k * pitch + skew(src[skew(row)])];
  };
  uint32_t* ol = out_lanes + d0 * lanes;
  const int n_words = count * lanes;
  for (int v = threadIdx.x; v < (n_words >> 2); v += blockDim.x) {
    const int e = 4 * v;
    reinterpret_cast<uint4*>(ol)[v] =
        make_uint4(lane_word(e), lane_word(e + 1), lane_word(e + 2),
                   lane_word(e + 3));
  }
  for (int e = (n_words & ~3) + threadIdx.x; e < n_words; e += blockDim.x) {
    ol[e] = lane_word(e);
  }
  auto len_of = [&](int r) -> uint32_t { return lens[skew(src[skew(r)])]; };
  auto idx_of = [&](int r) -> uint32_t { return idx[skew(src[skew(r)])]; };
  uint32_t* on = out_lens + d0;
  uint32_t* oi = out_idx + d0;
  for (int v = threadIdx.x; v < (count >> 2); v += blockDim.x) {
    const int r = 4 * v;
    reinterpret_cast<uint4*>(on)[v] =
        make_uint4(len_of(r), len_of(r + 1), len_of(r + 2), len_of(r + 3));
    reinterpret_cast<uint4*>(oi)[v] =
        make_uint4(idx_of(r), idx_of(r + 1), idx_of(r + 2), idx_of(r + 3));
  }
  for (int r = (count & ~3) + threadIdx.x; r < count; r += blockDim.x) {
    on[r] = len_of(r);
    oi[r] = idx_of(r);
  }
}

// Largest tile of `threads` * (rows_per_thread halved as often as needed)
// rows whose staging fits in shared memory; 0 when none does.  The tile is a
// multiple of 4 rows (threads is of 32), which keeps the stores aligned.
long long tile_rows(int w, int threads, int rows_per_thread) {
  if (threads <= 0 || threads > 1024 || threads % 32 || rows_per_thread <= 0) {
    return 0;
  }
  for (int r = rows_per_thread; r >= 1; r >>= 1) {
    if (smem_bytes(threads * r, w) <= kMaxSmem) return threads * r;
  }
  return 0;
}

template <int kW>
int launch(const void* a_lanes, const void* a_lens, const void* a_idx,
           long long na, const void* b_lanes, const void* b_lens,
           const void* b_idx, long long nb, int w, int threads, int tile,
           int group, int32_t* splits, void* out_lanes, void* out_lens,
           void* out_idx, cudaStream_t s) {
  const long long n = na + nb;
  const long long tiles = (n + tile - 1) / tile;
  if (group == 0) group = tiles < kWideGroupBoundaries ? kWideGroup : 1;
  const auto* al = static_cast<const uint32_t*>(a_lanes);
  const auto* an = static_cast<const uint32_t*>(a_lens);
  const auto* bl = static_cast<const uint32_t*>(b_lanes);
  const auto* bn = static_cast<const uint32_t*>(b_lens);
  const long long search_threads = (tiles + 1) * group;
  partition_kernel<kW><<<static_cast<unsigned>(
                             (search_threads + kPartitionThreads - 1) /
                             kPartitionThreads),
                         kPartitionThreads, 0, s>>>(
      al, an, na, bl, bn, nb, w, tile, tiles, group, splits);
  const long long smem = smem_bytes(tile, w);
  if (smem > kDefaultSmem) {
    cudaError_t e = cudaFuncSetAttribute(
        merge_tile_kernel<kW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  merge_tile_kernel<kW><<<static_cast<unsigned>(tiles), threads,
                          static_cast<size_t>(smem), s>>>(
      al, an, static_cast<const uint32_t*>(a_idx), bl, bn,
      static_cast<const uint32_t*>(b_idx), n, splits, w, tile / threads,
      static_cast<uint32_t*>(out_lanes), static_cast<uint32_t*>(out_lens),
      static_cast<uint32_t*>(out_idx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Rows in one output tile for this W and CTA shape (the caller sizes the
// splits array from it: tiles + 1 entries); 0 when no tile fits.
extern "C" long long tez_merge_path_tile(int w, int threads,
                                         int rows_per_thread) {
  return tile_rows(w, threads, rows_per_thread);
}

// Merge sorted runs A (na rows) and B (nb rows): lanes int32[n, w], sort
// lengths int32[n] (u32 bits), idx int32[n]; outputs of na + nb rows.  splits
// holds tiles + 1 int32 for tiles = ceil((na + nb) / tile).  `group` lanes
// search each tile boundary (a power of two up to 32); 0 chooses by the
// number of boundaries.  Outputs must be 16-byte aligned.  Returns a
// cudaError_t.
extern "C" int tez_merge_path_pair(const void* a_lanes, const void* a_lens,
                                   const void* a_idx, long long na,
                                   const void* b_lanes, const void* b_lens,
                                   const void* b_idx, long long nb, int w,
                                   int threads, int rows_per_thread,
                                   int group, void* splits, void* out_lanes,
                                   void* out_lens, void* out_idx,
                                   void* stream) {
  if (na < 0 || nb < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (na + nb == 0) return 0;
  const int tile = static_cast<int>(tile_rows(w, threads, rows_per_thread));
  if (tile == 0 || group < 0 || group > 32 || (group & (group - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((reinterpret_cast<uintptr_t>(out_lanes) |
       reinterpret_cast<uintptr_t>(out_lens) |
       reinterpret_cast<uintptr_t>(out_idx)) & 15) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* sp = static_cast<int32_t*>(splits);
#define TEZ_MERGE_PATH_CASE(K)                                             \
  case K:                                                                  \
    return launch<K>(a_lanes, a_lens, a_idx, na, b_lanes, b_lens, b_idx,   \
                     nb, w, threads, tile, group, sp, out_lanes, out_lens, \
                     out_idx, s);
  switch (w) {
    TEZ_MERGE_PATH_CASE(1)
    TEZ_MERGE_PATH_CASE(2)
    TEZ_MERGE_PATH_CASE(3)
    TEZ_MERGE_PATH_CASE(4)
    TEZ_MERGE_PATH_CASE(5)
    TEZ_MERGE_PATH_CASE(6)
    TEZ_MERGE_PATH_CASE(7)
    TEZ_MERGE_PATH_CASE(8)
    default:
      return launch<0>(a_lanes, a_lens, a_idx, na, b_lanes, b_lens, b_idx,
                       nb, w, threads, tile, group, sp, out_lanes, out_lens,
                       out_idx, s);
  }
#undef TEZ_MERGE_PATH_CASE
}
