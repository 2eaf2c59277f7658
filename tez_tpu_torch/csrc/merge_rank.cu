// Merge rank of arbitrary queries in a sorted run, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel merge_rank_pallas (tez_tpu/ops/pallas_kernels.py:76,
// body _merge_rank_kernel :61), which delegates to the search body
// _rank_search (tez_tpu/ops/device.py:436) under the comparator _lex_lt
// (:423).
//
// Computes, for each of M query rows, its rank in a sorted run of N rows
// under the composite order (u32 lanes, lane 0 most significant, then the
// u32 length; 0xFFFFFFFF is the pad sentinel's length).  count_equal = 0
// counts run rows < query, count_equal = 1 counts rows <= query.  Any N and
// M >= 0 and any W (lanes per row) are taken; the queries need not be sorted.
//
// Bound on this card: bytes.  The run and the queries are read once
// ((N + M) * (W + 1) * 4 B) and the ranks written once (M * 4 B).  A plain
// binary search per query in device memory sits far above that bound: each
// of ~21 dependent probes (N = 2^21) reads a lane row from L2 (a 12-byte row
// straddles two 32-byte sectors one time in four), every thread walks the
// same top levels of the tree on its own, and sorted queries -- the only
// kind the JAX package's caller passes, a second sorted run -- search the
// whole run from the root although neighbouring queries land on
// neighbouring ranks.
//
// Design.  Queries are cut into tiles of T consecutive rows (T = 1024, less
// for rows so wide that a tile's window would not fit the region twice).
//   1. windows: one warp per tile finds the rank of the tile's first query
//      (lo[t]) and of its last (hi[t]), 16 lanes each, with the cooperative
//      search of merge_path.cu's partition: each round the 16 lanes probe
//      evenly spaced rows at once, so a search is ~log17(N) memory round
//      trips deep.
//   2. rank: persistent CTAs (256 threads, 4 consecutive queries a thread)
//      walk the tiles.  A CTA's shared memory is one region (a quarter of
//      the SM's for rows of up to 4 lanes, whose registers let 3 CTAs
//      share an SM; the rest stays L1, which the device-memory probes
//      below use) that holds either a tile's window or a splitter table.
//      Per tile, when the window run[lo:hi] fits the region, it is staged
//      (cp.async, the column-by-column skewed layout of staging.cuh) while
//      the threads load their queries into registers and vote whether the
//      tile is in order (every adjacent pair q[i] <= q[i+1]), writing
//      sorted[t]: one memory round trip per tile, not two.
//      * A tile in order has every rank in [lo, hi].  With its window
//        staged, each thread finds its first query's rank by binary search
//        in the window and the next three by galloping from the previous
//        rank (~2-3 steps each).  Every run row is read from device memory
//        about once, the queries once, the ranks written once.
//      * A tile out of order ranks against a splitter table of the whole
//        run: S run rows at an even stride, S the region's rows (~3,400 at
//        W = 3).  It is staged once per CTA and kept while the CTA's tiles
//        need it (a window staged over it drops it), so the grid pays for
//        it a few hundred times, not once per tile.  The table search
//        takes the first ~12 levels of each query off device memory; the
//        remaining ~log2(N / S) probes go to device memory with the
//        thread's 4 queries interleaved, so their independent probe chains
//        overlap.
//      * A tile in order whose window is too wide (an all-equal run, a run
//        much longer than the queries) searches [lo, hi) in device memory
//        the same way; neighbouring sorted queries share most of their
//        probe path, so a warp's probes fall on few sectors.
//   What bounds the device-memory probes is L2 sector traffic, not bytes:
//   a probe reads a lane row (one or two 32-byte sectors) and a length (a
//   third).  Where the two rows around a query's interval have the same
//   lanes, every row between has them too (the run is sorted), so either
//   the query's lanes settle the rank outright or the probes read only
//   the length column: one sector each.
//   Rows are compared whole: W = 1..8 lanes and the length are loaded
//   together into registers (one compiled flavour per W); a flavour with W
//   read at run time serves wider rows.  A thread's four queries are 4 W
//   contiguous words, read with W 16-byte loads (and one for their lengths)
//   where the inputs are aligned: a warp's scalar loads of rows 4 apart
//   each touched 16 sectors.  Nothing of a thread's state is indexed at run
//   time, so none of it lives in local memory.
#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

#include "staging.cuh"

namespace {

constexpr int kWindowThreads = 256;  // one warp per tile
constexpr int kSearchLanes = 16;     // lanes per window search
constexpr int kMaxThreads = 256;     // rank kernel block
constexpr int kMaxQueries = 4;       // queries per thread in the rank kernel
constexpr int kMaxTile = kMaxThreads * kMaxQueries;
constexpr int kMinTile = 32;
// Shared memory of one SM, and what a block may opt into (sm_90).
constexpr int kSmemPerSm = 233472;
constexpr int kMaxSmem = 232448;
constexpr int kBlockReserve = 1024;  // per resident block
constexpr int kDefaultSmem = 48 * 1024;

// A run or query row in one of three homes; each gives lane(k) and len().
struct GlobalRow {  // row-major device memory, through the read-only path
  const uint32_t* lanes;
  const uint32_t* length;
  __device__ __forceinline__ uint32_t lane(int k) const {
    return __ldg(lanes + k);
  }
  __device__ __forceinline__ uint32_t len() const { return __ldg(length); }
};

struct StagedRow {  // a staged block of shared memory (staging.cuh layout)
  const uint32_t* cols;
  const uint32_t* lens;
  int pitch, x;
  __device__ __forceinline__ uint32_t lane(int k) const {
    return cols[k * pitch + skew(x)];
  }
  __device__ __forceinline__ uint32_t len() const { return lens[skew(x)]; }
};

template <int kW>
struct RegRow {  // registers
  uint32_t l[kW > 0 ? kW : 1];
  uint32_t n;
  __device__ __forceinline__ uint32_t lane(int k) const { return l[k]; }
  __device__ __forceinline__ uint32_t len() const { return n; }
};

// -1 / 0 / +1 as the lanes of row a compare to those of row b, lane 0 most
// significant.
template <int kW, class A, class B>
__device__ __forceinline__ int lane_order(const A& a, const B& b, int w) {
  const int lanes = kW > 0 ? kW : w;
#pragma unroll
  for (int k = 0; k < lanes; ++k) {
    const uint32_t x = a.lane(k), y = b.lane(k);
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

__device__ __forceinline__ int order(uint32_t x, uint32_t y) {
  return x < y ? -1 : (x > y ? 1 : 0);
}

// -1 / 0 / +1 as row a compares to row b: lanes first, the length only on
// a lane tie.
template <int kW, class A, class B>
__device__ __forceinline__ int compare(const A& a, const B& b, int w) {
  const int o = lane_order<kW>(a, b, w);
  return o != 0 ? o : order(a.len(), b.len());
}

// Does a run row that compares `c` to the query count towards its rank?
__device__ __forceinline__ bool before(int c, int count_equal) {
  return count_equal ? c <= 0 : c < 0;
}

template <int kW>
__device__ __forceinline__ RegRow<kW> load_global(const uint32_t* lanes,
                                                  const uint32_t* lens,
                                                  int64_t r) {
  RegRow<kW> row;
#pragma unroll
  for (int k = 0; k < kW; ++k) row.l[k] = __ldg(lanes + r * kW + k);
  row.n = __ldg(lens + r);
  return row;
}

template <int kW>
__device__ __forceinline__ RegRow<kW> load_staged(const uint32_t* cols,
                                                  const uint32_t* lens,
                                                  int pitch, int x) {
  RegRow<kW> row;
  load_row<kW>(row.l, cols, pitch, x);
  row.n = lens[skew(x)];
  return row;
}

// Kernel 1: lo[t] and hi[t], the ranks of tile t's first and last query.
// Lanes 0-15 of a warp search the first, 16-31 the last.  Each round the 16
// lanes probe 16 evenly spaced rows of [lo, hi); those that count towards
// the rank form a prefix, and the interval shrinks to the piece between the
// last of them and the first that does not.
template <int kW>
__global__ void __launch_bounds__(kWindowThreads)
    windows_kernel(const uint32_t* __restrict__ run_lanes,
                   const uint32_t* __restrict__ run_lens, int64_t n,
                   const uint32_t* __restrict__ q_lanes,
                   const uint32_t* __restrict__ q_lens, int64_t m, int w,
                   int count_equal, int tile, int64_t tiles,
                   int32_t* __restrict__ windows) {
  const int lanes = kW > 0 ? kW : w;
  const int lane = threadIdx.x & 31, g = lane & (kSearchLanes - 1);
  const unsigned half = 0xFFFFu << (lane & kSearchLanes);
  const int64_t t =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const bool valid = t < tiles;
  int64_t qi = 0;
  if (valid) {
    qi = t * tile;
    if (lane >= kSearchLanes) qi = (qi + tile < m ? qi + tile : m) - 1;
  }
  RegRow<kW> qreg;
  if constexpr (kW > 0) {
    if (valid) qreg = load_global<kW>(q_lanes, q_lens, qi);
  }
  int64_t lo = 0, hi = valid ? n : 0;
  while (__any_sync(0xFFFFFFFFu, lo < hi)) {
    const int64_t len = hi - lo;
    bool b = false;
    if (lo < hi) {
      const int64_t p = lo + len * (g + 1) / (kSearchLanes + 1);
      int c;
      if constexpr (kW > 0) {  // the probed row whole, one round trip
        c = compare<kW>(load_global<kW>(run_lanes, run_lens, p), qreg, kW);
      } else {
        c = compare<0>(GlobalRow{run_lanes + p * lanes, run_lens + p},
                       GlobalRow{q_lanes + qi * lanes, q_lens + qi}, lanes);
      }
      b = before(c, count_equal);
    }
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, b) & half);
    if (lo < hi) {
      const int64_t new_lo =
          c > 0 ? lo + len * c / (kSearchLanes + 1) + 1 : lo;
      hi = c < kSearchLanes ? lo + len * (c + 1) / (kSearchLanes + 1) : hi;
      lo = new_lo;
    }
  }
  if (valid && g == 0) {
    windows[(lane >= kSearchLanes ? tiles : 0) + t] = static_cast<int32_t>(lo);
  }
}

// A query or probed run row as the W flavour holds it: registers for
// W = 1..8 (loaded whole, one round trip), pointers into device memory for
// the generic flavour.
template <int kW>
struct HeldRow {
  using type = RegRow<kW>;
};
template <>
struct HeldRow<0> {
  using type = GlobalRow;
};

template <int kW>
__device__ __forceinline__ typename HeldRow<kW>::type hold_row(
    const uint32_t* lanes, const uint32_t* lens, int64_t r, int w) {
  if constexpr (kW > 0) {
    return load_global<kW>(lanes, lens, r);
  } else {
    return GlobalRow{lanes + r * w, lens + r};
  }
}

// Does staged row x count towards the rank of q?  With W known the row is
// read whole (W + 1 independent loads) before comparing.
template <int kW, class Q>
__device__ __forceinline__ bool staged_before(const uint32_t* cols,
                                              const uint32_t* lens, int pitch,
                                              int x, const Q& q, int w,
                                              int count_equal) {
  if constexpr (kW > 0) {
    return before(compare<kW>(load_staged<kW>(cols, lens, pitch, x), q, kW),
                  count_equal);
  } else {
    return before(compare<0>(StagedRow{cols, lens, pitch, x}, q, w),
                  count_equal);
  }
}

// Rank of q inside staged rows [a, b): the first row that does not count
// towards it, b if all do.
template <int kW, class Q>
__device__ __forceinline__ int staged_rank(const uint32_t* cols,
                                           const uint32_t* lens, int pitch,
                                           int a, int b, const Q& q, int w,
                                           int count_equal) {
  while (a < b) {
    const int mid = a + ((b - a) >> 1);
    if (staged_before<kW>(cols, lens, pitch, mid, q, w, count_equal)) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a;
}

// The same, for a query whose rank is known to be >= a and likely close to
// it (the next query of a sorted tile): probe a, a + 1, a + 3, a + 7, ...
// until a row does not count, then search the last gap.
template <int kW, class Q>
__device__ __forceinline__ int staged_gallop(const uint32_t* cols,
                                             const uint32_t* lens, int pitch,
                                             int a, int b, const Q& q, int w,
                                             int count_equal) {
  for (int step = 1; a < b; step <<= 1) {
    const int p = min(a + step - 1, b - 1);
    if (!staged_before<kW>(cols, lens, pitch, p, q, w, count_equal)) {
      return staged_rank<kW>(cols, lens, pitch, a, p, q, w, count_equal);
    }
    a = p + 1;
  }
  return b;
}

// CTAs an SM the rank kernel is built for: 3 for rows of up to 4 lanes,
// whose probe rows fit 85 registers a thread, 2 for wider ones.  Each takes
// 1 / (ctas + 1) of the SM's shared memory, and the rest stays L1, which
// the device-memory probes use.
__host__ __device__ constexpr int rank_ctas(int w) {
  return w > 0 && w <= 4 ? 3 : 2;
}

// One query of a thread in the rank kernel: the row, its search interval
// [a, b) in device memory, the probe in flight, whether only lengths are
// left to compare, and the rank.  Positions are below N < 2^31, so they fit
// an int; a + b need not, so midpoints are taken as a + (b - a) / 2.
template <int kW>
struct Chain {
  typename HeldRow<kW>::type q, probe;
  int a, b, mid, rank;
  bool len_only;
};

// Calls f(chain, j) for j = 0..3.  The chains are four named variables,
// not an array: a loop over an array whose body holds a search is not
// unrolled, and the array then lives in local memory.
template <class C, class F>
__device__ __forceinline__ void each(C& c0, C& c1, C& c2, C& c3, F&& f) {
  f(c0, 0);
  f(c1, 1);
  f(c2, 2);
  f(c3, 3);
}

// Narrow chain c, whose rank lies in [a, b], with the rows just outside
// its search interval: row a - 1 (or a) and row b (or b - 1), `first` and
// `last`.  Every row between two rows with the same lanes has those lanes
// too (the run is sorted), so then either the query's lanes decide the
// rank outright or only lengths are left to compare: each probe reads one
// word instead of a row.
template <int kW, class C, class R>
__device__ __forceinline__ void narrow(C& c, const R& first, const R& last,
                                       int w) {
  c.len_only = false;
  if (c.a < c.b && lane_order<kW>(first, last, w) == 0) {
    const int o = lane_order<kW>(first, c.q, w);
    if (o < 0) {
      c.a = c.b;  // every row's lanes are below the query's
    } else if (o > 0) {
      c.b = c.a;  // every row's lanes are above
    } else {
      c.len_only = true;
    }
  }
}

// Splitter k of S over the run's N rows: row floor((k + 1) * N / (S + 1)),
// in double precision (exact enough below 2^44, and monotone in k) rather
// than a 64-bit integer division.  The staging and the search brackets
// both take it from here.
__device__ __forceinline__ int splitter(int k, int64_t n, int s_rows) {
  return static_cast<int>((k + 1) * (static_cast<double>(n) / (s_rows + 1)));
}

// Kernel 2: the ranks, persistent CTAs over the tiles (see the note above).
// Shared memory is one region of W + 1 staged columns that holds a tile's
// window or the splitter table.  Per tile, the window (when it fits) is
// staged while the queries load into registers, so a tile in order pays
// one memory round trip before it ranks; the in-order vote decides which
// path the tile takes.
template <int kW>
__global__ void __launch_bounds__(kMaxThreads, rank_ctas(kW))
    rank_kernel(const uint32_t* __restrict__ run_lanes,
                const uint32_t* __restrict__ run_lens, int64_t n,
                const uint32_t* __restrict__ q_lanes,
                const uint32_t* __restrict__ q_lens, int64_t m, int w,
                int count_equal, int tile, int64_t tiles, int region,
                int vector_io, int32_t* __restrict__ windows,
                int32_t* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int lanes = kW > 0 ? kW : w;
  const int per_thread = tile / blockDim.x;
  const int pr = column_pitch(region, lanes);
  uint32_t* r_cols = smem;
  uint32_t* r_len = r_cols + lanes * pr;
  const int s_rows = static_cast<int>(min(static_cast<int64_t>(region), n));
  bool table_staged = false;  // the same in every thread of the CTA
  using Row = typename HeldRow<kW>::type;

  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t f = t * tile;
    const int count = static_cast<int>(m - f < tile ? m - f : tile);
    const int lo = windows[t], hi = windows[tiles + t];
    const int wn = hi - lo;
    __syncthreads();  // the previous tile's readers are done
    // A window that fits is staged before the vote: a tile out of order
    // rarely has one (its hi - lo is anything in [-N, N]).
    const bool window_staged = wn > 0 && wn <= region;
    if (window_staged) {
      stage_rows<kW>(r_cols, pr, run_lanes + static_cast<int64_t>(lo) * lanes,
                     wn, 0, lanes);
      stage_column(r_len, run_lens + lo, wn, 0);
      table_staged = false;
    }

    // This thread's queries: rows [r0, r0 + nq) of the tile.
    const int r0 = threadIdx.x * per_thread;
    const int nq = max(0, min(per_thread, count - r0));
    const uint32_t* tl = q_lanes + f * lanes;
    const uint32_t* tn = q_lens + f;
    Chain<kW> c0, c1, c2, c3;
    bool loaded = false;
    if constexpr (kW > 0) {
      // Four whole rows are 4 W contiguous words: W 16-byte loads, and one
      // for the four lengths, where the inputs are 16-byte aligned.
      if (vector_io && nq == kMaxQueries) {
        const uint4* src = reinterpret_cast<const uint4*>(tl + r0 * kW);
        uint32_t words[4 * kW];
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          const uint4 v = __ldg(src + i);
          words[4 * i] = v.x;
          words[4 * i + 1] = v.y;
          words[4 * i + 2] = v.z;
          words[4 * i + 3] = v.w;
        }
        const uint4 len = __ldg(reinterpret_cast<const uint4*>(tn + r0));
#pragma unroll
        for (int k = 0; k < kW; ++k) {
          c0.q.l[k] = words[k];
          c1.q.l[k] = words[kW + k];
          c2.q.l[k] = words[2 * kW + k];
          c3.q.l[k] = words[3 * kW + k];
        }
        c0.q.n = len.x;
        c1.q.n = len.y;
        c2.q.n = len.z;
        c3.q.n = len.w;
        loaded = true;
      }
    }
    if (!loaded) {
      each(c0, c1, c2, c3, [&](Chain<kW>& c, int j) {
        if (j < nq) c.q = hold_row<kW>(tl, tn, r0 + j, lanes);
      });
    }
    bool ok = (nq < 2 || compare<kW>(c0.q, c1.q, lanes) <= 0) &&
              (nq < 3 || compare<kW>(c1.q, c2.q, lanes) <= 0) &&
              (nq < 4 || compare<kW>(c2.q, c3.q, lanes) <= 0);
    if (nq == per_thread && r0 + per_thread < count) {  // the next thread's
      const Row next = hold_row<kW>(tl, tn, r0 + per_thread, lanes);
      each(c0, c1, c2, c3, [&](Chain<kW>& c, int j) {
        if (j == nq - 1) ok = ok && compare<kW>(c.q, next, lanes) <= 0;
      });
    }
    const bool sorted = __syncthreads_and(ok);
    if (threadIdx.x == 0) windows[2 * tiles + t] = sorted ? 1 : 0;

    if (sorted && wn <= region) {
      // In order, and the window fits: rank inside run[lo:hi].
      if (window_staged) {
        cp_async_wait_all();
        __syncthreads();
      }
      int prev = 0;
      each(c0, c1, c2, c3, [&](Chain<kW>& c, int j) {
        if (j < nq) {
          prev = j == 0 ? staged_rank<kW>(r_cols, r_len, pr, 0, wn, c.q,
                                          lanes, count_equal)
                        : staged_gallop<kW>(r_cols, r_len, pr, prev, wn, c.q,
                                            lanes, count_equal);
          c.rank = lo + prev;
        }
      });
    } else {
      if (sorted) {
        // In order, but the window is too wide for shared memory: search
        // run[lo:hi] in device memory.  Neighbouring queries are
        // neighbouring rows, so a warp's probes share most of their path.
        const Row first = hold_row<kW>(run_lanes, run_lens, lo, lanes);
        const Row last = hold_row<kW>(run_lanes, run_lens, hi - 1, lanes);
        each(c0, c1, c2, c3, [&](Chain<kW>& c, int j) {
          if (j < nq) {
            c.a = lo;
            c.b = hi;
            narrow<kW>(c, first, last, lanes);
          }
        });
      } else {
        // Out of order: the splitter table of the whole run, staged once
        // per CTA, then device memory.
        if (!table_staged) {
          if (window_staged) {  // its copies land before the table's
            cp_async_wait_all();
            __syncthreads();
          }
          for (int e = threadIdx.x; e < s_rows * lanes; e += blockDim.x) {
            const int k = e / lanes, l = e - k * lanes;
            const int64_t p = splitter(k, n, s_rows);
            cp_async4(r_cols + l * pr + skew(k), run_lanes + p * lanes + l);
          }
          for (int k = threadIdx.x; k < s_rows; k += blockDim.x) {
            cp_async4(r_len + skew(k), run_lens + splitter(k, n, s_rows));
          }
          table_staged = true;
          cp_async_wait_all();
          __syncthreads();
        }
        each(c0, c1, c2, c3, [&](Chain<kW>& c, int j) {
          if (j < nq) {
            const int k = staged_rank<kW>(r_cols, r_len, pr, 0, s_rows, c.q,
                                          lanes, count_equal);
            // The first k splitters count towards the rank, splitter k
            // does not.
            c.a = k > 0 ? splitter(k - 1, n, s_rows) + 1 : 0;
            c.b = k < s_rows ? splitter(k, n, s_rows) : static_cast<int>(n);
            c.len_only = false;
            if (k > 0 && k < s_rows) {
              narrow<kW>(c, StagedRow{r_cols, r_len, pr, k - 1},
                         StagedRow{r_cols, r_len, pr, k}, lanes);
            }
          }
        });
      }
      // Binary searches over [a, b) in device memory, the thread's queries
      // interleaved: each round issues every active chain's loads before
      // comparing any of them.  A probe reads the row whole (lanes and
      // length, one round trip), or only the length where the lanes are
      // known to match.
      while (true) {
        bool active = false;
        each(c0, c1, c2, c3, [&](Chain<kW>& c, int j) {
          if (j < nq && c.a < c.b) {
            c.mid = c.a + ((c.b - c.a) >> 1);
            if (c.len_only) {
              if constexpr (kW > 0) {
                c.probe.n = __ldg(run_lens + c.mid);
              } else {
                c.probe = GlobalRow{run_lanes, run_lens + c.mid};
              }
            } else {
              c.probe = hold_row<kW>(run_lanes, run_lens, c.mid, lanes);
            }
          }
        });
        each(c0, c1, c2, c3, [&](Chain<kW>& c, int j) {
          if (j < nq && c.a < c.b) {
            active = true;
            const int o = c.len_only ? order(c.probe.len(), c.q.len())
                                     : compare<kW>(c.probe, c.q, lanes);
            if (before(o, count_equal)) {
              c.a = c.mid + 1;
            } else {
              c.b = c.mid;
            }
          }
        });
        if (!active) break;
      }
      each(c0, c1, c2, c3, [&](Chain<kW>& c, int) { c.rank = c.a; });
    }

    int32_t* o = out + f + r0;
    if (vector_io && nq == kMaxQueries) {
      *reinterpret_cast<int4*>(o) = make_int4(c0.rank, c1.rank, c2.rank,
                                              c3.rank);
    } else {
      each(c0, c1, c2, c3, [&](Chain<kW>& c, int j) {
        if (j < nq) o[j] = c.rank;
      });
    }
  }
}

// Block shape of the rank kernel: the region takes 1 / (rank_ctas + 1) of
// the SM's shared memory; the tile is the largest of 1024 rows down to 32
// whose window, at a run as long as the queries, would fill at most half
// the region.
struct Shape {
  int tile = 0, threads = 0, region = 0;
  long long smem = 0;
};

long long staged_bytes(int rows, int w) {
  return 4LL * (w + 1) * column_pitch(rows, w);
}

Shape choose_shape(int w) {
  Shape s;
  const long long budget = std::min<long long>(
      kSmemPerSm / (rank_ctas(w) + 1) - kBlockReserve, kMaxSmem);
  const long long words = budget / 4 / (w + 1);
  int r = static_cast<int>(std::max<long long>(0, (words - 31) * 32 / 33));
  while (column_pitch(r + 1, w) <= words) ++r;
  s.region = r;
  s.smem = staged_bytes(r, w);
  s.tile = kMaxTile;
  while (s.tile > kMinTile && 2 * s.tile > r) s.tile >>= 1;
  s.threads = std::min(s.tile, kMaxThreads);
  return s;
}

template <int kW>
int launch(const void* run_lanes, const void* run_lens, long long n,
           const void* q_lanes, const void* q_lens, long long m, int w,
           int count_equal, const Shape& s, int32_t* windows, int32_t* out,
           cudaStream_t stream) {
  const auto* rl = static_cast<const uint32_t*>(run_lanes);
  const auto* rn = static_cast<const uint32_t*>(run_lens);
  const auto* ql = static_cast<const uint32_t*>(q_lanes);
  const auto* qn = static_cast<const uint32_t*>(q_lens);
  const long long tiles = (m + s.tile - 1) / s.tile;
  const long long warps_per_block = kWindowThreads / 32;
  windows_kernel<kW><<<static_cast<unsigned>((tiles + warps_per_block - 1) /
                                             warps_per_block),
                       kWindowThreads, 0, stream>>>(
      rl, rn, n, ql, qn, m, w, count_equal, s.tile, tiles, windows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (s.smem > kDefaultSmem) {
    e = cudaFuncSetAttribute(rank_kernel<kW>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(s.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, rank_kernel<kW>, s.threads,
           static_cast<size_t>(s.smem))) != cudaSuccess) {
    return static_cast<int>(e);
  }
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long grid = std::min<long long>(tiles, 1LL * per_sm * sms);
  // 16-byte loads of a thread's four queries and stores of its four ranks
  const uintptr_t addresses = reinterpret_cast<uintptr_t>(out) |
                              reinterpret_cast<uintptr_t>(q_lanes) |
                              reinterpret_cast<uintptr_t>(q_lens);
  const int vector_io =
      s.threads * kMaxQueries == s.tile && (addresses & 15) == 0;
  rank_kernel<kW><<<static_cast<unsigned>(grid), s.threads,
                    static_cast<size_t>(s.smem), stream>>>(
      rl, rn, n, ql, qn, m, w, count_equal, s.tile, tiles, s.region,
      vector_io, windows, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Query rows in one tile for rows of W lanes (the caller sizes the windows
// array from it: 3 * tiles int32); 0 for a negative W.
extern "C" long long tez_merge_rank_tile(int w) {
  if (w < 0) return 0;
  return choose_shape(w).tile;
}

// Rank of each of m query rows (q_lanes int32[m, w], q_lens int32[m], u32
// bits) in a sorted run (run_lanes int32[n, w], run_lens int32[n]); out is
// int32[m].  windows receives, per query tile, lo (row 0), hi (row 1) and
// the sorted flag (row 2): int32[3, tiles] for tiles = ceil(m / tile).
// Returns a cudaError_t.
extern "C" int tez_merge_rank(const void* run_lanes, const void* run_lens,
                              long long n, const void* q_lanes,
                              const void* q_lens, long long m, int w,
                              int count_equal, void* windows, void* out,
                              void* stream) {
  if (n < 0 || m < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return 0;
  const Shape s = choose_shape(w);
  if (s.tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* win = static_cast<int32_t*>(windows);
  auto* o = static_cast<int32_t*>(out);
  const int ce = count_equal ? 1 : 0;
#define TEZ_MERGE_RANK_CASE(K)                                              \
  case K:                                                                   \
    return launch<K>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, ce, s, \
                     win, o, st);
  switch (w) {
    TEZ_MERGE_RANK_CASE(1)
    TEZ_MERGE_RANK_CASE(2)
    TEZ_MERGE_RANK_CASE(3)
    TEZ_MERGE_RANK_CASE(4)
    TEZ_MERGE_RANK_CASE(5)
    TEZ_MERGE_RANK_CASE(6)
    TEZ_MERGE_RANK_CASE(7)
    TEZ_MERGE_RANK_CASE(8)
    default:
      return launch<0>(run_lanes, run_lens, n, q_lanes, q_lens, m, w, ce, s,
                       win, o, st);
  }
#undef TEZ_MERGE_RANK_CASE
}
