// Shared-memory staging of sorted rows, shared by merge_path.cu and
// merge_rank.cu.
//
// A block of rows (W u32 lanes each, row-major in device memory, plus
// one-word columns such as the sort length) is staged column by column:
// lane k of every row, then each one-word column, at a skewed row index.
// Threads that search or merge at rows a power of two apart then read from
// different banks: with rows stored whole, W = 4 put every row on one of 8
// four-bank groups and a stride of 4-8 rows put a warp's 32 reads on one
// bank.  Copies are cp.async, so a thread has all its loads in flight at
// once instead of waiting out one load's latency per word.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Slot of row r in a staged column: one extra word every 32 rows, so rows a
// power of two apart fall on different banks.
__host__ __device__ __forceinline__ int skew(int r) { return r + (r >> 5); }

// Words per staged column of `rows` rows: the skewed rows, padded so that
// neighbouring columns start ceil(32 / W) banks apart (a warp's coalesced
// staging touches ceil(32 / W) rows of each of W columns).
__host__ __device__ __forceinline__ int column_pitch(int rows, int w) {
  const int skewed = skew(rows);
  const int want = w > 0 ? (32 + w - 1) / w : 0;
  return skewed + (((want - skewed) % 32) + 32) % 32;
}

// Asynchronous 4-byte global -> shared copy.
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Rows [0, n) of a row-major global array of W lanes -> staged rows
// [base, base + n), lane k into column k (columns `pitch` words apart).
template <int kW>
__device__ __forceinline__ void stage_rows(uint32_t* cols, int pitch,
                                           const uint32_t* g, int n,
                                           int base, int w) {
  const int lanes = kW > 0 ? kW : w;
  for (int e = threadIdx.x; e < n * lanes; e += blockDim.x) {
    const int r = e / lanes, k = e - r * lanes;
    cp_async4(cols + k * pitch + skew(base + r), g + e);
  }
}

// n words of a one-word column -> staged rows [base, base + n).
__device__ __forceinline__ void stage_column(uint32_t* col, const uint32_t* g,
                                             int n, int base) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    cp_async4(col + skew(base + r), g + r);
  }
}

// The W lanes of staged row x into registers.
template <int kW>
__device__ __forceinline__ void load_row(uint32_t* reg, const uint32_t* cols,
                                         int pitch, int x) {
#pragma unroll
  for (int k = 0; k < kW; ++k) reg[k] = cols[k * pitch + skew(x)];
}

}  // namespace
