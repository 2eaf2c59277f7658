// Native host ops for the tez_tpu_torch data plane (the host library).
//
// The reference's byte-crunching data path is JVM code (SURVEY.md: the
// performance-critical path is plain Java over byte[]); here the device
// kernels do the heavy lifting and the host side only permutes/concatenates
// ragged byte arrays when materializing runs.  That gather is memory-bound
// and single-threaded in numpy (fancy indexing builds an index array of one
// int64 per BYTE); this C++ version does per-row memcpy across threads and
// skips the index materialization entirely.
//
// Build: tez_tpu_torch/ops/_build.py compiles this file and spansort.cpp
// with g++ into one shared library on first use; ops/native.py loads it
// with ctypes.  A failed build or load raises: there is no numpy fallback.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// Permute rows of a ragged u8 array.
//   data/offsets     : source (n_src rows; offsets has n_src+1 entries)
//   perm             : n_out row indices into the source
//   out_offsets      : n_out+1 entries, PRECOMPUTED by the caller
//   out_data         : out_offsets[n_out] bytes
void gather_ragged_u8(const uint8_t* data, const int64_t* offsets,
                      const int64_t* perm, int64_t n_out,
                      const int64_t* out_offsets, uint8_t* out_data,
                      int32_t n_threads) {
    if (n_out <= 0) return;
    int threads = std::max(1, (int)n_threads);
    int64_t total = out_offsets[n_out];
    // Partition output rows so each thread copies ~equal BYTES, not rows
    // (row sizes are ragged; equal-row chunks would skew badly).
    std::vector<std::thread> pool;
    pool.reserve(threads);
    int64_t bytes_per_thread = (total + threads - 1) / threads;
    int64_t row = 0;
    for (int t = 0; t < threads && row < n_out; t++) {
        int64_t start_row = row;
        int64_t target = std::min(total, (int64_t)(t + 1) * bytes_per_thread);
        // advance to the first row whose start offset reaches the target
        while (row < n_out && out_offsets[row] < target) row++;
        int64_t end_row = row;
        pool.emplace_back([=]() {
            for (int64_t i = start_row; i < end_row; i++) {
                int64_t src = perm[i];
                int64_t len = offsets[src + 1] - offsets[src];
                if (len > 0) {
                    std::memcpy(out_data + out_offsets[i],
                                data + offsets[src], (size_t)len);
                }
            }
        });
    }
    for (auto& th : pool) th.join();
}

// Concatenate ragged u8 arrays: caller passes flattened descriptor arrays.
void concat_ragged_u8(const uint8_t** datas, const int64_t* sizes,
                      int64_t n_parts, uint8_t* out_data,
                      int32_t n_threads) {
    std::vector<int64_t> starts(n_parts + 1, 0);
    for (int64_t i = 0; i < n_parts; i++) starts[i + 1] = starts[i] + sizes[i];
    int threads = std::max(1, (int)n_threads);
    std::vector<std::thread> pool;
    int64_t per = (n_parts + threads - 1) / threads;
    for (int t = 0; t < threads; t++) {
        int64_t lo = t * per, hi = std::min<int64_t>(n_parts, lo + per);
        if (lo >= hi) break;
        pool.emplace_back([=, &starts]() {
            for (int64_t i = lo; i < hi; i++) {
                if (sizes[i] > 0)
                    std::memcpy(out_data + starts[i], datas[i],
                                (size_t)sizes[i]);
            }
        });
    }
    for (auto& th : pool) th.join();
}


// Adjacent-row equality over a ragged u8 array: for each candidate index
// cand[j] (caller guarantees rows cand[j] and cand[j]+1 have equal byte
// length), out[j] = 1 iff the two rows' bytes match.  Per-pair memcmp
// across threads — the numpy formulation materializes an int64 index per
// BYTE (8x expansion) on the grouping/combine hot path.
void adjacent_equal_u8(const uint8_t* data, const int64_t* offsets,
                       const int64_t* cand, int64_t n_cand,
                       uint8_t* out, int32_t n_threads) {
    if (n_cand <= 0) return;
    int threads = std::max(1, (int)n_threads);
    std::vector<std::thread> pool;
    int64_t per = (n_cand + threads - 1) / threads;
    for (int t = 0; t < threads; t++) {
        int64_t lo = t * per, hi = std::min<int64_t>(n_cand, lo + per);
        if (lo >= hi) break;
        pool.emplace_back([=]() {
            for (int64_t j = lo; j < hi; j++) {
                int64_t i = cand[j];
                int64_t len = offsets[i + 1] - offsets[i];
                out[j] = (len == 0) ||
                    std::memcmp(data + offsets[i], data + offsets[i + 1],
                                (size_t)len) == 0;
            }
        });
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Key partitioning (host engine).  The span sort itself lives in
// spansort.cpp (v2: register-packed 12-byte prefixes + duplication-aware
// dedup-rank fast path).
// ---------------------------------------------------------------------------

extern "C" {

// 32-bit FNV-1a over each full key, mod num_partitions — must stay
// byte-identical to the device kernel and numpy host partitioner.
void tz_fnv32_partition(const uint8_t* key_bytes, const int64_t* key_offsets,
                        int64_t n, int32_t num_partitions, int32_t* parts,
                        int32_t n_threads) {
    if (n <= 0) return;
    int threads = std::max(1, (int)n_threads);
    std::vector<std::thread> pool;
    int64_t per = (n + threads - 1) / threads;
    for (int t = 0; t < threads; t++) {
        int64_t lo = t * per, hi = std::min<int64_t>(n, lo + per);
        if (lo >= hi) break;
        pool.emplace_back([=]() {
            for (int64_t i = lo; i < hi; i++) {
                uint32_t h = 2166136261u;
                for (int64_t j = key_offsets[i]; j < key_offsets[i + 1]; j++) {
                    h ^= key_bytes[j];
                    h *= 16777619u;
                }
                parts[i] = (int32_t)(h % (uint32_t)num_partitions);
            }
        });
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Hash aggregation (map-side combine).
//
// The reference runs its combiner AFTER the sort, over each spill
// (PipelinedSorter semantics); on TPU the economics invert — collapsing
// duplicate keys BEFORE the device sort shrinks the expensive step
// (pad/lanes/sort/gather) by the duplication factor.  These helpers give
// the host a C-speed open-addressing hash table for that pre-combine and
// for fused tokenize+count (the WordCount family's entire map task).
// ---------------------------------------------------------------------------

namespace {

inline uint64_t fnv1a(const uint8_t* p, int64_t len) {
    uint64_t h = 1469598103934665603ull;
    for (int64_t i = 0; i < len; i++) {
        h ^= p[i];
        h *= 1099511628211ull;
    }
    return h;
}

// Open-addressing table mapping byte-string keys -> int64 accumulator.
// Keys are appended to an arena on first occurrence; emit order is
// first-occurrence order (deterministic for a given input).
struct HashAgg {
    std::vector<int64_t> table;      // entry index + 1; 0 = empty
    struct Entry { uint64_t hash; int64_t off; int32_t len; int64_t acc; };
    std::vector<Entry> entries;
    std::vector<uint8_t> arena;
    uint64_t mask;

    HashAgg() : table(1 << 12, 0), mask((1 << 12) - 1) {}

    void grow() {
        size_t ns = table.size() * 2;
        std::vector<int64_t>(ns, 0).swap(table);
        mask = ns - 1;
        for (size_t e = 0; e < entries.size(); e++) {
            uint64_t slot = entries[e].hash & mask;
            while (table[slot]) slot = (slot + 1) & mask;
            table[slot] = (int64_t)e + 1;
        }
    }

    void add(const uint8_t* key, int64_t len, int64_t value) {
        uint64_t h = fnv1a(key, len);
        uint64_t slot = h & mask;
        while (true) {
            int64_t idx = table[slot];
            if (idx == 0) break;
            const Entry& e = entries[idx - 1];
            if (e.hash == h && e.len == len &&
                std::memcmp(arena.data() + e.off, key, (size_t)len) == 0) {
                entries[idx - 1].acc += value;
                return;
            }
            slot = (slot + 1) & mask;
        }
        int64_t off = (int64_t)arena.size();
        arena.insert(arena.end(), key, key + len);
        entries.push_back({h, off, (int32_t)len, value});
        table[slot] = (int64_t)entries.size();
        if (entries.size() * 10 > table.size() * 7) grow();
    }
};

}  // namespace

extern "C" {

// --- fused tokenize + count (stateful across feeds) ----------------------
// Contract: each feed() is whitespace-complete (the text reader yields
// line-aligned chunks), so tokens never span feed boundaries.

// bytes.split() whitespace set: space \t \n \v \f \r
static inline bool tz_is_ws(uint8_t c) {
    return c == 32 || (c >= 9 && c <= 13);
}

void* tz_wc_create() { return new HashAgg(); }

void tz_wc_feed(void* handle, const uint8_t* data, int64_t n) {
    HashAgg* agg = (HashAgg*)handle;
    int64_t i = 0;
    while (i < n) {
        while (i < n && tz_is_ws(data[i])) i++;
        int64_t start = i;
        while (i < n && !tz_is_ws(data[i])) i++;
        if (i > start) agg->add(data + start, i - start, 1);
    }
}

void tz_wc_stats(void* handle, int64_t* n_unique, int64_t* total_key_bytes) {
    HashAgg* agg = (HashAgg*)handle;
    *n_unique = (int64_t)agg->entries.size();
    *total_key_bytes = (int64_t)agg->arena.size();
}

// key_offsets: n_unique+1 entries; key_bytes: arena size; counts: n_unique
void tz_wc_emit(void* handle, uint8_t* key_bytes, int64_t* key_offsets,
                int64_t* counts) {
    HashAgg* agg = (HashAgg*)handle;
    std::memcpy(key_bytes, agg->arena.data(), agg->arena.size());
    int64_t off = 0;
    for (size_t e = 0; e < agg->entries.size(); e++) {
        key_offsets[e] = off;
        off += agg->entries[e].len;
        counts[e] = agg->entries[e].acc;
    }
    key_offsets[agg->entries.size()] = off;
}

void tz_wc_destroy(void* handle) { delete (HashAgg*)handle; }

// --- raw whitespace split (no combine): one pass, compacted words --------
// out_bytes: caller-allocated n bytes (worst case: no whitespace);
// out_offsets: caller-allocated (n+1)/2 + 2 entries.  Returns word count.
int64_t tz_split_ws(const uint8_t* data, int64_t n, uint8_t* out_bytes,
                    int64_t* out_offsets) {
    int64_t words = 0, out = 0, i = 0;
    out_offsets[0] = 0;
    while (i < n) {
        while (i < n && tz_is_ws(data[i])) i++;
        int64_t start = i;
        while (i < n && !tz_is_ws(data[i])) i++;
        if (i > start) {
            std::memcpy(out_bytes + out, data + start, (size_t)(i - start));
            out += i - start;
            out_offsets[++words] = out;
        }
    }
    return words;
}

// --- generic pre-sort combine: sum int64 values of equal keys -------------
// first_idx[u] = record index of key u's first occurrence (caller gathers
// the key bytes); sums[u] = total value.  Both sized n by the caller.
// Returns the number of unique keys.
int64_t hash_sum_i64(const uint8_t* key_bytes, const int64_t* key_offsets,
                     int64_t n, const int64_t* values,
                     int64_t* first_idx, int64_t* sums) {
    HashAgg agg;
    // remember first-occurrence record index per unique key: the arena
    // offset uniquely identifies the entry, so track indices alongside
    std::vector<int64_t> firsts;
    firsts.reserve(1024);
    for (int64_t i = 0; i < n; i++) {
        size_t before = agg.entries.size();
        agg.add(key_bytes + key_offsets[i],
                key_offsets[i + 1] - key_offsets[i], values[i]);
        if (agg.entries.size() > before) firsts.push_back(i);
    }
    for (size_t u = 0; u < agg.entries.size(); u++) {
        first_idx[u] = firsts[u];
        sums[u] = agg.entries[u].acc;
    }
    return (int64_t)agg.entries.size();
}

}  // extern "C"
