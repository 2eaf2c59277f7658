// Host span sort + run merge.
//
// The reference's ordered data plane sorts (partition, key) records with a
// comparison sort over serialized bytes (PipelinedSorter.java:75 sortmaster
// + TezMerger.java:76 merge queue).  This host engine keeps those semantics
// (stable (partition, full key bytes) order, byte-identical output) but is
// shaped for how shuffle keys actually look — short keys with heavy
// duplication (wordcount families: zipfian vocab) — and for cache behavior:
//
//  * items pack the FIRST 12 key bytes into registers ({u64 prefix,
//    u32 prefix2, u32 idx} = 16 bytes): compares never touch key memory
//    unless both keys exceed 12 bytes.  The previous 8-byte prefix fell
//    through to memcmp on nearly every compare for zero-padded numeric
//    keys whose first 8 bytes carry almost no entropy.
//  * duplication-aware fast path: hash (partition, key) -> unique id,
//    comparison-sort ONLY the uniques, then one stable O(n) counting
//    scatter of the records.  A 32k-record sample gates the path so
//    near-unique spans take the direct sort instead.
//
// Exported: tz_sort_partition_keys, tz_merge_runs, tz_span_sort_emit,
// tz_merge_emit, gather_fixed_u8 (bound in ops/native.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" void tz_fnv32_partition(const uint8_t*, const int64_t*, int64_t,
                                   int32_t, int32_t*, int32_t);  // ragged.cpp

namespace {

inline uint64_t load_be64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    v = __builtin_bswap64(v);
#endif
    return v;
}

inline uint32_t load_be32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    v = __builtin_bswap32(v);
#endif
    return v;
}

// Big-endian zero-padded prefixes of the first 12 key bytes: unsigned
// compare of (prefix, prefix2) orders exactly like memcmp of those bytes.
inline void key_prefix12(const uint8_t* p, int64_t len,
                         uint64_t& pre, uint32_t& pre2) {
    if (len >= 12) {
        pre = load_be64(p);
        pre2 = load_be32(p + 8);
        return;
    }
    pre = 0;
    pre2 = 0;
    int64_t m = len < 8 ? len : 8;
    for (int64_t i = 0; i < m; i++) pre |= (uint64_t)p[i] << (56 - 8 * i);
    for (int64_t i = 8; i < len; i++)
        pre2 |= (uint32_t)p[i] << (24 - 8 * (i - 8));
}

struct Item { uint64_t prefix; uint32_t prefix2; uint32_t idx; };

// Total order == stable result: ties on the full key fall to idx.
struct ItemCmp {
    const uint8_t* kb;
    const int64_t* ko;
    bool operator()(const Item& a, const Item& b) const {
        if (a.prefix != b.prefix) return a.prefix < b.prefix;
        if (a.prefix2 != b.prefix2) return a.prefix2 < b.prefix2;
        int64_t la = ko[a.idx + 1] - ko[a.idx];
        int64_t lb = ko[b.idx + 1] - ko[b.idx];
        if (la > 12 && lb > 12) {
            int64_t m = (la < lb ? la : lb) - 12;
            int c = std::memcmp(kb + ko[a.idx] + 12, kb + ko[b.idx] + 12,
                                (size_t)m);
            if (c) return c < 0;
        }
        if (la != lb) return la < lb;
        return a.idx < b.idx;
    }
};

inline uint64_t fnv64(const uint8_t* p, int64_t len) {
    uint64_t h = 1469598103934665603ull;
    for (int64_t i = 0; i < len; i++) {
        h ^= p[i];
        h *= 1099511628211ull;
    }
    return h;
}

// One pass, both hashes: the 64-bit dedup hash and the 32-bit partition
// hash (must stay byte-identical to tz_fnv32_partition / the device
// partitioner).
inline void fnv_both(const uint8_t* p, int64_t len,
                     uint64_t& h64, uint32_t& h32) {
    uint64_t h = 1469598103934665603ull;
    uint32_t g = 2166136261u;
    for (int64_t i = 0; i < len; i++) {
        h ^= p[i];
        h *= 1099511628211ull;
        g ^= p[i];
        g *= 16777619u;
    }
    h64 = h;
    h32 = g;
}

// Uniform row width of a ragged offsets array, or -1.
inline int64_t fixed_width(const int64_t* off, int64_t n) {
    if (n <= 0) return -1;
    int64_t w = off[1] - off[0];
    if (w < 0 || off[n] - off[0] != n * w) return -1;
    for (int64_t i = 1; i < n; i++)
        if (off[i + 1] - off[i] != w) return -1;
    return w;
}

// Compile-time-size row copy for the common serde widths.
inline void copy_row(uint8_t* dst, const uint8_t* src, int64_t w) {
    switch (w) {
    case 8:  std::memcpy(dst, src, 8); break;
    case 12: std::memcpy(dst, src, 12); break;
    case 16: std::memcpy(dst, src, 16); break;
    default: std::memcpy(dst, src, (size_t)w);
    }
}

// ---- duplication-aware machinery -----------------------------------------

// Open-addressing map of (partition, key bytes) -> unique id.  Keys are
// referenced in place (the span's byte arrays outlive the call); no arena.
struct UniqTable {
    struct Entry { uint64_t hash; int64_t rec; int32_t part; int64_t count; };
    std::vector<uint32_t> slots;   // entry index + 1; 0 = empty
    std::vector<Entry> entries;
    uint64_t mask;
    const uint8_t* kb;
    const int64_t* ko;

    UniqTable(const uint8_t* kb_, const int64_t* ko_, int64_t expect)
        : kb(kb_), ko(ko_) {
        size_t cap = 1024;
        while ((int64_t)cap < expect * 2) cap <<= 1;
        slots.assign(cap, 0);
        mask = cap - 1;
    }

    void grow() {
        size_t ns = slots.size() * 2;
        std::vector<uint32_t>(ns, 0).swap(slots);
        mask = ns - 1;
        for (size_t e = 0; e < entries.size(); e++) {
            uint64_t slot = entries[e].hash & mask;
            while (slots[slot]) slot = (slot + 1) & mask;
            slots[slot] = (uint32_t)e + 1;
        }
    }

    inline uint32_t add(int64_t rec, int32_t part) {
        const uint8_t* key = kb + ko[rec];
        int64_t len = ko[rec + 1] - ko[rec];
        uint64_t h = fnv64(key, len) ^
            (0x9E3779B97F4A7C15ull * (uint64_t)(part + 1));
        uint64_t slot = h & mask;
        while (true) {
            uint32_t idx = slots[slot];
            if (idx == 0) break;
            Entry& e = entries[idx - 1];
            int64_t elen = ko[e.rec + 1] - ko[e.rec];
            if (e.hash == h && e.part == part && elen == len &&
                std::memcmp(kb + ko[e.rec], key, (size_t)len) == 0) {
                e.count++;
                return idx - 1;
            }
            slot = (slot + 1) & mask;
        }
        entries.push_back({h, rec, part, 1});
        slots[slot] = (uint32_t)entries.size();
        if (entries.size() * 10 > slots.size() * 7) grow();
        return (uint32_t)entries.size() - 1;
    }

    // Identity by key bytes alone; the partition derives from the key's
    // fnv32 at first insertion (a hash partition is a pure function of
    // the key, so equal keys can never land in different partitions).
    // Saves the separate whole-span fnv32 pass.
    inline uint32_t add_derive(int64_t rec, int32_t num_partitions) {
        const uint8_t* key = kb + ko[rec];
        int64_t len = ko[rec + 1] - ko[rec];
        uint64_t h; uint32_t g;
        fnv_both(key, len, h, g);
        uint64_t slot = h & mask;
        while (true) {
            uint32_t idx = slots[slot];
            if (idx == 0) break;
            Entry& e = entries[idx - 1];
            int64_t elen = ko[e.rec + 1] - ko[e.rec];
            if (e.hash == h && elen == len &&
                std::memcmp(kb + ko[e.rec], key, (size_t)len) == 0) {
                e.count++;
                return idx - 1;
            }
            slot = (slot + 1) & mask;
        }
        entries.push_back({h, rec,
                           (int32_t)(g % (uint32_t)num_partitions), 1});
        slots[slot] = (uint32_t)entries.size();
        if (entries.size() * 10 > slots.size() * 7) grow();
        return (uint32_t)entries.size() - 1;
    }
};

// Sampled uniqueness estimate: distinct 64-bit hashes in the first
// `sample` records (hash collisions only ever UNDER-count, which biases
// toward the dedup path — harmless).  Returns distinct count.
int64_t sample_distinct(const uint8_t* kb, const int64_t* ko,
                        const int32_t* parts, int64_t sample) {
    size_t cap = 1;
    while ((int64_t)cap < sample * 2) cap <<= 1;
    std::vector<uint64_t> set(cap, 0);
    uint64_t mask = cap - 1;
    int64_t distinct = 0;
    for (int64_t i = 0; i < sample; i++) {
        int32_t part = parts ? parts[i] : 0;
        uint64_t h = fnv64(kb + ko[i], ko[i + 1] - ko[i]) ^
            (0x9E3779B97F4A7C15ull * (uint64_t)(part + 1));
        if (h == 0) h = 1;
        uint64_t slot = h & mask;
        while (set[slot] != 0 && set[slot] != h) slot = (slot + 1) & mask;
        if (set[slot] == 0) { set[slot] = h; distinct++; }
    }
    return distinct;
}

// Shared dedup-rank machinery: hash records to uniques (optionally
// deriving the partition from the key's fnv32), sort the uniques by
// (partition, key bytes), and compute per-unique rank + output start
// offsets.  Both the permutation-only sort and the fused emit build on
// this — one copy of the tie-break and table logic.
struct DedupRank {
    UniqTable table;
    std::vector<uint32_t> uids;    // per record -> unique id
    std::vector<Item> items;       // uniques in sorted output order
    std::vector<uint32_t> rank;    // unique id -> sorted position
    std::vector<int64_t> start;    // sorted position -> output row offset

    DedupRank(const uint8_t* kb, const int64_t* ko, const int32_t* parts,
              int64_t n, int64_t expect_uniques,
              int32_t derive_partitions /* 0 = use parts */)
        : table(kb, ko, expect_uniques), uids((size_t)n) {
        if (derive_partitions > 1) {
            for (int64_t i = 0; i < n; i++)
                uids[(size_t)i] = table.add_derive(i, derive_partitions);
        } else {
            for (int64_t i = 0; i < n; i++)
                uids[(size_t)i] = table.add(i, parts ? parts[i] : 0);
        }
        int64_t u = (int64_t)table.entries.size();
        // sort unique entries by (partition, key bytes); all entries are
        // distinct so no stability concern at this level
        items.resize((size_t)u);
        for (int64_t e = 0; e < u; e++) {
            int64_t rec = table.entries[(size_t)e].rec;
            uint64_t pre; uint32_t pre2;
            key_prefix12(kb + ko[rec], ko[rec + 1] - ko[rec], pre, pre2);
            items[(size_t)e] = {pre, pre2, (uint32_t)e};
        }
        ItemCmp base{kb, ko};
        std::sort(items.begin(), items.end(),
                  [&](const Item& a, const Item& b) {
            int32_t pa = table.entries[a.idx].part;
            int32_t pb = table.entries[b.idx].part;
            if (pa != pb) return pa < pb;
            Item ra{a.prefix, a.prefix2, (uint32_t)table.entries[a.idx].rec};
            Item rb{b.prefix, b.prefix2, (uint32_t)table.entries[b.idx].rec};
            return base(ra, rb);
        });
        // rank per unique, output start offset per rank
        start.resize((size_t)u);
        rank.resize((size_t)u);
        int64_t off = 0;
        for (int64_t r = 0; r < u; r++) {
            uint32_t e = items[(size_t)r].idx;
            rank[e] = (uint32_t)r;
            start[(size_t)r] = off;
            off += table.entries[e].count;
        }
    }

    // stable permutation: records scatter to their rank group in
    // original order
    void fill_perm(int64_t n, int64_t* perm) const {
        std::vector<int64_t> cursor(start);
        for (int64_t i = 0; i < n; i++)
            perm[(size_t)cursor[rank[uids[(size_t)i]]]++] = i;
    }
};

// Stable sort permutation via dedup-rank: hash records to uniques, sort
// uniques by (partition, key), counting-scatter records by rank.
void dedup_rank_sort(const uint8_t* kb, const int64_t* ko,
                     const int32_t* parts, int64_t n, int64_t* perm,
                     int64_t expect_uniques) {
    DedupRank dr(kb, ko, parts, n, expect_uniques, 0);
    dr.fill_perm(n, perm);
}

struct Range { int64_t lo, hi; };
struct MJob { int64_t lo, mid, hi; };

template <typename Cmp>
void parallel_sort_ranges(std::vector<Item>& items,
                          const std::vector<int64_t>& pstart,
                          int64_t nparts, int64_t n, int threads,
                          const Cmp& cmp) {
    if (threads == 1 || n < (1 << 15)) {
        for (int64_t p = 0; p < nparts; p++)
            std::sort(items.begin() + pstart[p],
                      items.begin() + pstart[p + 1], cmp);
        return;
    }
    // two-level parallelism: chunk each partition range, sort chunks on a
    // pool, then ladder pairwise inplace_merges (one dominant partition
    // still uses every thread)
    int64_t target = std::max<int64_t>(1 << 15, n / threads / 2 + 1);
    std::vector<std::vector<int64_t>> chunk_bounds((size_t)nparts);
    std::vector<Range> jobs;
    for (int64_t p = 0; p < nparts; p++) {
        int64_t lo = pstart[p], hi = pstart[p + 1];
        int64_t len = hi - lo;
        int64_t k = std::max<int64_t>(1, (len + target - 1) / target);
        auto& cb = chunk_bounds[(size_t)p];
        cb.resize((size_t)k + 1);
        for (int64_t c = 0; c <= k; c++) cb[(size_t)c] = lo + len * c / k;
        for (int64_t c = 0; c < k; c++)
            jobs.push_back({cb[(size_t)c], cb[(size_t)c + 1]});
    }
    {
        std::atomic<size_t> next(0);
        std::vector<std::thread> pool;
        int nt = std::min<int64_t>(threads, (int64_t)jobs.size());
        for (int t = 0; t < nt; t++)
            pool.emplace_back([&]() {
                for (size_t j; (j = next.fetch_add(1)) < jobs.size();)
                    std::sort(items.begin() + jobs[j].lo,
                              items.begin() + jobs[j].hi, cmp);
            });
        for (auto& th : pool) th.join();
    }
    for (int64_t step = 1;; step *= 2) {
        std::vector<MJob> mjobs;
        for (int64_t p = 0; p < nparts; p++) {
            auto& cb = chunk_bounds[(size_t)p];
            int64_t k = (int64_t)cb.size() - 1;
            for (int64_t c = 0; c + step < k; c += 2 * step) {
                int64_t hi_idx = std::min<int64_t>(k, c + 2 * step);
                mjobs.push_back({cb[(size_t)c], cb[(size_t)(c + step)],
                                 cb[(size_t)hi_idx]});
            }
        }
        if (mjobs.empty()) break;
        std::atomic<size_t> next(0);
        std::vector<std::thread> pool;
        int nt = std::min<int64_t>(threads, (int64_t)mjobs.size());
        for (int t = 0; t < nt; t++)
            pool.emplace_back([&]() {
                for (size_t j; (j = next.fetch_add(1)) < mjobs.size();)
                    std::inplace_merge(items.begin() + mjobs[j].lo,
                                       items.begin() + mjobs[j].mid,
                                       items.begin() + mjobs[j].hi, cmp);
            });
        for (auto& th : pool) th.join();
    }
}

}  // namespace

extern "C" {

// Stable sort permutation of rows by (partition, key bytes).  partitions
// may be null (single-partition sort, e.g. run merges).  See the header.
void tz_sort_partition_keys(const uint8_t* key_bytes,
                            const int64_t* key_offsets,
                            const int32_t* partitions, int64_t n,
                            int64_t* perm, int32_t n_threads) {
    if (n <= 0) return;
    if (n > 0x7FFFFFFFll - 2) {
        // u32 idx packing would overflow; spans never get near this (the
        // span budget caps records long before 2^31), but stay correct
        std::vector<int64_t> idx((size_t)n);
        for (int64_t i = 0; i < n; i++) idx[(size_t)i] = i;
        std::stable_sort(idx.begin(), idx.end(),
            [&](int64_t a, int64_t b) {
                int32_t pa = partitions ? partitions[a] : 0;
                int32_t pb = partitions ? partitions[b] : 0;
                if (pa != pb) return pa < pb;
                int64_t la = key_offsets[a + 1] - key_offsets[a];
                int64_t lb = key_offsets[b + 1] - key_offsets[b];
                int64_t m = la < lb ? la : lb;
                int c = std::memcmp(key_bytes + key_offsets[a],
                                    key_bytes + key_offsets[b], (size_t)m);
                if (c) return c < 0;
                return la < lb;
            });
        std::memcpy(perm, idx.data(), (size_t)n * 8);
        return;
    }

    // duplication gate: a 32k sample decides dedup-rank vs direct sort
    int64_t sample = n < 32768 ? n : 32768;
    if (n >= 4096) {
        int64_t distinct = sample_distinct(key_bytes, key_offsets,
                                           partitions, sample);
        if (distinct * 2 < sample) {
            int64_t expect = distinct * (n / sample + 1) + 16;
            dedup_rank_sort(key_bytes, key_offsets, partitions, n, perm,
                            expect);
            return;
        }
    }

    // direct path: stable counting sort by partition, then per-partition
    // value sort of packed 16-byte items
    std::vector<Item> items((size_t)n);
    int64_t nparts = 1;
    std::vector<int64_t> pstart;
    if (partitions != nullptr) {
        int32_t maxp = 0;
        for (int64_t i = 0; i < n; i++)
            if (partitions[i] > maxp) maxp = partitions[i];
        nparts = (int64_t)maxp + 1;
        pstart.assign((size_t)nparts + 1, 0);
        for (int64_t i = 0; i < n; i++) pstart[partitions[i] + 1]++;
        for (int64_t p = 0; p < nparts; p++) pstart[p + 1] += pstart[p];
        std::vector<int64_t> cur(pstart.begin(), pstart.end() - 1);
        for (int64_t i = 0; i < n; i++) {
            uint64_t pre; uint32_t pre2;
            key_prefix12(key_bytes + key_offsets[i],
                         key_offsets[i + 1] - key_offsets[i], pre, pre2);
            items[(size_t)cur[partitions[i]]++] = {pre, pre2, (uint32_t)i};
        }
    } else {
        pstart = {0, n};
        for (int64_t i = 0; i < n; i++) {
            uint64_t pre; uint32_t pre2;
            key_prefix12(key_bytes + key_offsets[i],
                         key_offsets[i + 1] - key_offsets[i], pre, pre2);
            items[(size_t)i] = {pre, pre2, (uint32_t)i};
        }
    }
    ItemCmp cmp{key_bytes, key_offsets};
    parallel_sort_ranges(items, pstart, nparts, n,
                         std::max(1, (int)n_threads), cmp);
    for (int64_t i = 0; i < n; i++) perm[i] = items[(size_t)i].idx;
}

// Merge k (partition, key)-sorted runs into one stable permutation.
// Rows are the CONCATENATION of the runs; run_bounds has k+1 entries.
// Equal (partition, key) rows keep concatenation order == run age order
// (MergeQueue semantics) — which a stable full sort also guarantees, so
// the duplication fast path may re-derive the order by dedup-rank.
void tz_merge_runs(const uint8_t* key_bytes, const int64_t* key_offsets,
                   const int32_t* partitions, const int64_t* run_bounds,
                   int32_t num_runs, int64_t* perm, int32_t n_threads) {
    int64_t n = run_bounds[num_runs];
    if (n <= 0) return;
    if (n > 0x7FFFFFFFll - 2) {
        tz_sort_partition_keys(key_bytes, key_offsets, partitions, n, perm,
                               n_threads);
        return;
    }
    // duplication gate (sample the first run's records — representative
    // because every run drew from the same producer stream)
    int64_t sample = n < 32768 ? n : 32768;
    if (n >= 4096) {
        int64_t distinct = sample_distinct(key_bytes, key_offsets,
                                           partitions, sample);
        if (distinct * 2 < sample) {
            int64_t expect = distinct * (n / sample + 1) + 16;
            dedup_rank_sort(key_bytes, key_offsets, partitions, n, perm,
                            expect);
            return;
        }
    }
    struct PCmp {
        const int32_t* parts;
        ItemCmp base;
        bool operator()(const Item& a, const Item& b) const {
            if (parts != nullptr && parts[a.idx] != parts[b.idx])
                return parts[a.idx] < parts[b.idx];
            return base(a, b);
        }
    };
    std::vector<Item> items((size_t)n);
    for (int64_t i = 0; i < n; i++) {
        uint64_t pre; uint32_t pre2;
        key_prefix12(key_bytes + key_offsets[i],
                     key_offsets[i + 1] - key_offsets[i], pre, pre2);
        items[(size_t)i] = {pre, pre2, (uint32_t)i};
    }
    PCmp cmp{partitions, ItemCmp{key_bytes, key_offsets}};
    int threads = std::max(1, (int)n_threads);
    for (int64_t step = 1; step < num_runs; step *= 2) {
        std::vector<MJob> jobs;
        for (int64_t r = 0; r + step < num_runs; r += 2 * step) {
            int64_t hi = std::min<int64_t>(num_runs, r + 2 * step);
            jobs.push_back({run_bounds[r], run_bounds[r + step],
                            run_bounds[hi]});
        }
        int nt = std::min<int64_t>(threads, (int64_t)jobs.size());
        if (nt <= 1 || n < (1 << 15)) {
            for (const MJob& j : jobs)
                std::inplace_merge(items.begin() + j.lo,
                                   items.begin() + j.mid,
                                   items.begin() + j.hi, cmp);
        } else {
            std::atomic<size_t> next(0);
            std::vector<std::thread> pool;
            for (int t = 0; t < nt; t++)
                pool.emplace_back([&]() {
                    for (size_t j; (j = next.fetch_add(1)) < jobs.size();)
                        std::inplace_merge(items.begin() + jobs[j].lo,
                                           items.begin() + jobs[j].mid,
                                           items.begin() + jobs[j].hi, cmp);
                });
            for (auto& th : pool) th.join();
        }
    }
    for (int64_t i = 0; i < n; i++) perm[i] = items[(size_t)i].idx;
}

// Fused producer span sort + materialization: one call replaces
// fnv-partition, sort-permutation, and the two take() gathers.  Sorted key
// bytes emit as sequential writes (on the dedup path each unique key's
// bytes repeat in place — a single cached source row per group); values
// follow the stable permutation.  Fixed-width rows (the long/word serde
// common case) use compile-time-size copies and vectorized offset fills.
// Semantics identical to tz_sort_partition_keys + gather: stable
// (partition, full key bytes) order, byte-identical output.
//   parts_in    : per-row partitions, or null
//   compute_hash: when parts_in is null — 1 = fnv32(key) % num_partitions
//                 (PipelinedSorter hash-partition parity), 0 = all rows in
//                 partition 0
//   out_parts   : per-row partition of the sorted output, or null to skip
//   part_counts : int64[num_partitions], zeroed and filled here
// Returns 0 on success.
int32_t tz_span_sort_emit(
        const uint8_t* kb, const int64_t* ko,
        const uint8_t* vb, const int64_t* vo,
        int64_t n, int32_t num_partitions, const int32_t* parts_in,
        int32_t compute_hash,
        uint8_t* out_kb, int64_t* out_ko,
        uint8_t* out_vb, int64_t* out_vo,
        int32_t* out_parts, int64_t* part_counts, int32_t n_threads) {
    // mirror the n > INT32_MAX-2 fallback: with num_partitions <= 0 the
    // part_counts buffer is zero-length and every row would emit through
    // part_counts[0] — reject before touching any output buffer
    if (num_partitions <= 0) return -1;
    for (int32_t p = 0; p < num_partitions; p++) part_counts[p] = 0;
    out_ko[0] = 0;
    out_vo[0] = 0;
    if (n <= 0) return 0;
    if (n > 0x7FFFFFFFll - 2) return -1;   // u32 row ids: the caller raises

    const int32_t* parts = parts_in;
    if (parts != nullptr) {
        // range-check custom partitions: the buffers here are sized
        // num_partitions, so an out-of-range id is heap corruption, not a
        // wrong answer.  Reject: the caller raises on the bad partitioner
        // output.
        for (int64_t i = 0; i < n; i++)
            if (parts[i] < 0 || parts[i] >= num_partitions) return -2;
    }
    bool derive = parts == nullptr && compute_hash && num_partitions > 1;
    int64_t wk = fixed_width(ko, n);
    int64_t wv = fixed_width(vo, n);

    int64_t sample = n < 32768 ? n : 32768;
    int64_t distinct = n >= 4096 ?
        sample_distinct(kb, ko, derive ? nullptr : parts, sample) : sample;

    if (n >= 4096 && distinct * 2 < sample) {
        // ---- dedup-rank path: hash records to uniques (partition derives
        // from the key's own fnv32 — no separate partition pass), sort
        // only the uniques, emit rank groups
        DedupRank dr(kb, ko, parts, n, distinct * (n / sample + 1) + 16,
                     derive ? num_partitions : 0);
        const UniqTable& table = dr.table;
        int64_t u = (int64_t)table.entries.size();
        // keys: each rank's unique bytes repeat count times — sequential
        // writes from one cached source row
        if (wk >= 0) {
            int64_t kpos = 0;
            for (int64_t r = 0; r < u; r++) {
                const UniqTable::Entry& e =
                    table.entries[dr.items[(size_t)r].idx];
                const uint8_t* src = kb + (int64_t)e.rec * wk;
                for (int64_t c = 0; c < e.count; c++) {
                    copy_row(out_kb + kpos, src, wk);
                    kpos += wk;
                }
                part_counts[e.part] += e.count;
            }
            for (int64_t i = 0; i <= n; i++) out_ko[i] = i * wk;
        } else {
            int64_t kpos = 0, row = 0;
            for (int64_t r = 0; r < u; r++) {
                const UniqTable::Entry& e =
                    table.entries[dr.items[(size_t)r].idx];
                const uint8_t* src = kb + ko[e.rec];
                int64_t len = ko[e.rec + 1] - ko[e.rec];
                for (int64_t c = 0; c < e.count; c++) {
                    if (len > 0)
                        std::memcpy(out_kb + kpos, src, (size_t)len);
                    kpos += len;
                    out_ko[++row] = kpos;
                }
                part_counts[e.part] += e.count;
            }
        }
        if (out_parts != nullptr) {
            for (int64_t r = 0; r < u; r++) {
                const UniqTable::Entry& e =
                    table.entries[dr.items[(size_t)r].idx];
                std::fill(out_parts + dr.start[(size_t)r],
                          out_parts + dr.start[(size_t)r] + e.count, e.part);
            }
        }
        // values: stable scatter straight into output slots (no
        // intermediate permutation array for fixed-width values)
        if (wv >= 0) {
            std::vector<int64_t> cursor(dr.start);
            for (int64_t i = 0; i < n; i++) {
                int64_t slot = cursor[dr.rank[dr.uids[(size_t)i]]]++;
                copy_row(out_vb + slot * wv, vb + i * wv, wv);
            }
            for (int64_t i = 0; i <= n; i++) out_vo[i] = i * wv;
        } else {
            std::vector<int64_t> perm((size_t)n);
            dr.fill_perm(n, perm.data());
            int64_t vpos = 0;
            for (int64_t j = 0; j < n; j++) {
                int64_t i = perm[(size_t)j];
                int64_t len = vo[i + 1] - vo[i];
                if (len > 0)
                    std::memcpy(out_vb + vpos, vb + vo[i], (size_t)len);
                vpos += len;
                out_vo[j + 1] = vpos;
            }
        }
        return 0;
    }

    // ---- direct path: counting sort by partition + item sort
    std::vector<int32_t> computed;
    if (derive) {
        computed.resize((size_t)n);
        tz_fnv32_partition(kb, ko, n, num_partitions, computed.data(),
                           n_threads);
        parts = computed.data();
    }
    std::vector<Item> items((size_t)n);
    int64_t nparts = 1;
    std::vector<int64_t> pstart;
    if (parts != nullptr) {
        nparts = num_partitions;
        pstart.assign((size_t)nparts + 1, 0);
        for (int64_t i = 0; i < n; i++) pstart[parts[i] + 1]++;
        for (int64_t p = 0; p < nparts; p++) pstart[p + 1] += pstart[p];
        std::vector<int64_t> cur(pstart.begin(), pstart.end() - 1);
        for (int64_t i = 0; i < n; i++) {
            uint64_t pre; uint32_t pre2;
            key_prefix12(kb + ko[i], ko[i + 1] - ko[i], pre, pre2);
            items[(size_t)cur[parts[i]]++] = {pre, pre2, (uint32_t)i};
        }
        for (int64_t p = 0; p < nparts; p++)
            part_counts[p] = pstart[p + 1] - pstart[p];
    } else {
        pstart = {0, n};
        for (int64_t i = 0; i < n; i++) {
            uint64_t pre; uint32_t pre2;
            key_prefix12(kb + ko[i], ko[i + 1] - ko[i], pre, pre2);
            items[(size_t)i] = {pre, pre2, (uint32_t)i};
        }
        part_counts[0] = n;
    }
    ItemCmp cmp{kb, ko};
    parallel_sort_ranges(items, pstart, nparts, n,
                         std::max(1, (int)n_threads), cmp);

    if (wk >= 0) {
        for (int64_t j = 0; j < n; j++)
            copy_row(out_kb + j * wk, kb + (int64_t)items[(size_t)j].idx * wk,
                     wk);
        for (int64_t i = 0; i <= n; i++) out_ko[i] = i * wk;
    } else {
        int64_t kpos = 0;
        for (int64_t j = 0; j < n; j++) {
            int64_t i = items[(size_t)j].idx;
            int64_t len = ko[i + 1] - ko[i];
            if (len > 0) std::memcpy(out_kb + kpos, kb + ko[i], (size_t)len);
            kpos += len;
            out_ko[j + 1] = kpos;
        }
    }
    if (out_parts != nullptr) {
        if (parts != nullptr) {
            for (int64_t j = 0; j < n; j++)
                out_parts[j] = parts[items[(size_t)j].idx];
        } else {
            std::fill(out_parts, out_parts + n, 0);
        }
    }
    if (wv >= 0) {
        for (int64_t j = 0; j < n; j++)
            copy_row(out_vb + j * wv, vb + (int64_t)items[(size_t)j].idx * wv,
                     wv);
        for (int64_t i = 0; i <= n; i++) out_vo[i] = i * wv;
    } else {
        int64_t vpos = 0;
        for (int64_t j = 0; j < n; j++) {
            int64_t i = items[(size_t)j].idx;
            int64_t len = vo[i + 1] - vo[i];
            if (len > 0) std::memcpy(out_vb + vpos, vb + vo[i], (size_t)len);
            vpos += len;
            out_vo[j + 1] = vpos;
        }
    }
    return 0;
}

// Fused k-run merge + materialization: the runs are already
// (partition, key)-sorted with equal keys adjacent, so the merge works on
// GROUPS — per run, scan adjacent rows into (partition, key)-groups, then
// k-way merge the group heads and emit each winning group as ONE
// contiguous segment copy from its source run (sequential reads, no
// per-row gather, no concatenation).  Equal (partition, key) groups
// across runs emit in run order == concatenation order (MergeQueue age
// semantics, TezMerger.java:76).
//   row_indices[r] : int64[num_partitions+1] partition bounds of run r
//   part_counts    : int64[num_partitions], zeroed and filled here
// Returns 0 on success.
int32_t tz_merge_emit(
        int32_t num_runs,
        const uint8_t** kbs, const int64_t** kos,
        const uint8_t** vbs, const int64_t** vos,
        const int64_t* nrows, const int64_t** row_indices,
        int32_t num_partitions,
        uint8_t* out_kb, int64_t* out_ko,
        uint8_t* out_vb, int64_t* out_vo,
        int32_t* out_parts, int64_t* part_counts, int32_t n_threads) {
    (void)n_threads;
    for (int32_t p = 0; p < num_partitions; p++) part_counts[p] = 0;
    out_ko[0] = 0;
    out_vo[0] = 0;

    // group scan per run: starts[] row indices where a new (partition,
    // key) group begins; gparts[] the group's partition
    struct RunGroups {
        std::vector<int64_t> starts;   // group start rows, + nrows sentinel
        std::vector<int32_t> gparts;
    };
    std::vector<RunGroups> groups((size_t)num_runs);
    for (int32_t r = 0; r < num_runs; r++) {
        int64_t m = nrows[r];
        auto& g = groups[(size_t)r];
        if (m == 0) { g.starts.push_back(0); continue; }
        const int64_t* ko = kos[r];
        const uint8_t* kb = kbs[r];
        const int64_t* ri = row_indices[r];
        g.starts.reserve(1024);
        g.gparts.reserve(1024);
        for (int32_t p = 0; p < num_partitions; p++) {
            int64_t lo = ri[p], hi = ri[p + 1];
            for (int64_t i = lo; i < hi; i++) {
                if (i == lo) {
                    g.starts.push_back(i);
                    g.gparts.push_back(p);
                    continue;
                }
                int64_t la = ko[i] - ko[i - 1];
                int64_t lb = ko[i + 1] - ko[i];
                if (la != lb ||
                    std::memcmp(kb + ko[i - 1], kb + ko[i],
                                (size_t)lb) != 0) {
                    g.starts.push_back(i);
                    g.gparts.push_back(p);
                }
            }
        }
        g.starts.push_back(m);
    }

    // head state per run: cached (part, prefix12) of the current group key
    struct Head {
        int64_t gi;          // group index
        int32_t part;
        uint64_t pre;
        uint32_t pre2;
    };
    std::vector<Head> heads((size_t)num_runs);
    auto load_head = [&](int32_t r) {
        auto& g = groups[(size_t)r];
        Head& h = heads[(size_t)r];
        if (h.gi >= (int64_t)g.gparts.size()) return;
        int64_t row = g.starts[(size_t)h.gi];
        const int64_t* ko = kos[r];
        key_prefix12(kbs[r] + ko[row], ko[row + 1] - ko[row], h.pre, h.pre2);
        h.part = g.gparts[(size_t)h.gi];
    };
    for (int32_t r = 0; r < num_runs; r++) {
        heads[(size_t)r].gi = 0;
        load_head(r);
    }

    // full-key compare for heads whose prefix12 ties (keys > 12 bytes)
    auto head_less = [&](int32_t a, int32_t b) {
        const Head& ha = heads[(size_t)a];
        const Head& hb = heads[(size_t)b];
        if (ha.part != hb.part) return ha.part < hb.part;
        if (ha.pre != hb.pre) return ha.pre < hb.pre;
        if (ha.pre2 != hb.pre2) return ha.pre2 < hb.pre2;
        int64_t rowa = groups[(size_t)a].starts[(size_t)ha.gi];
        int64_t rowb = groups[(size_t)b].starts[(size_t)hb.gi];
        const int64_t* koa = kos[a];
        const int64_t* kob = kos[b];
        int64_t la = koa[rowa + 1] - koa[rowa];
        int64_t lb = kob[rowb + 1] - kob[rowb];
        if (la > 12 && lb > 12) {
            int64_t m = (la < lb ? la : lb) - 12;
            int c = std::memcmp(kbs[a] + koa[rowa] + 12,
                                kbs[b] + kob[rowb] + 12, (size_t)m);
            if (c) return c < 0;
        }
        if (la != lb) return la < lb;
        return false;   // equal keys: caller keeps lower run index
    };

    // group selection: O(log k) binary min-heap of run indices (linear
    // scan for tiny k, where its constants win).  Equal (partition, key)
    // heads pop in run-index order — the MergeQueue age tie-break.
    auto run_after = [&](int32_t a, int32_t b) {
        // priority_queue order: true when a emits AFTER b
        if (head_less(b, a)) return true;
        if (head_less(a, b)) return false;
        return a > b;
    };
    std::vector<int32_t> heap;
    heap.reserve((size_t)num_runs);
    bool use_heap = num_runs > 4;
    if (use_heap) {
        for (int32_t r = 0; r < num_runs; r++)
            if (heads[(size_t)r].gi <
                (int64_t)groups[(size_t)r].gparts.size())
                heap.push_back(r);
        std::make_heap(heap.begin(), heap.end(), run_after);
    }
    int64_t kpos = 0, vpos = 0, row_out = 0;
    while (true) {
        int32_t best = -1;
        if (use_heap) {
            if (heap.empty()) break;
            std::pop_heap(heap.begin(), heap.end(), run_after);
            best = heap.back();
            heap.pop_back();
        } else {
            for (int32_t r = 0; r < num_runs; r++) {
                if (heads[(size_t)r].gi >=
                    (int64_t)groups[(size_t)r].gparts.size()) continue;
                if (best < 0 || head_less(r, best)) best = r;
            }
            if (best < 0) break;
        }
        auto& g = groups[(size_t)best];
        Head& h = heads[(size_t)best];
        int64_t s = g.starts[(size_t)h.gi];
        int64_t e = g.starts[(size_t)h.gi + 1];
        const int64_t* ko = kos[best];
        const int64_t* vo = vos[best];
        int64_t kbytes = ko[e] - ko[s];
        int64_t vbytes = vo[e] - vo[s];
        std::memcpy(out_kb + kpos, kbs[best] + ko[s], (size_t)kbytes);
        std::memcpy(out_vb + vpos, vbs[best] + vo[s], (size_t)vbytes);
        int64_t kbase = kpos - ko[s];
        int64_t vbase = vpos - vo[s];
        if (out_parts != nullptr)
            std::fill(out_parts + row_out, out_parts + row_out + (e - s),
                      h.part);
        for (int64_t i = s; i < e; i++) {
            out_ko[row_out + 1] = ko[i + 1] + kbase;
            out_vo[row_out + 1] = vo[i + 1] + vbase;
            row_out++;
        }
        part_counts[h.part] += e - s;
        kpos += kbytes;
        vpos += vbytes;
        h.gi++;
        load_head(best);
        if (use_heap &&
            h.gi < (int64_t)groups[(size_t)best].gparts.size()) {
            heap.push_back(best);
            std::push_heap(heap.begin(), heap.end(), run_after);
        }
    }
    return 0;
}

// Permute FIXED-width rows: out[i] = data[perm[i]*row_len : +row_len].
// The ragged gather pays an offset lookup and a length-unknown memcpy per
// row; fixed width makes the copy a compile-time-size move for the common
// serde widths (8/12/16).
void gather_fixed_u8(const uint8_t* data, int64_t row_len,
                     const int64_t* perm, int64_t n, uint8_t* out,
                     int32_t n_threads) {
    if (n <= 0 || row_len <= 0) return;
    int threads = std::max(1, (int)n_threads);
    auto body = [=](int64_t lo, int64_t hi) {
        switch (row_len) {
        case 8:
            for (int64_t i = lo; i < hi; i++)
                std::memcpy(out + i * 8, data + perm[i] * 8, 8);
            break;
        case 12:
            for (int64_t i = lo; i < hi; i++)
                std::memcpy(out + i * 12, data + perm[i] * 12, 12);
            break;
        case 16:
            for (int64_t i = lo; i < hi; i++)
                std::memcpy(out + i * 16, data + perm[i] * 16, 16);
            break;
        default:
            for (int64_t i = lo; i < hi; i++)
                std::memcpy(out + i * row_len, data + perm[i] * row_len,
                            (size_t)row_len);
        }
    };
    if (threads == 1 || n < (1 << 16)) {
        body(0, n);
        return;
    }
    std::vector<std::thread> pool;
    int64_t per = (n + threads - 1) / threads;
    for (int t = 0; t < threads; t++) {
        int64_t lo = t * per, hi = std::min<int64_t>(n, lo + per);
        if (lo >= hi) break;
        pool.emplace_back(body, lo, hi);
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"
