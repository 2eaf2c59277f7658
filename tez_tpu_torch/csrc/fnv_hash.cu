// Row-wise FNV-1a hash partition, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel fnv_hash_pallas (tez_tpu/ops/pallas_kernels.py:34,
// body _fnv_kernel :24) and the XLA lane hash it shares its body with,
// _fnv_rows_from_lanes (tez_tpu/ops/device.py:219), plus the partition
// epilogue of _hash_to_partitions (device.py:162).
//
// Computes, for each row i: FNV-1a (offset 2166136261, prime 16777619,
// mod 2^32) over the first min(len[i], W) key bytes, then h % P; rows with
// len[i] < 0 are bucket padding and get partition INT32_MAX so they sort to
// the tail.  Two layouts of the same key bytes:
//   * tez_fnv_hash_bytes: a uint8[N, W] byte matrix (no 4x u32 widening as
//     the Pallas kernel needed);
//   * tez_fnv_hash_lanes: big-endian u32 lanes [N, L] (keycodec packing),
//     byte j = lane[j / 4] >> (24 - 8 * (j % 4)).
//
// Bound on this card: bytes.  Each key byte is read once (N*W or N*4L) plus
// 4 B of length in and 4 B of partition out per row; the work per byte is
// one xor and one 32-bit multiply, far below the integer rate.
//
// tez_fnv_hash_bytes: persistent blocks over an asynchronous ring.  A tile is
// T rows, T chosen by W so that a stage holds about 16-32 KB; its keys
// (T*W bytes) and its lengths (4T bytes) are two contiguous ranges, and one
// thread fills each of kStages shared-memory stages with two 1-D bulk copies
// that complete on the stage's mbarrier, so the next tiles stream in while
// this one is hashed and no row waits on its length before its key bytes
// are asked for.  A few blocks per SM each walk every gridDim-th tile.  The
// hash reads shared memory: each thread takes R rows a kThreads apart and
// mixes them interleaved, so R independent multiply chains overlap; every
// byte up to W is mixed under a select (h = j < len ? (h ^ b) * prime : h),
// so lanes with different lengths never diverge, and a pad row is one
// select at the end.  The ring serves W = 4, 8, 16, 32 and 64, template
// parameters (the widths the callers produce), read as one 4-, 8- or
// 16-byte piece at a time; at W = 32 and 64 each lane starts at another
// piece, so the eight lanes of a quarter-warp hit eight different 16-byte
// bank groups.  The modulo is a multiply-high by a magic the wrapper
// computes once per call (Lemire, Kaser & Kurz, "Faster remainder by direct
// computation", 2019: h mod p = umulhi64(M * h mod 2^64, p), M =
// floor((2^64-1)/p) + 1, exact for every 32-bit h and 1 <= p < 2^32), or a
// mask when the wrapper passes M = 0 for a power-of-two p.  Any other width
// (W read at run time), every row when a base is not 16-byte aligned (bulk
// copies need it), and the rows of a last, short tile are hashed from
// device memory with plain loads by the same kernel: one row a thread, its
// length and its key words asked for together and mixed under the same
// selects.
//
// tez_fnv_hash_lanes: one thread per row, 256 threads a block, the ragged
// edge masked; a row's lanes are read as 32-bit words and the hash lives in
// a register across the byte loop.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr int32_t kPadPartition = 0x7FFFFFFF;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t mix(uint32_t h, uint32_t byte) {
  return (h ^ byte) * kFnvPrime;
}

// ---------------------------------------------------------------------------
// tez_fnv_hash_bytes
// ---------------------------------------------------------------------------
constexpr int kStages = 3;
// The most resident blocks per SM this kernel asks for.
constexpr int kMaxBlocksPerSm = 4;
constexpr int kMaxDevices = 64;

// Rows a tile holds: T * (W + 4) <= 36 KB, and T a multiple of kThreads * R.
template <int kW>
constexpr int kTileRows = kW == 4 ? 4096 : kW == 8 ? 2048 : kW == 16 ? 1024
                          : kW == 32 ? 1024 : 512;
// Rows a thread hashes interleaved.
template <int kW>
constexpr int kChains = kTileRows<kW> / kThreads < 4
                            ? kTileRows<kW> / kThreads : 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D bulk copy global -> shared completing on `bar`; 16-byte aligned ends.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ int32_t partition_of(uint32_t h, int32_t len,
                                                uint32_t p, uint64_t magic) {
  uint32_t q = magic ? static_cast<uint32_t>(__umul64hi(magic * h, p))
                     : (h & (p - 1));
  return len < 0 ? kPadPartition : static_cast<int32_t>(q);
}

// Load row `row` (kW bytes at a 16-byte-aligned shared address when kW >= 16)
// into little-endian words, byte j = bits 8 * (j % 4) of word j / 4.
template <int kW>
__device__ __forceinline__ void load_row(const uint8_t* row,
                                         uint32_t (&w)[kW / 4], int lane) {
  if constexpr (kW == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(row);
  } else if constexpr (kW == 8) {
    uint2 v = *reinterpret_cast<const uint2*>(row);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    constexpr int kPieces = kW / 16;
    // the lanes whose rows share a 128-byte bank window start at different
    // pieces (kW = 16: one row per window position, no rotation)
    const int rot = (lane / (128 / kW)) & (kPieces - 1);
    uint4 raw[kPieces];
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      raw[q] = *reinterpret_cast<const uint4*>(
          row + 16 * ((q + rot) & (kPieces - 1)));
    }
#pragma unroll
    for (int q = 0; q < kPieces; ++q) {
      // piece q sits in raw[(q - rot) mod kPieces]: selects, no indexing
      const int k = (q - rot) & (kPieces - 1);
      uint4 v = raw[0];
#pragma unroll
      for (int c = 1; c < kPieces; ++c) {
        v.x = k == c ? raw[c].x : v.x;
        v.y = k == c ? raw[c].y : v.y;
        v.z = k == c ? raw[c].z : v.z;
        v.w = k == c ? raw[c].w : v.w;
      }
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
}

// Hash one staged tile: rows [0, kTileRows).
template <int kW>
__device__ __forceinline__ void hash_tile(const uint8_t* keys,
                                          const int32_t* lens, int32_t* out,
                                          uint32_t p, uint64_t magic) {
  constexpr int kR = kChains<kW>;
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int r0 = threadIdx.x; r0 < kTileRows<kW>; r0 += kThreads * kR) {
    uint32_t w[kR][kW / 4];
    int32_t len[kR];
    uint32_t h[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int r = r0 + k * kThreads;
      len[k] = lens[r];
      load_row<kW>(keys + r * kW, w[k], lane);
      h[k] = kFnvOffset;
    }
#pragma unroll
    for (int j = 0; j < kW; ++j) {
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const uint32_t nh = mix(h[k], (w[k][j >> 2] >> (8 * (j & 3))) & 0xFFu);
        h[k] = j < len[k] ? nh : h[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      out[r0 + k * kThreads] = partition_of(h[k], len[k], p, magic);
    }
  }
}

// Hash one row from device memory: every byte up to w read and mixed under
// the select, as 32-bit words when the row and w allow it; no load waits on
// the length.
__device__ __forceinline__ uint32_t hash_global(const uint8_t* row, int w,
                                                int32_t len) {
  uint32_t h = kFnvOffset;
  if ((reinterpret_cast<uintptr_t>(row) | static_cast<uintptr_t>(w)) % 4 ==
      0) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(row);
#pragma unroll 4
    for (int k = 0; k < w / 4; ++k) {
      const uint32_t word = __ldg(words + k);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t nh = mix(h, (word >> (8 * b)) & 0xFFu);
        h = 4 * k + b < len ? nh : h;
      }
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < w; ++j) {
      const uint32_t nh = mix(h, __ldg(row + j));
      h = j < len ? nh : h;
    }
  }
  return h;
}

// Tiles [0, full_tiles) go through the ring, rows from full_tiles *
// kTileRows on are read from device memory.  kW = 0: W read at run time,
// no ring.
template <int kW>
__global__ void __launch_bounds__(kThreads)
    fnv_bytes_kernel(const uint8_t* __restrict__ mat,
                     const int32_t* __restrict__ lens, int64_t n, int w,
                     int64_t full_tiles, uint32_t p, uint64_t magic,
                     int32_t* __restrict__ out) {
  constexpr int tile_rows = kTileRows<kW>;
  if constexpr (kW != 0) {
    extern __shared__ __align__(128) uint8_t smem[];
    __shared__ uint64_t full[kStages];
    constexpr uint32_t key_bytes = static_cast<uint32_t>(tile_rows) * kW;
    constexpr uint32_t stage_bytes = key_bytes + 4u * tile_rows;
    const int64_t mine = blockIdx.x < full_tiles
                             ? (full_tiles - blockIdx.x + gridDim.x - 1) /
                                   gridDim.x
                             : 0;
    if (mine > 0) {
      if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) bar_init(&full[s]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      __syncthreads();
      auto fill = [&](int64_t k) {
        const int s = static_cast<int>(k % kStages);
        const int64_t t = blockIdx.x + k * gridDim.x;
        uint8_t* stage = smem + s * stage_bytes;
        bar_expect(&full[s], stage_bytes);
        bulk_load(stage, mat + t * key_bytes, key_bytes, &full[s]);
        bulk_load(stage + key_bytes, lens + t * tile_rows, 4u * tile_rows,
                  &full[s]);
      };
      if (threadIdx.x == 0) {
        for (int64_t k = 0; k < kStages && k < mine; ++k) fill(k);
      }
#pragma unroll 1
      for (int64_t k = 0; k < mine; ++k) {
        const int s = static_cast<int>(k % kStages);
        const int64_t t = blockIdx.x + k * gridDim.x;
        bar_wait(&full[s], static_cast<uint32_t>((k / kStages) & 1));
        const uint8_t* stage = smem + s * stage_bytes;
        hash_tile<kW>(stage,
                      reinterpret_cast<const int32_t*>(stage + key_bytes),
                      out + t * tile_rows, p, magic);
        __syncthreads();  // every thread is done with stage s
        if (threadIdx.x == 0 && k + kStages < mine) {
          // order this block's reads of the stage before the async refill
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          fill(k + kStages);
        }
      }
    }
  }
  // rows outside the full tiles: plain loads, one row per thread, its
  // length and its key bytes asked for together
  const int width = kW ? kW : w;
  for (int64_t i = full_tiles * tile_rows +
                   static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int32_t len = __ldg(lens + i);
    out[i] = partition_of(hash_global(mat + i * width, width, len), len, p,
                          magic);
  }
}

// Per device: SM count, and per templated flavour the resident blocks per
// SM (0 = not asked yet).
std::atomic<int> g_sms[kMaxDevices];
std::atomic<int> g_per_sm[kMaxDevices][5];

template <int kW>
constexpr int kSlot = kW == 4 ? 0 : kW == 8 ? 1 : kW == 16 ? 2
                      : kW == 32 ? 3 : 4;

template <int kW>
int launch_bytes(const uint8_t* mat, const int32_t* lens, int64_t n, int w,
                 uint32_t p, uint64_t magic, int32_t* out, cudaStream_t s) {
  constexpr int rows = kTileRows<kW>;
  constexpr int ring_smem = kStages * rows * (kW + 4);
  const bool ring = kW != 0 && reinterpret_cast<uintptr_t>(mat) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(lens) % 16 == 0;
  const int64_t full_tiles = ring ? n / rows : 0;
  const int smem = full_tiles ? ring_smem : 0;
  // without the ring: one row a thread
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if constexpr (kW != 0) {
    if (full_tiles) {
      int dev = 0;
      cudaError_t e = cudaGetDevice(&dev);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
      int sms = g_sms[dev].load(std::memory_order_relaxed);
      if (sms == 0) {
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return static_cast<int>(e);
        g_sms[dev].store(sms, std::memory_order_relaxed);
      }
      // once per device and flavour; the value never changes, so threads
      // that race here set the same one
      int per_sm = g_per_sm[dev][kSlot<kW>].load(std::memory_order_acquire);
      if (per_sm == 0) {
        if constexpr (ring_smem > 48 * 1024) {
          e = cudaFuncSetAttribute(fnv_bytes_kernel<kW>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   ring_smem);
          if (e != cudaSuccess) return static_cast<int>(e);
        }
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, fnv_bytes_kernel<kW>, kThreads, ring_smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;
        if (per_sm < 1) per_sm = 1;
        g_per_sm[dev][kSlot<kW>].store(per_sm, std::memory_order_release);
      }
      blocks = static_cast<int64_t>(sms) * per_sm;
      if (blocks > full_tiles) blocks = full_tiles;
    }
  }
  fnv_bytes_kernel<kW><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(
      mat, lens, n, w, full_tiles, p, magic, out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// tez_fnv_hash_lanes
// ---------------------------------------------------------------------------
// Big-endian lanes: byte j of the key is bits 24 - 8*(j%4) of lane j/4.
__global__ void fnv_lanes_kernel(const uint32_t* __restrict__ lanes,
                                 const int32_t* __restrict__ lens, int64_t n,
                                 int l, uint32_t p, int32_t* __restrict__ out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t len = lens[i];
  if (len < 0) {
    out[i] = kPadPartition;
    return;
  }
  int m = len < 4 * l ? len : 4 * l;
  uint32_t h = kFnvOffset;
  const uint32_t* row = lanes + i * static_cast<int64_t>(l);
  for (int k = 0; 4 * k < m; ++k) {
    uint32_t word = __ldg(row + k);
    int take = m - 4 * k < 4 ? m - 4 * k : 4;
    for (int b = 0; b < take; ++b) h = mix(h, (word >> (24 - 8 * b)) & 0xFFu);
  }
  out[i] = static_cast<int32_t>(h % p);
}

inline unsigned blocks_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// magic: floor((2^64 - 1) / p) + 1, or 0 when p is a power of two.
extern "C" int tez_fnv_hash_bytes(const void* mat, const void* lens,
                                  long long n, int w, unsigned int p,
                                  unsigned long long magic, void* out,
                                  void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mat);
  const int32_t* l = static_cast<const int32_t*>(lens);
  int32_t* o = static_cast<int32_t*>(out);
  switch (w) {
    case 4: return launch_bytes<4>(m, l, n, w, p, magic, o, s);
    case 8: return launch_bytes<8>(m, l, n, w, p, magic, o, s);
    case 16: return launch_bytes<16>(m, l, n, w, p, magic, o, s);
    case 32: return launch_bytes<32>(m, l, n, w, p, magic, o, s);
    case 64: return launch_bytes<64>(m, l, n, w, p, magic, o, s);
    default: return launch_bytes<0>(m, l, n, w, p, magic, o, s);
  }
}

extern "C" int tez_fnv_hash_lanes(const void* lanes, const void* lens,
                                  long long n, int l, unsigned int p,
                                  void* out, void* stream) {
  if (n <= 0) return 0;
  fnv_lanes_kernel<<<blocks_for(n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lanes), static_cast<const int32_t*>(lens),
      n, l, p, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
