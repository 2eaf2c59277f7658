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
// Design: one thread per row, 256 threads a block, the ragged edge masked.
// A row's bytes are fetched in the widest aligned loads its width allows
// (16-byte uint4 when W % 16 == 0, 32-bit words when W % 4 == 0, lanes
// always), so a warp's loads cover 32 neighbouring rows in a few wide
// transactions; the hash lives in a register across the byte loop.
// Nothing is shared between threads, so no shared memory.
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

// Mix the first `take` bytes of a little-endian word (byte j = bits 8j).
__device__ __forceinline__ uint32_t mix_le(uint32_t h, uint32_t word,
                                           int take) {
  for (int b = 0; b < take; ++b) h = mix(h, (word >> (8 * b)) & 0xFFu);
  return h;
}

// kVec = bytes per load: 16 (uint4, rows 16-byte aligned), 4 (aligned
// 32-bit words) or 1 (any W).
template <int kVec>
__global__ void fnv_bytes_kernel(const uint8_t* __restrict__ mat,
                                 const int32_t* __restrict__ lens, int64_t n,
                                 int w, uint32_t p, int32_t* __restrict__ out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t len = lens[i];
  if (len < 0) {
    out[i] = kPadPartition;
    return;
  }
  int m = len < w ? len : w;
  uint32_t h = kFnvOffset;
  const uint8_t* row = mat + i * static_cast<int64_t>(w);
  if constexpr (kVec == 16) {
    const uint4* row16 = reinterpret_cast<const uint4*>(row);
    for (int c = 0; 16 * c < m; ++c) {
      uint4 v = __ldg(row16 + c);
      int left = m - 16 * c;
      h = mix_le(h, v.x, left < 4 ? left : 4);
      h = mix_le(h, v.y, left < 8 ? (left > 4 ? left - 4 : 0) : 4);
      h = mix_le(h, v.z, left < 12 ? (left > 8 ? left - 8 : 0) : 4);
      h = mix_le(h, v.w, left < 16 ? (left > 12 ? left - 12 : 0) : 4);
    }
  } else if constexpr (kVec == 4) {
    const uint32_t* row4 = reinterpret_cast<const uint32_t*>(row);
    for (int k = 0; 4 * k < m; ++k) {
      int left = m - 4 * k;
      h = mix_le(h, __ldg(row4 + k), left < 4 ? left : 4);
    }
  } else {
    for (int j = 0; j < m; ++j) h = mix(h, __ldg(row + j));
  }
  out[i] = static_cast<int32_t>(h % p);
}

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

extern "C" int tez_fnv_hash_bytes(const void* mat, const void* lens,
                                  long long n, int w, unsigned int p,
                                  void* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mat);
  uintptr_t base = reinterpret_cast<uintptr_t>(m);
  const int32_t* l = static_cast<const int32_t*>(lens);
  int32_t* o = static_cast<int32_t*>(out);
  if (w % 16 == 0 && base % 16 == 0) {
    fnv_bytes_kernel<16><<<blocks_for(n), kThreads, 0, s>>>(m, l, n, w, p, o);
  } else if (w % 4 == 0 && base % 4 == 0) {
    fnv_bytes_kernel<4><<<blocks_for(n), kThreads, 0, s>>>(m, l, n, w, p, o);
  } else {
    fnv_bytes_kernel<1><<<blocks_for(n), kThreads, 0, s>>>(m, l, n, w, p, o);
  }
  return static_cast<int>(cudaGetLastError());
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
