// Batched Ludo locator: the CN-side Get compute, one thread per key.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ludo_lookup.py
// (ludo_lookup_kernel, body _kernel).  For each key (lo, hi):
//   ia = hash64(seed_a) % ma,  ib = hash64(seed_b) % mb
//   choice = bit(words_a, ia) ^ bit(words_b, ib)
//   b0 = hash64(seed_ba) % nb,  b1 = hash64(seed_bb) % nb
//   bucket = choice ? b1 : b0
//   slot = fmix32(lo ^ seed * C1 ^ hi * C2) & 3,  seed = seeds[bucket]
// The plain version is repro_torch/kernels/ref.py::ludo_lookup_ref.
//
// Bound on an H100: bytes, 16 B a key over the HBM rate (3.35 TB/s):
// each key reads 8 B of lanes and writes 8 B of (bucket, slot), about
// 5 us at 2^20 keys.  The three gathers (two Othello words, one uint8
// seed) are not counted: at 2^24 keys the CN arrays are about 9 MB, so
// they stay in the 50 MB L2 and the gathers are L2 hits, not HBM traffic.
// About 150 integer operations a key (five murmur hashes, four modulos)
// are below the card's integer rate.  At the serving window (1024 keys)
// the kernel is bound by launch latency, not by either.
//
// Design: one thread per key, native uint32_t arithmetic (wrapping, as the
// reference's uint32 lanes), the ragged edge masked here so the caller
// never pads.  No shared memory: the gathers are random and L2-resident,
// the rest is a stream.  Seeds are read as uint8_t, the CN's own type.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kC3 = 0x27D4EB2Fu;
constexpr uint32_t kC4 = 0x165667B1u;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash64(uint32_t lo, uint32_t hi,
                                           uint32_t seed) {
  uint32_t h = seed ^ kGolden;
  h = fmix32(h ^ lo) * kC3;
  h = fmix32(h ^ hi) * kC4;
  return fmix32(h);
}

__global__ void ludo_lookup_kernel(const uint32_t* __restrict__ key_lo,
                                   const uint32_t* __restrict__ key_hi,
                                   const uint32_t* __restrict__ words_a,
                                   const uint32_t* __restrict__ words_b,
                                   const uint8_t* __restrict__ seeds,
                                   int32_t* __restrict__ bucket_out,
                                   int32_t* __restrict__ slot_out, int n,
                                   uint32_t ma, uint32_t mb, uint32_t nb,
                                   uint32_t seed_a, uint32_t seed_b,
                                   uint32_t seed_ba, uint32_t seed_bb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t lo = key_lo[i];
  const uint32_t hi = key_hi[i];
  const uint32_t ia = hash64(lo, hi, seed_a) % ma;
  const uint32_t ib = hash64(lo, hi, seed_b) % mb;
  const uint32_t choice =
      ((__ldg(words_a + (ia >> 5)) >> (ia & 31u)) ^
       (__ldg(words_b + (ib >> 5)) >> (ib & 31u))) & 1u;
  const uint32_t b0 = hash64(lo, hi, seed_ba) % nb;
  const uint32_t b1 = hash64(lo, hi, seed_bb) % nb;
  const uint32_t bucket = choice ? b1 : b0;
  const uint32_t seed = __ldg(seeds + bucket);
  const uint32_t slot = fmix32(lo ^ (seed * kC1) ^ (hi * kC2)) & 3u;
  bucket_out[i] = static_cast<int32_t>(bucket);
  slot_out[i] = static_cast<int32_t>(slot);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ludo_lookup_launch(const void* key_lo, const void* key_hi,
                                  const void* words_a, const void* words_b,
                                  const void* seeds, void* bucket_out,
                                  void* slot_out, int n, unsigned int ma,
                                  unsigned int mb, unsigned int nb,
                                  unsigned int seed_a, unsigned int seed_b,
                                  unsigned int seed_ba, unsigned int seed_bb,
                                  void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  ludo_lookup_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key_lo),
      static_cast<const uint32_t*>(key_hi),
      static_cast<const uint32_t*>(words_a),
      static_cast<const uint32_t*>(words_b),
      static_cast<const uint8_t*>(seeds), static_cast<int32_t*>(bucket_out),
      static_cast<int32_t*>(slot_out), n, ma, mb, nb, seed_a, seed_b, seed_ba,
      seed_bb);
  return static_cast<int>(cudaGetLastError());
}
