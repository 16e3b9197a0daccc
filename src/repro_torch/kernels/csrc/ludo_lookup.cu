// Batched Ludo locator: the CN-side Get compute, one key a thread.
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
// What binds it on an H100 (tools/ludo_probe.py; PERF.md section 6):
// - in bulk (2^20 keys), its random reads of the CN arrays: two Othello
//   words and a uint8 seed a key.  The arrays stay in the 50 MB L2
//   (chip_smoke.py phase 2 prints their size), and every read is one L2
//   request for a 32-byte sector, at the L2's rate for such requests.  A
//   copy without the reads takes under half the time, a copy without the
//   hashes as long, and a fourth read a key costs 15% more.  The byte
//   bound (16 B a key to and from HBM) and the ALU pipe's bound (the
//   integer operations a key needs, chip_smoke.py LUDO_OPS) are several
//   times lower.
// - at the serving window (1024 keys) and below, the launch and one key's
//   dependent chain: the key load, the hashes, the rounds of L2 reads.
//
// Design:
// - a % d without a divide: m = floor((2^64 - 1) / d) + 1 (mod 2^64) is
//   computed once on the host (ops.ludo_magic), and a % d = mulhi64(m * a,
//   d), four multiplies on the FMA pipe (Lemire, Kaser and Kurz, "Faster
//   remainder by direct computation", 2019).  Exact for every 32-bit a and
//   d >= 1; at d = 1, m wraps to 0 and gives 0.  A runtime `%` is a float
//   reciprocal on the conversion pipe and a fix-up.
// - a plan by batch size (ops.ludo_lookup_plan): one key a thread, on a
//   grid that covers the batch, in blocks of the least power of two from
//   32 to 256 threads that holds an SM's share, so a small batch spreads
//   over many SMs in short blocks.
// - three reads a key in two rounds: the two Othello words, then the
//   selected bucket's seed.  Reading both candidates' seeds with the
//   words (one round of four reads) measured 0.006-0.02 us faster up to
//   2000 keys, under 0.1% of a wrapper call, and 15% slower in bulk.
// - Four keys a thread with 16-byte accesses, streaming and L2 evict-last
//   policies, and reads that bypass L1 measured no faster and are not
//   used.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kC3 = 0x27D4EB2Fu;
constexpr uint32_t kC4 = 0x165667B1u;
constexpr uint32_t kGolden = 0x9E3779B9u;

// The CN half of a launch: its arrays, sizes, the sizes' magics and the
// four seeds.
struct Cn {
  const uint32_t* words_a;
  const uint32_t* words_b;
  const uint8_t* seeds;
  uint64_t magic_a, magic_b, magic_nb;
  uint32_t ma, mb, nb;
  uint32_t seed_a, seed_b, seed_ba, seed_bb;
};

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

// a % d, given m = floor((2^64 - 1) / d) + 1 (mod 2^64): the high 64 bits
// of the 96-bit product (m * a mod 2^64) * d, from 32-bit halves.
__device__ __forceinline__ uint32_t mod_magic(uint32_t a, uint64_t m,
                                              uint32_t d) {
  const uint64_t low = m * a;
  const uint64_t t = static_cast<uint64_t>(static_cast<uint32_t>(low >> 32)) *
                         d +
                     __umulhi(static_cast<uint32_t>(low), d);
  return static_cast<uint32_t>(t >> 32);
}

// One key: its four hashes and modulos, the two Othello words, the select,
// then the selected bucket's seed and the slot hash.
__device__ __forceinline__ void locate(const Cn& cn, uint32_t lo, uint32_t hi,
                                       int32_t* bucket_out,
                                       int32_t* slot_out) {
  const uint32_t ia = mod_magic(hash64(lo, hi, cn.seed_a), cn.magic_a, cn.ma);
  const uint32_t ib = mod_magic(hash64(lo, hi, cn.seed_b), cn.magic_b, cn.mb);
  const uint32_t b0 =
      mod_magic(hash64(lo, hi, cn.seed_ba), cn.magic_nb, cn.nb);
  const uint32_t b1 =
      mod_magic(hash64(lo, hi, cn.seed_bb), cn.magic_nb, cn.nb);
  const uint32_t choice = ((__ldg(cn.words_a + (ia >> 5)) >> (ia & 31u)) ^
                           (__ldg(cn.words_b + (ib >> 5)) >> (ib & 31u))) &
                          1u;
  const uint32_t bucket = choice ? b1 : b0;
  const uint32_t seed = __ldg(cn.seeds + bucket);
  *bucket_out = static_cast<int32_t>(bucket);
  *slot_out = static_cast<int32_t>(fmix32(lo ^ (seed * kC1) ^ (hi * kC2)) &
                                   3u);
}

// One key a thread; the grid covers the batch.
__global__ void ludo_lookup_kernel(const uint32_t* __restrict__ key_lo,
                                   const uint32_t* __restrict__ key_hi,
                                   int32_t* __restrict__ bucket_out,
                                   int32_t* __restrict__ slot_out, int n,
                                   Cn cn) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) locate(cn, key_lo[i], key_hi[i], bucket_out + i, slot_out + i);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a grid that does not cover the batch.
// `magic_*` are the sizes' magics (ops.ludo_magic); `threads` and `blocks`
// are the plan of ops.ludo_lookup_plan.
extern "C" int ludo_lookup_launch(
    const void* key_lo, const void* key_hi, const void* words_a,
    const void* words_b, const void* seeds, void* bucket_out, void* slot_out,
    int n, unsigned long long magic_a, unsigned long long magic_b,
    unsigned long long magic_nb, unsigned int ma, unsigned int mb,
    unsigned int nb, unsigned int seed_a, unsigned int seed_b,
    unsigned int seed_ba, unsigned int seed_bb, int threads, int blocks,
    void* stream) {
  if (n <= 0) return 0;
  if (threads < 1 || threads > 1024 || blocks < 1 ||
      static_cast<long long>(threads) * blocks < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const Cn cn{static_cast<const uint32_t*>(words_a),
              static_cast<const uint32_t*>(words_b),
              static_cast<const uint8_t*>(seeds),
              magic_a, magic_b, magic_nb, ma, mb, nb,
              seed_a, seed_b, seed_ba, seed_bb};
  ludo_lookup_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key_lo),
      static_cast<const uint32_t*>(key_hi), static_cast<int32_t*>(bucket_out),
      static_cast<int32_t*>(slot_out), n, cn);
  return static_cast<int>(cudaGetLastError());
}
