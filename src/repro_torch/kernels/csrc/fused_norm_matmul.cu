// Fused RMSNorm -> projection: out = (x * rsqrt(mean(x^2) + eps) * gamma) @ w.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/fused_norm_matmul.py:
//   fused_norm_matmul_launch  <- fused_norm_matmul_kernel (_kernel)
// Layouts, as there: x (S, d), gamma (d,), w (d, F), all float or all bf16,
// row-major and contiguous; out (S, F) in the type of x.  The inverse RMS of
// each row over the whole of d and the product accumulate in float32, and
// the output is rounded once to the input type (__float2bfloat16_rn for
// bf16).  The plain version is repro_torch/kernels/ref.py::
// fused_norm_matmul_ref; ref.py::fused_norm_matmul_split_partials with
// combine_fused_norm_matmul_partials, and fused_norm_matmul_rows, model the
// decompositions below.  On the model path it is the entry of every
// layer's q, k and v projections and of its SwiGLU gate and up projections:
// S = 8 lanes, d = 2048, F = 2048, 512, 512, 8192, 8192 for llama3.2-1b.
//
// Every regime factors the norm out of the dot:
//   out[s, f] = inv_rms[s] * sum_k (x[s, k] * gamma[k]) * w[k, f],
//   inv_rms[s] = rsqrt(sum_k x[s, k]^2 / d + eps),
// so a block needs only its own range of d of x and starts streaming w at
// once; the per-row scale is applied to the float32 sum before the one
// rounding.  No atomics anywhere: every sum is taken in a fixed order, so
// two calls on the same inputs give the same bits.
//
// Bound on an H100: bytes at decode.  w is d * F * 2 B in bf16 (32 MiB for
// a 2048 x 8192 gate, 10 us at 3.35 TB/s), and at S = 8 each weight feeds
// 8 multiply-adds, far below the card's ridge.  At a prefill of S = 256,
// d = 2048, F = 8192 the 8.6 GFLOP take 8.7 us at the bf16 tensor-core rate
// against 11.6 us for the 38.8 MB moved: both matter there.
//
// ops.fused_norm_matmul_plan picks a regime and its numbers from (S, d, F,
// the type, the SMs, the alignment of w); the launch function checks them.
//
// 3. mma (S <= 32, bf16, w rows of whole 16-byte chunks): the decode path.
//    fused_norm_matmul_mma_kernel, grid (column tiles of 128 columns x
//    K-splits of 128-512 rows of d, about a block an SM).  The product
//    runs as out^T = w^T (x * gamma)^T on mma.sync m16n8k16: a warp takes
//    16 columns of w as the M side, the rows of x are the N side.  w
//    streams through a 3-stage ring of 16 KB stages (cp.async, 16 bytes a
//    thread, zero-filled past the range and F; 272-byte row pitch, so
//    ldmatrix rows fall in distinct bank groups); ldmatrix.trans turns each
//    16 x 16 block (rows of K, columns of F) into an A fragment of w^T.
//    x * gamma of the block's range sits in shared memory as bf16 rows, the
//    B fragments, with the rows' partial sums of x^2; the ring's first
//    stages are in flight while it is staged.  Rounding x * gamma to bf16
//    costs at most 2^-9 relative a term against the 3e-2 tolerance.  The
//    CUDA-core FMAs of an earlier design (8 a loaded weight, plus the
//    conversions) took as long as the loads and did not overlap them; the
//    tensor cores leave the loads alone on the critical path.
//    With more than one split each block writes float32 partials (and,
//    from the first column tile, its x^2 sums) to a workspace the wrapper
//    allocates, and fused_norm_matmul_combine_kernel (one thread an output)
//    adds them in split order, applies inv_rms and rounds.  A thread block
//    cluster reducing the splits through distributed shared memory in one
//    launch measured slower than the two launches.
// 0. stream (S <= 32 otherwise: float32, or w rows not whole chunks; any S
//    for the latter): the same split-K plan on the CUDA cores.
//    fused_norm_matmul_stream_kernel, grid (128-byte column tiles, K-splits,
//    groups of 8 rows of x): x * gamma in shared memory as float32 [k][s];
//    a warp covers 4 rows of w, 8 lanes a row, a 16-byte load a lane (8 bf16
//    or 4 floats), two passes of 4 loads a thread in flight; each weight is
//    converted once and fed to 8 float32 accumulators a column; a shuffle
//    butterfly and a fixed warp order reduce the block; the same combine.
// 1. fma (S > 32, float32): float32 stays on the CUDA cores (TF32 keeps about
//    three decimal digits and would miss the 1e-4 tolerance).
//    fused_norm_matmul_rows_kernel writes inv_rms and x * gamma as float32
//    rows padded with zeros to a multiple of 64; fused_norm_matmul_fma_kernel
//    runs 64 x 64 output tiles, a thread 4 x 4 of them in registers, fed by
//    a 3-stage cp.async ring of 16-deep A and B tiles.
// 2. wgmma (S > 32, bf16, w rows of whole chunks): the rows pass writes
//    inv_rms and A = x * gamma rounded to bf16 once (padded as above);
//    fused_norm_matmul_wgmma_kernel<BN> is a persistent grid of CTAs (a CTA
//    an SM) that walk 128 x BN output tiles, BN = 256 or 128 as the plan
//    picks: two consumer warpgroups of 64 rows, each BN / 128 wgmma
//    m64n128k16 into float32 accumulators with one stage's products in
//    flight, and a producer warpgroup that keeps a ring of 64-deep stages
//    full with TMA (128-byte swizzle; full and empty mbarriers; zeros past
//    S, d and F from the tensor maps).  Clusters of two CTAs along S share
//    w's column tile by TMA multicast.  A is K-major; B is w itself,
//    MN-major.  The epilogue scales by inv_rms, rounds once and leaves
//    through shared memory by TMA stores, while the producer already loads
//    the next tile.  Each output is summed as with 128-wide tiles, so the
//    bits do not depend on the plan.
//
//    What bounds it at training shapes (S = 2048, d = 2560, F = 9728:
//    102 GFLOP, 0.103 ms at the bf16 tensor-core peak) is the feed from L2
//    to the SMs, not HBM: 128 x 128 tiles, one CTA a tile, pull their A
//    band and w column through L2 for every tile, 1595 MB a call at
//    64 FLOP/B, and a copy without the products takes about as long as the
//    kernel (PERF.md, row 5).  The 128 x 256 tile halves the A bytes a
//    FLOP and the cluster's multicast halves w's: 797 MB a call at F =
//    9728.
// Every ragged edge in S, F and d is masked: staged values outside the
// tensors are zero, and outputs outside are not written.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ---- stream regime ----
constexpr int kRowBytes = 128;        // bytes of a w row a block covers
constexpr int kLanesPerRow = 8;       // 16 bytes a lane
constexpr int kRowsPerWarp = 32 / kLanesPerRow;  // 4
constexpr int kUnroll = 4;            // 16-byte loads a thread a pass
constexpr int kRowsPerPass = kWarps * kRowsPerWarp * kUnroll;  // 128
constexpr int kSB = 8;                // rows of x a block
// rows of d a block of the stream and mma regimes (x * gamma in shared
// memory and, while it is staged, registers)
constexpr int kMaxKRange = 512;

// ---- mma regime ----
constexpr int kMmaStages = 3;
constexpr int kMmaMaxRows = 32;       // rows of x (4 n8 tiles)

// A block of the mma regime covers 128 columns of w (8 warps of 16) with
// 16 KB stages of 64 rows of d, and up to 4 n8 tiles of rows of x.
constexpr int kMmaBN = 128, kMmaBK = 64;
constexpr int kMmaPitch = (kMmaBN + 8) * 2;  // 272 B: ldmatrix rows fall
                                             // in 8 bank groups
constexpr int kMmaStageBytes = kMmaBK * kMmaPitch;
constexpr int kMmaSmemMax = kMmaStages * kMmaStageBytes +
                            kMmaMaxRows * (kMaxKRange + 8) * 2 +
                            kMmaMaxRows * 4;

// ---- prefill regimes ----
constexpr int kPad = 64;              // x * gamma rows padded to this
constexpr int kFmaBM = 64, kFmaBN = 64, kFmaBK = 16, kFmaStages = 3;
// wgmma: CTA tiles of kTcBM rows x 128 or 256 columns, 64-deep stages
constexpr int kTcBM = 128, kTcBK = 64;
constexpr int kTcThreads = 384;       // two consumer warpgroups, a producer
constexpr int kTcConsumerRegs = 232, kTcProducerRegs = 40;  // setmaxnreg
constexpr int kTcBox = 64 * kTcBK * 2;         // 8 KB: a 64 x 64 bf16 box
constexpr int kTcABytes = kTcBM * kTcBK * 2;   // 16 KB of A a stage
constexpr int kTcRingBytes = 196608;  // 4 stages of 48 KB or 6 of 32 KB
constexpr int kTcOutCols = 128;       // a warpgroup's output staged at a
                                      // time: 64 rows x 128 columns
constexpr int kTcOutBytes = kTcOutCols / 64 * kTcBox;
constexpr int kTcSmem = kTcRingBytes + 2 * kTcOutBytes + 1024;
__host__ __device__ constexpr int tc_stage_bytes(int bn) {
  return kTcABytes + bn / 64 * kTcBox;
}
// nanoseconds before an mbarrier wait gives up and traps
constexpr uint64_t kMaxWaitNs = 4000000000ull;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The VEC values of one 16-byte chunk of a w row as float32.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kVec = 4;
  using Bits = uint32_t;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Bits = uint16_t;
  __device__ static void unpack(const uint4& u, float* f) {
    const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(v[i] << 16);
      f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
    }
  }
};

// Row k of w, columns [col, col + VEC): one 16-byte load where the chunk
// is whole and aligned, else element by element; zeros outside w.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* __restrict__ w, int k,
                                            int col, int F, bool valid,
                                            bool vec_ok) {
  constexpr int kVec = Chunk<T>::kVec;
  using Bits = typename Chunk<T>::Bits;
  union {
    uint4 u;
    Bits e[kVec];
  } c;
  c.u = make_uint4(0u, 0u, 0u, 0u);
  if (!valid) return c.u;
  const T* p = w + static_cast<size_t>(k) * F + col;
  if (vec_ok && col + kVec <= F) {
    c.u = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (col + j < F) c.e[j] = reinterpret_cast<const Bits*>(p)[j];
  }
  return c.u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fused_norm_matmul_stream_kernel(const T* __restrict__ x,
                                    const T* __restrict__ gamma,
                                    const T* __restrict__ w,
                                    T* __restrict__ out,
                                    float* __restrict__ part,
                                    float* __restrict__ ss_part, int S, int d,
                                    int F, int krange, int splits, float eps,
                                    int vec_ok) {
  constexpr int kVec = Chunk<T>::kVec;
  constexpr int kTN = kRowBytes / static_cast<int>(sizeof(T));  // columns
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [krange][kSB]
  float* red = xs + krange * kSB;                // [kWarps][kSB][kTN]
  float* ssw = red + kWarps * kSB * kTN;         // [kWarps][kSB]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.y;
  const int f0 = blockIdx.x * kTN;
  const int k0 = split * krange;
  const int kn = min(krange, d - k0);
  const int s0 = blockIdx.z * kSB;
  const int sn = min(kSB, S - s0);

  // w streams by passes of 128 rows: lane (r, c) takes row
  // kb + u * 32 + warp * 4 + r, chunk c.  Two passes are in flight: the
  // first pass's loads go out before x is staged, and each next pass's
  // before the current pass's FMAs.
  const int r = lane / kLanesPerRow;
  const int c = lane % kLanesPerRow;
  const int col = f0 + c * kVec;
  const bool col_in = col < F;
  uint4 cur[kUnroll], nxt[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int kk = u * 32 + warp * kRowsPerWarp + r;
    cur[u] = load_chunk<T>(w, k0 + kk, col, F, col_in && kk < kn,
                           vec_ok != 0);
  }

  // x * gamma of this block's rows and range of d, and the rows' x^2 sums
  float ss[kSB];
#pragma unroll
  for (int s = 0; s < kSB; ++s) ss[s] = 0.f;
  for (int k = tid; k < kn; k += kThreads) {
    const float gk = to_f32(gamma[k0 + k]);
    float v[kSB];
#pragma unroll
    for (int s = 0; s < kSB; ++s) {
      v[s] = s < sn ? to_f32(x[static_cast<size_t>(s0 + s) * d + k0 + k])
                    : 0.f;
      ss[s] = fmaf(v[s], v[s], ss[s]);
      v[s] *= gk;
    }
    float4* dst = reinterpret_cast<float4*>(xs + k * kSB);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
#pragma unroll
  for (int s = 0; s < kSB; ++s) {
    float t = ss[s];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) ssw[warp * kSB + s] = t;
  }
  __syncthreads();

  float acc[kSB][kVec];
#pragma unroll
  for (int s = 0; s < kSB; ++s)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[s][j] = 0.f;
  for (int kb = 0; kb < kn; kb += kRowsPerPass) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = kb + kRowsPerPass + u * 32 + warp * kRowsPerWarp + r;
      nxt[u] = load_chunk<T>(w, k0 + kk, col, F, col_in && kk < kn,
                             vec_ok != 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int kk = kb + u * 32 + warp * kRowsPerWarp + r;
      if (kk < kn) {
        const float4 xa = reinterpret_cast<const float4*>(xs + kk * kSB)[0];
        const float4 xb = reinterpret_cast<const float4*>(xs + kk * kSB)[1];
        const float xv[kSB] = {xa.x, xa.y, xa.z, xa.w,
                               xb.x, xb.y, xb.z, xb.w};
        float wf[kVec];
        Chunk<T>::unpack(cur[u], wf);
#pragma unroll
        for (int s = 0; s < kSB; ++s)
#pragma unroll
          for (int j = 0; j < kVec; ++j)
            acc[s][j] = fmaf(xv[s], wf[j], acc[s][j]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) cur[u] = nxt[u];
  }

  // the warp's 4 row groups by a butterfly, then the warps in warp order
#pragma unroll
  for (int s = 0; s < kSB; ++s)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float t = acc[s][j];
      t += __shfl_xor_sync(0xffffffffu, t, 8);
      t += __shfl_xor_sync(0xffffffffu, t, 16);
      acc[s][j] = t;
    }
  if (r == 0) {
#pragma unroll
    for (int s = 0; s < kSB; ++s)
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        red[(warp * kSB + s) * kTN + c * kVec + j] = acc[s][j];
  }
  __syncthreads();
  for (int e = tid; e < kSB * kTN; e += kThreads) {
    const int s = e / kTN, n = e % kTN;
    const int f = f0 + n;
    if (s >= sn || f >= F) continue;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) t += red[(q * kSB + s) * kTN + n];
    float sst = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) sst += ssw[q * kSB + s];
    if (splits == 1) {
      store(out + static_cast<size_t>(s0 + s) * F + f,
            t * rsqrtf(sst / static_cast<float>(d) + eps));
    } else {
      part[(static_cast<size_t>(split) * S + s0 + s) * F + f] = t;
      if (blockIdx.x == 0 && n == 0) ss_part[split * S + s0 + s] = sst;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_norm_matmul_combine_kernel(const float* __restrict__ part,
                                     const float* __restrict__ ss_part,
                                     T* __restrict__ out, int S, int d, int F,
                                     int splits, float eps) {
  const size_t n = static_cast<size_t>(S) * F;
  const size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int s = static_cast<int>(i / F);
  float t = 0.f, ss = 0.f;
#pragma unroll 8
  for (int q = 0; q < splits; ++q) t += part[q * n + i];
  for (int q = 0; q < splits; ++q) ss += ss_part[q * S + s];
  store(out + i, t * rsqrtf(ss / static_cast<float>(d) + eps));
}

// ---- decode, bf16: mma.sync over a cp.async ring ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, zero-filled when !valid (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c (16 x 8, float32) += a (16 x 16) * b (16 x 8), bf16
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out^T = w^T (x * gamma)^T on the tensor cores: the block's columns of w
// are the M side (16 a warp), the rows of x the N side (n8 tiles), its
// range of d the K side.  w streams through a ring of kMmaStages stages
// (cp.async, 16 bytes a thread, zero-filled past the range and F);
// ldmatrix.trans turns each 16 x 16 block of a stage (rows of K, columns of
// F) into the A fragment of w^T.  x * gamma sits in shared memory as bf16
// rows ([s][k], zeros past the range and S), read as the B fragments.
__global__ void __launch_bounds__(kThreads, 2)
    fused_norm_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ gamma,
                                 const __nv_bfloat16* __restrict__ w,
                                 __nv_bfloat16* __restrict__ out,
                                 float* __restrict__ part,
                                 float* __restrict__ ss_part, int S, int d,
                                 int F, int krange, int splits, float eps) {
  constexpr int kBN = kMmaBN, kBK = kMmaBK, kNS = kMmaMaxRows / 8;
  constexpr int kChunks = kBN / 8;  // 16-byte chunks of a stage row
  extern __shared__ __align__(16) uint8_t mma_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.y, f0 = blockIdx.x * kBN;
  const int k0 = split * krange, kn = min(krange, d - k0);
  const int steps = (kn + kBK - 1) / kBK;
  const int kp = steps * kBK;      // staged columns of x * gamma
  const int ns = (S + 7) / 8;      // n8 tiles of rows of x
  const int xpitch = (krange + kBK - 1) / kBK * kBK + 8;  // bf16 a row
  uint8_t* ring = mma_smem;
  __nv_bfloat16* xs =
      reinterpret_cast<__nv_bfloat16*>(ring + kMmaStages * kMmaStageBytes);
  float* ssr = reinterpret_cast<float*>(xs + ns * 8 * xpitch);

  auto issue = [&](int step) {
    uint8_t* stage = ring + (step % kMmaStages) * kMmaStageBytes;
#pragma unroll
    for (int i = 0; i < kBK * kChunks / kThreads; ++i) {
      const int id = tid + i * kThreads;
      const int row = id / kChunks, cc = id % kChunks;
      const int kk = step * kBK + row, f = f0 + cc * 8;
      const bool ok = kk < kn && f < F;
      const __nv_bfloat16* src =
          ok ? w + static_cast<size_t>(k0 + kk) * F + f : w;
      cp_async16(stage + row * kMmaPitch + cc * 16, src, ok);
    }
  };
  // the ring's first stages go out before x is staged
#pragma unroll
  for (int p = 0; p < kMmaStages - 1; ++p) {
    if (p < steps) issue(p);
    cp_async_commit();
  }

  // x * gamma rounded to bf16 and the sums of x^2: warp q takes rows q,
  // q + 8, ...; a lane's values of a row are loaded all at once
  for (int s = warp; s < ns * 8; s += kWarps) {
    float v[kMaxKRange / 32], g[kMaxKRange / 32];
#pragma unroll
    for (int i = 0; i < kMaxKRange / 32; ++i) {
      const int k = lane + 32 * i;
      const bool ok = s < S && k < kn;
      v[i] = ok ? __bfloat162float(x[static_cast<size_t>(s) * d + k0 + k])
                : 0.f;
      g[i] = ok ? __bfloat162float(gamma[k0 + k]) : 0.f;
    }
    float ss = 0.f;
    __nv_bfloat16* row = xs + s * xpitch;
#pragma unroll
    for (int i = 0; i < kMaxKRange / 32; ++i) {
      const int k = lane + 32 * i;
      ss = fmaf(v[i], v[i], ss);
      if (k < kp) row[k] = __float2bfloat16_rn(v[i] * g[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) ssr[s] = ss;
  }

  float c[kNS][4];
#pragma unroll
  for (int j = 0; j < kNS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  const int mi = lane / 8, ri = lane % 8;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();  // stage `step` landed; the stage refilled below is
                      // done with, and x * gamma is staged
    if (step + kMmaStages - 1 < steps) issue(step + kMmaStages - 1);
    cp_async_commit();
    const uint32_t st = smem_u32(ring + (step % kMmaStages) * kMmaStageBytes);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      // matrices (k 0-7, f 0-7), (k 0-7, f 8-15), (k 8-15, f 0-7),
      // (k 8-15, f 8-15) of the warp's 16 x 16 block: a0..a3 of w^T
      uint32_t a[4];
      ldsm_x4_trans(st + (kk * 16 + (mi / 2) * 8 + ri) * kMmaPitch +
                        (warp * 16 + (mi % 2) * 8) * 2,
                    a);
      const int kb = step * kBK + kk * 16 + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < kNS; ++j) {
        if (j < ns) {
          const __nv_bfloat16* xr = xs + (j * 8 + lane / 4) * xpitch + kb;
          mma_16816(c[j], a, *reinterpret_cast<const uint32_t*>(xr),
                    *reinterpret_cast<const uint32_t*>(xr + 8));
        }
      }
    }
  }

  // c[j]: (f + 8h, s) for h = 0, 1 and s = 8j + 2 (lane % 4) + e
  const int f = f0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kNS; ++j) {
    if (j >= ns) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int srow = 8 * j + 2 * (lane % 4) + e, ff = f + 8 * h;
        if (srow >= S || ff >= F) continue;
        const float val = c[j][2 * h + e];
        if (splits == 1)
          out[static_cast<size_t>(srow) * F + ff] = __float2bfloat16_rn(
              val * rsqrtf(ssr[srow] / static_cast<float>(d) + eps));
        else
          part[(static_cast<size_t>(split) * S + srow) * F + ff] = val;
      }
  }
  if (splits > 1 && blockIdx.x == 0 && tid < S)
    ss_part[split * S + tid] = ssr[tid];
}

// ---- prefill: the rows pass ----
// One block a row: inv_rms[s] and x * gamma in TA (float for the FMA tile,
// bf16 for the tensor cores), the row padded with zeros to dp columns.
template <typename T, typename TA>
__global__ void __launch_bounds__(kThreads)
    fused_norm_matmul_rows_kernel(const T* __restrict__ x,
                                  const T* __restrict__ gamma,
                                  TA* __restrict__ xg,
                                  float* __restrict__ inv_rms, int d, int dp,
                                  float eps) {
  __shared__ float ssw[kWarps];
  const int s = blockIdx.x;
  const T* row = x + static_cast<size_t>(s) * d;
  TA* dst = xg + static_cast<size_t>(s) * dp;
  float ss = 0.f;
  for (int k = threadIdx.x; k < dp; k += kThreads) {
    float v = 0.f, g = 0.f;
    if (k < d) {
      v = to_f32(row[k]);
      g = to_f32(gamma[k]);
    }
    ss = fmaf(v, v, ss);
    store(dst + k, v * g);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if ((threadIdx.x & 31) == 0) ssw[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) t += ssw[q];
    inv_rms[s] = rsqrtf(t / static_cast<float>(d) + eps);
  }
}

// ---- prefill, float32: the FMA tile ----
// A = x * gamma (S, dp) float32, B = w (d, F) float32 with F % 4 == 0.
__global__ void __launch_bounds__(kThreads)
    fused_norm_matmul_fma_kernel(const float* __restrict__ xg,
                                 const float* __restrict__ inv_rms,
                                 const float* __restrict__ w,
                                 float* __restrict__ out, int S, int d,
                                 int dp, int F) {
  __shared__ __align__(16) float As[kFmaStages][kFmaBM][kFmaBK];
  __shared__ __align__(16) float Bs[kFmaStages][kFmaBK][kFmaBN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kFmaBM, n0 = blockIdx.x * kFmaBN;
  const int tx = tid % 16, ty = tid / 16;
  // this thread's copies: A row tid / 4, chunk tid % 4; B row tid / 16,
  // chunk tid % 16
  const int ar = tid / 4, ac = (tid % 4) * 4;
  const int br = tid / 16, bc = (tid % 16) * 4;
  const bool a_ok = m0 + ar < S;
  const bool b_col = n0 + bc < F;
  const float* a_src = xg + static_cast<size_t>(a_ok ? m0 + ar : 0) * dp + ac;
  const int steps = dp / kFmaBK;

  auto issue = [&](int step) {
    const int st = step % kFmaStages, k0 = step * kFmaBK;
    cp_async16(&As[st][ar][ac], a_src + k0, a_ok);
    const bool b_ok = b_col && k0 + br < d;
    const float* b_src =
        w + (b_ok ? static_cast<size_t>(k0 + br) * F + n0 + bc : 0);
    cp_async16(&Bs[st][br][bc], b_src, b_ok);
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int p = 0; p < kFmaStages - 1; ++p) {
    if (p < steps) issue(p);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kFmaStages - 2>();
    __syncthreads();
    // refill the stage read one step ago: every thread has passed it
    if (step + kFmaStages - 1 < steps) issue(step + kFmaStages - 1);
    cp_async_commit();
    const int st = step % kFmaStages;
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[st][ty * 4 + i][kk];
      const float4 b = *reinterpret_cast<const float4*>(&Bs[st][kk][tx * 4]);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = m0 + ty * 4 + i;
    if (s >= S) continue;
    const float sc = inv_rms[s];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = n0 + tx * 4 + j;
      if (f < F) out[static_cast<size_t>(s) * F + f] = acc[i][j] * sc;
    }
  }
}

// ---- prefill, bf16: tensor cores ----
// A wgmma shared-memory descriptor for tiles in 128-byte swizzled rows
// (layout type 1): start address, leading byte offset (LBO) and stride
// byte offset (SBO), each in 16-byte units.  For a K-major operand SBO is
// the stride between 8-row groups and LBO is unused; for an MN-major one
// SBO is the stride between groups of 8 rows of K and LBO the stride
// between 64-column blocks of M or N (CUTLASS cute/arch/mma_sm90_desc.hpp,
// make_gmma_desc).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// An arrival on the barrier at bar's offset in the shared memory of the
// cluster's CTA `cta` (this CTA's own, or its partner's).
__device__ __forceinline__ void mbar_arrive_cta(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(cta)
      : "memory");
}
__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Waits for the phase of `parity` to complete; traps (a fault, not a hang)
// after kMaxWaitNs, which no wait of a working kernel comes near.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  uint32_t polls = 0;
  uint64_t t0 = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && (++polls & 1023) == 0) {
      const uint64_t now = globaltimer_ns();
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > kMaxWaitNs)
        __trap();
    }
  } while (!done);
}
// One box of a 2-D tensor map (coordinates innermost first) into shared
// memory; its bytes complete a transaction on bar.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
// The same box into dst of every CTA of the cluster in `mask`, each copy
// completing its bytes on the barrier at bar's offset in that CTA.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      uint64_t* bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1)
      : "memory");
}
// One box of shared memory out to a 2-D tensor map (parts outside the
// tensor are not written), in this thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every CTA of the cluster arrives, then waits.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The 128 threads of warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving uses of the accumulators across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
template <int kAcc>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, float32) += A (64 x 16, K-major) * B (16 x 128, MN-major),
// both bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x BN) += A (64 x 16, K-major) * B (16 x BN, MN-major), as BN / 128
// m64n128k16 products, the second on B's boxes 2 and 3 (16 KB on: 1024 in
// the descriptor's 16-byte units): each output sums the same products in
// the same order as a 128-wide tile, so the bits do not depend on the tile
template <int kBN>
__device__ __forceinline__ void wgmma_k16(float* d, uint64_t da, uint64_t db) {
#pragma unroll
  for (int h = 0; h < kBN / 128; ++h)
    wgmma_m64n128k16(d + 64 * h, da, db + h * (2 * kTcBox >> 4));
}

// A = bf16(x * gamma) (S, dp), B = w (d, F) bf16 with F % 8 == 0, out
// (S, F) bf16, through 2-D tensor maps with 128-byte swizzle.  A
// persistent grid: each CTA walks output tiles of kTcBM rows x kBN
// columns, the tiles t = cluster id + i * clusters of groups x column
// tiles, S first (t % groups is the group of `cm` row tiles, t / groups
// the column tile), so the clusters that run at once share few columns of
// w and each column tile comes from HBM about once.  A cluster of cm = 2
// CTAs takes the two row tiles of a group (the partner's may lie past S:
// zeros in, nothing out) and shares w's column tile: each CTA loads half
// of its boxes and multicasts them into both CTAs' stages.
//
// A stage holds one A box of 64 columns of K x 128 rows (K-major, 16 KB)
// and kBN / 64 B boxes of 64 columns of F x 64 rows of K (MN-major, 8 KB
// each).  Warps 0-7 are two consumer warpgroups of 64 rows each
// (kTcConsumerRegs registers a thread for kBN / 2 accumulators); warps
// 8-11 the producer warpgroup (kTcProducerRegs), one thread of which keeps
// the ring full: it waits until every consumer warpgroup of the cluster
// has released a stage (its empty barrier counts 2 cm arrivals, the
// partner's through the cluster), then loads it (the full barrier counts
// the stage's bytes, its own and the partner's).  A consumer keeps one
// stage's products in flight (wgmma.wait_group 1) and releases a stage
// when its products are done; after a tile's last step it scales its
// rows by inv_rms, rounds once to bf16 and stages 64 x 128 at a time
// (128-byte swizzle, as the out map reads it) for TMA stores, while the
// producer already fills the ring with the next tile.  The cluster
// barriers after the barriers' init and before exit keep a CTA from
// signalling a partner that has not started or has left.
template <int kBN>
__global__ void __launch_bounds__(kTcThreads, 1)
    fused_norm_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                                   const __grid_constant__ CUtensorMap map_b,
                                   const __grid_constant__ CUtensorMap map_out,
                                   const float* __restrict__ inv_rms, int S,
                                   int F, int steps, int cm) {
  constexpr int kStageBytes = tc_stage_bytes(kBN);
  constexpr int kStages = kTcRingBytes / kStageBytes;
  constexpr int kAcc = kBN / 2, kBoxes = kBN / 64;
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  const uint32_t raw = smem_u32(tc_smem);
  uint8_t* base = tc_smem + ((1024 - (raw & 1023)) & 1023);
  const int tid = threadIdx.x, wg = tid / 128, wtid = tid % 128;
  const int rank = static_cast<int>(cluster_ctarank());
  const int clusters = gridDim.x / cm, cid = blockIdx.x / cm;
  const int groups = ((S + kTcBM - 1) / kTcBM + cm - 1) / cm;
  const int tiles = groups * ((F + kBN - 1) / kBN);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2 * cm);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  if (wg == 2) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kTcProducerRegs));
    if (wtid == 0) {
      int it = 0;  // the step over all of this CTA's tiles
      for (int t = cid; t < tiles; t += clusters) {
        const int m0 = (t % groups * cm + rank) * kTcBM;
        const int n0 = t / groups * kBN;
        for (int i = 0; i < steps; ++i, ++it) {
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
          uint8_t* a = base + st * kStageBytes;
          uint8_t* b = a + kTcABytes;
          mbar_expect_tx(&full[st], kStageBytes);
          tma_load_2d(a, &map_a, &full[st], i * kTcBK, m0);
          if (cm == 1) {
#pragma unroll
            for (int q = 0; q < kBoxes; ++q)
              tma_load_2d(b + q * kTcBox, &map_b, &full[st], n0 + 64 * q,
                          i * kTcBK);
          } else {
#pragma unroll
            for (int h = 0; h < kBoxes / 2; ++h) {
              const int q = rank * (kBoxes / 2) + h;
              tma_load_2d_multicast(b + q * kTcBox, &map_b, &full[st],
                                    n0 + 64 * q, i * kTcBK, 0x3);
            }
          }
        }
      }
    }
    __syncwarp();
    cluster_sync();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kTcConsumerRegs));
  const int wl = wtid / 32, lane = tid & 31;
  // this thread's rows of the warpgroup's 64 (and r + 8), and its staged
  // output: kOut / 64 boxes of 64 x 64 in 128-byte rows, 16-byte chunk c
  // of row r at chunk c ^ (r % 8)
  constexpr int kOut = kBN < kTcOutCols ? kBN : kTcOutCols;
  const int r = wl * 16 + lane / 4;
  uint8_t* out_s = base + kTcRingBytes + wg * kTcOutBytes;
  float acc[kAcc];
  int it = 0;
  auto release = [&](int step) {  // every consumer of the cluster is done
    if (wtid == 0)                 // with stage step % kStages
      for (int c = 0; c < cm; ++c)
        mbar_arrive_cta(&empty[step % kStages], static_cast<uint32_t>(c));
  };
  for (int t = cid; t < tiles; t += clusters) {
    const int m0 = (t % groups * cm + rank) * kTcBM;
    const int n0 = t / groups * kBN;
    const int row = m0 + wg * 64 + r;  // read while the products run
    const float sc0 = row < S ? inv_rms[row] : 0.f;
    const float sc1 = row + 8 < S ? inv_rms[row + 8] : 0.f;
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    for (int i = 0; i < steps; ++i, ++it) {
      const int st = it % kStages;
      mbar_wait(&full[st], (it / kStages) & 1);
      const uint32_t a_addr =
          smem_u32(base + st * kStageBytes) + wg * 64 * 128;
      const uint32_t b_addr = smem_u32(base + st * kStageBytes + kTcABytes);
      fence_acc<kAcc>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        // A: 16 columns of K are 32 bytes along the 128-byte rows, 8-row
        // groups 1024 B apart; B: 16 rows of K are two 8-row groups
        // (1024 B each), its 64-column boxes kTcBox apart
        const uint64_t da = gmma_desc(a_addr + kk * 32, 16, 1024);
        const uint64_t db = gmma_desc(b_addr + kk * 2048, kTcBox, 1024);
        wgmma_k16<kBN>(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      wgmma_wait<1>();
      fence_acc<kAcc>(acc);
      if (i > 0) release(it - 1);  // the previous stage's products are done
    }
    wgmma_wait<0>();
    fence_acc<kAcc>(acc);
    release(it - 1);

    // accumulator (i = 4j + 2h + c): row r + 8h, column 8j + 2 (lane % 4)
    // + c of the warpgroup's 64 x kBN tile
#pragma unroll
    for (int part = 0; part < kBN / kOut; ++part) {
      if (wtid == 0)  // the last stores have read the staging
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(wg);
#pragma unroll
      for (int j = 0; j < kOut / 8; ++j) {
        const int q = part * (kOut / 8) + j;
        uint8_t* p = out_s + (j / 8) * kTcBox + r * 128 +
                     (((j % 8) ^ (r % 8)) << 4) + 4 * (lane % 4);
        const __nv_bfloat162 v0 =
            __floats2bfloat162_rn(acc[4 * q] * sc0, acc[4 * q + 1] * sc0);
        const __nv_bfloat162 v1 = __floats2bfloat162_rn(
            acc[4 * q + 2] * sc1, acc[4 * q + 3] * sc1);
        *reinterpret_cast<__nv_bfloat162*>(p) = v0;
        *reinterpret_cast<__nv_bfloat162*>(p + 8 * 128) = v1;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(wg);
      if (wtid == 0) {
        const int y = m0 + wg * 64;
#pragma unroll
        for (int b = 0; b < kOut / 64; ++b) {
          const int x = n0 + part * kOut + 64 * b;
          if (x < F && y < S) tma_store_2d(&map_out, out_s + b * kTcBox, x, y);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  if (wtid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  __syncwarp();
  cluster_sync();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 2-D tensor map of rows x cols (row stride cols), boxes of 64
// columns (128 bytes, swizzled in 128-byte rows) by box_rows rows; reads
// outside the tensor give zeros, writes outside it are dropped.
bool bf16_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kBN>
cudaError_t launch_wgmma_tiles(const CUtensorMap& map_a,
                               const CUtensorMap& map_b,
                               const CUtensorMap& map_out,
                               const float* inv_rms, int S, int F,
                               int steps, int cm, int ctas, cudaStream_t st) {
  static bool set = false;
  if (!set) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_norm_matmul_wgmma_kernel<kBN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return err;
    // setmaxnreg moves registers between the warpgroups of the block's
    // allotment: it must hold the consumers' and the producer's
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fused_norm_matmul_wgmma_kernel<kBN>);
    if (err != cudaSuccess) return err;
    if (fa.numRegs * kTcThreads <
        256 * kTcConsumerRegs + 128 * kTcProducerRegs)
      return cudaErrorInvalidConfiguration;
    set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = kTcSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cm;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fused_norm_matmul_wgmma_kernel<kBN>, map_a,
                            map_b, map_out, inv_rms, S, F, steps, cm);
}

// The rows pass writes A = bf16(x * gamma) and inv_rms to ws, then the
// tile kernel runs.
cudaError_t launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* gamma,
                         const __nv_bfloat16* w, __nv_bfloat16* out, void* ws,
                         int S, int d, int F, float eps, int tile_n, int cm,
                         int ctas, cudaStream_t st) {
  const int dp = (d + kPad - 1) / kPad * kPad;
  if (ws == nullptr || F % 8 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (tile_n != 128 && tile_n != 256) || (cm != 1 && cm != 2) ||
      ctas < cm || ctas % cm != 0)
    return cudaErrorInvalidValue;
  __nv_bfloat16* xg = static_cast<__nv_bfloat16*>(ws);
  float* inv_rms = reinterpret_cast<float*>(xg + static_cast<size_t>(S) * dp);
  fused_norm_matmul_rows_kernel<__nv_bfloat16, __nv_bfloat16>
      <<<S, kThreads, 0, st>>>(x, gamma, xg, inv_rms, d, dp, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap map_a, map_b, map_out;
  if (!bf16_map(&map_a, xg, S, dp, kTcBM) || !bf16_map(&map_b, w, d, F, kTcBK) ||
      !bf16_map(&map_out, out, S, F, 64))
    return cudaErrorInvalidValue;
  err = tile_n == 256 ? launch_wgmma_tiles<256>(map_a, map_b, map_out,
                                                inv_rms, S, F, dp / kTcBK, cm,
                                                ctas, st)
                      : launch_wgmma_tiles<128>(map_a, map_b, map_out,
                                                inv_rms, S, F, dp / kTcBK, cm,
                                                ctas, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_stream(const T* x, const T* gamma, const T* w, T* out,
                          float* ws, int S, int d, int F, float eps,
                          int splits, int krange, cudaStream_t st) {
  constexpr int kTN = kRowBytes / static_cast<int>(sizeof(T));
  if (krange < 1 || krange > kMaxKRange || splits < 1 ||
      static_cast<long long>(splits) * krange < d ||
      static_cast<long long>(splits - 1) * krange >= d ||
      (splits > 1 && ws == nullptr) || (S + kSB - 1) / kSB > 65535 ||
      splits > 65535)
    return cudaErrorInvalidValue;
  const int vec_ok =
      F % Chunk<T>::kVec == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((F + kTN - 1) / kTN, splits, (S + kSB - 1) / kSB);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(krange) * kSB +
                       kWarps * kSB * kTN + kWarps * kSB);
  float* part = ws;
  float* ss_part =
      ws == nullptr ? nullptr : ws + static_cast<size_t>(splits) * S * F;
  fused_norm_matmul_stream_kernel<T><<<grid, kThreads, smem, st>>>(
      x, gamma, w, out, part, ss_part, S, d, F, krange, splits, eps, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(S) * F;
  fused_norm_matmul_combine_kernel<T>
      <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
         st>>>(part, ss_part, out, S, d, F, splits, eps);
  return cudaGetLastError();
}

cudaError_t launch_mma(const __nv_bfloat16* x, const __nv_bfloat16* gamma,
                       const __nv_bfloat16* w, __nv_bfloat16* out, float* ws,
                       int S, int d, int F, float eps, int splits,
                       int krange, cudaStream_t st) {
  if (S < 1 || S > kMmaMaxRows || F % 8 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || krange < 1 ||
      krange > kMaxKRange || splits < 1 || splits > 65535 ||
      static_cast<long long>(splits) * krange < d ||
      static_cast<long long>(splits - 1) * krange >= d ||
      (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_norm_matmul_mma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMmaSmemMax);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int kp = (krange + kMmaBK - 1) / kMmaBK * kMmaBK;
  const size_t smem = kMmaStages * kMmaStageBytes +
                      static_cast<size_t>((S + 7) / 8 * 8) * (kp + 8) * 2 +
                      kMmaMaxRows * 4;
  float* part = ws;
  float* ss_part =
      ws == nullptr ? nullptr : ws + static_cast<size_t>(splits) * S * F;
  const dim3 grid((F + kMmaBN - 1) / kMmaBN, splits);
  fused_norm_matmul_mma_kernel<<<grid, kThreads, smem, st>>>(
      x, gamma, w, out, part, ss_part, S, d, F, krange, splits, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(S) * F;
  fused_norm_matmul_combine_kernel<__nv_bfloat16>
      <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
         st>>>(part, ss_part, out, S, d, F, splits, eps);
  return cudaGetLastError();
}

cudaError_t launch_fma(const float* x, const float* gamma, const float* w,
                       float* out, float* ws, int S, int d, int F, float eps,
                       cudaStream_t st) {
  const int dp = (d + kPad - 1) / kPad * kPad;
  if (ws == nullptr || F % 4 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (S + kFmaBM - 1) / kFmaBM > 65535)
    return cudaErrorInvalidValue;
  float* xg = ws;
  float* inv_rms = ws + static_cast<size_t>(S) * dp;
  fused_norm_matmul_rows_kernel<float, float>
      <<<S, kThreads, 0, st>>>(x, gamma, xg, inv_rms, d, dp, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((F + kFmaBN - 1) / kFmaBN, (S + kFmaBM - 1) / kFmaBM);
  fused_norm_matmul_fma_kernel<<<grid, kThreads, 0, st>>>(xg, inv_rms, w,
                                                          out, S, d, dp, F);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float, 1 = bf16.  regime: 0 = stream (splits K-splits of
// krange rows; ws holds splits * S * F + splits * S floats when splits > 1),
// 1 = FMA tile (float only), 2 = wgmma (bf16 only: tiles of 128 x tile_n
// columns, 128 or 256, clusters of cm = 1 or 2 row tiles, a persistent grid
// of ctas CTAs), 3 = mma (bf16 only, S <= 32; splits and ws as for 0);
// for 1 and 2 ws holds x * gamma (S rows of d rounded up to 64, in the
// input type) and then S floats of inv_rms.  tile_n, cm and ctas are read
// by 2 alone.  Returns the cudaError_t of the launches.
extern "C" int fused_norm_matmul_launch(const void* x, const void* gamma,
                                        const void* w, void* out, void* ws,
                                        int S, int d, int F, int dtype,
                                        float eps, int regime, int splits,
                                        int krange, int tile_n, int cm,
                                        int ctas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (regime == 0 && dtype == 0)
    err = launch_stream<float>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(w), static_cast<float*>(out), wsf, S, d, F,
        eps, splits, krange, st);
  else if (regime == 0 && dtype == 1)
    err = launch_stream<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
        static_cast<const bf16*>(w), static_cast<bf16*>(out), wsf, S, d, F,
        eps, splits, krange, st);
  else if (regime == 1 && dtype == 0)
    err = launch_fma(static_cast<const float*>(x),
                     static_cast<const float*>(gamma),
                     static_cast<const float*>(w), static_cast<float*>(out),
                     wsf, S, d, F, eps, st);
  else if (regime == 3 && dtype == 1)
    err = launch_mma(static_cast<const bf16*>(x),
                     static_cast<const bf16*>(gamma),
                     static_cast<const bf16*>(w), static_cast<bf16*>(out),
                     wsf, S, d, F, eps, splits, krange, st);
  else if (regime == 2 && dtype == 1)
    err = launch_wgmma(static_cast<const bf16*>(x),
                       static_cast<const bf16*>(gamma),
                       static_cast<const bf16*>(w), static_cast<bf16*>(out),
                       ws, S, d, F, eps, tile_n, cm, ctas, st);
  return static_cast<int>(err);
}
