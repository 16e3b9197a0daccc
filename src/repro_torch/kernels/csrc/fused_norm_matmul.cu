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
//    fused_norm_matmul_wgmma_kernel runs 128 x 128 output tiles: two consumer
//    warpgroups of 64 rows, each a wgmma m64n128k16 into float32
//    accumulators, and a producer warp that keeps a 4-stage ring of 64-deep
//    tiles full with TMA (128-byte swizzle; full and empty mbarriers; zeros
//    past S, d and F from the tensor maps).  A is K-major; B is w itself,
//    MN-major.  The epilogue scales by inv_rms and rounds once.
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
constexpr int kTcBM = 128, kTcBN = 128, kTcBK = 64, kTcStages = 4;
constexpr int kTcThreads = 288;       // two consumer warpgroups, a producer
constexpr int kTcStageBytes = (kTcBM + kTcBN) * kTcBK * 2;  // 32 KB
constexpr int kTcSmem = kTcStages * kTcStageBytes + 1024;

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
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
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

// Keeps the compiler from moving uses of the accumulators across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// A = bf16(x * gamma) (S, dp), B = w (d, F) bf16 with F % 8 == 0, through
// 2-D tensor maps with 128-byte swizzle: a stage holds one A box of
// 64 columns of K x 128 rows (K-major, 128-byte rows) and two B boxes of
// 64 columns of F x 64 rows of K (MN-major), 32 KB.  Warps 0-7 are two
// consumer warpgroups of 64 rows each; warp 8 is the producer, one thread
// of which keeps the ring full: it waits until both warpgroups have
// released a stage (the stage's empty barrier), then loads it (the full
// barrier counts its bytes).
__global__ void __launch_bounds__(kTcThreads, 1)
    fused_norm_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                                   const __grid_constant__ CUtensorMap map_b,
                                   const float* __restrict__ inv_rms,
                                   __nv_bfloat16* __restrict__ out, int S,
                                   int F, int steps) {
  extern __shared__ __align__(1024) uint8_t tc_smem[];
  __shared__ __align__(8) uint64_t full[kTcStages];
  __shared__ __align__(8) uint64_t empty[kTcStages];
  const uint32_t raw = smem_u32(tc_smem);
  uint8_t* base = tc_smem + ((1024 - (raw & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int wg = tid / 128, wl = (tid % 128) / 32, lane = tid & 31;
  const int m0 = blockIdx.y * kTcBM, n0 = blockIdx.x * kTcBN;
  constexpr int kABytes = kTcBM * kTcBK * 2;
  constexpr int kBBoxBytes = 64 * kTcBK * 2;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kTcStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {  // the producer warp
    if (lane == 0) {
      for (int step = 0; step < steps; ++step) {
        const int st = step % kTcStages;
        if (step >= kTcStages)
          mbar_wait(&empty[st], ((step / kTcStages) - 1) & 1);
        uint8_t* a = base + st * kTcStageBytes;
        uint8_t* b = a + kABytes;
        mbar_expect_tx(&full[st], kTcStageBytes);
        tma_load_2d(a, &map_a, &full[st], step * kTcBK, m0);
        tma_load_2d(b, &map_b, &full[st], n0, step * kTcBK);
        tma_load_2d(b + kBBoxBytes, &map_b, &full[st], n0 + 64,
                    step * kTcBK);
      }
    }
    return;
  }

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  for (int step = 0; step < steps; ++step) {
    const int st = step % kTcStages;
    mbar_wait(&full[st], (step / kTcStages) & 1);
    const uint32_t a_addr =
        smem_u32(base + st * kTcStageBytes) + wg * 64 * 128;
    const uint32_t b_addr = smem_u32(base + st * kTcStageBytes + kABytes);
    fence_acc(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      // A: 16 columns of K are 32 bytes along the 128-byte rows, 8-row
      // groups 1024 B apart; B: 16 rows of K are two 8-row groups
      // (1024 B each), its two 64-column boxes kBBoxBytes apart
      const uint64_t da = gmma_desc(a_addr + kk * 32, 16, 1024);
      const uint64_t db = gmma_desc(b_addr + kk * 2048, kBBoxBytes, 1024);
      wgmma_m64n128k16(d, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(d);
    if (tid % 128 == 0) mbar_arrive(&empty[st]);  // stage st is free
  }

  // accumulator (i = 4j + 2h + c): row 16 wl + lane / 4 + 8h, column
  // 8j + 2 (lane % 4) + c of the warpgroup's 64 x 128 tile
  const int row = m0 + wg * 64 + wl * 16 + lane / 4;
  const float sc0 = row < S ? inv_rms[row] : 0.f;
  const float sc1 = row + 8 < S ? inv_rms[row + 8] : 0.f;
#pragma unroll
  for (int j = 0; j < kTcBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= F) continue;
    if (row < S)
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row) * F +
                                         col) =
          __floats2bfloat162_rn(d[4 * j] * sc0, d[4 * j + 1] * sc0);
    if (row + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(row + 8) * F + col) =
          __floats2bfloat162_rn(d[4 * j + 2] * sc1, d[4 * j + 3] * sc1);
  }
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
// outside the tensor give zeros.
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

cudaError_t launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* gamma,
                         const __nv_bfloat16* w, __nv_bfloat16* out, void* ws,
                         int S, int d, int F, float eps, cudaStream_t st) {
  const int dp = (d + kPad - 1) / kPad * kPad;
  if (ws == nullptr || F % 8 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (S + kTcBM - 1) / kTcBM > 65535)
    return cudaErrorInvalidValue;
  __nv_bfloat16* xg = static_cast<__nv_bfloat16*>(ws);
  float* inv_rms = reinterpret_cast<float*>(xg + static_cast<size_t>(S) * dp);
  fused_norm_matmul_rows_kernel<__nv_bfloat16, __nv_bfloat16>
      <<<S, kThreads, 0, st>>>(x, gamma, xg, inv_rms, d, dp, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap map_a, map_b;
  if (!bf16_map(&map_a, xg, S, dp, kTcBM) || !bf16_map(&map_b, w, d, F, kTcBK))
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    err = cudaFuncSetAttribute(fused_norm_matmul_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTcSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((F + kTcBN - 1) / kTcBN, (S + kTcBM - 1) / kTcBM);
  fused_norm_matmul_wgmma_kernel<<<grid, kTcThreads, kTcSmem, st>>>(
      map_a, map_b, inv_rms, out, S, F, dp / kTcBK);
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
// 1 = FMA tile (float only), 2 = wgmma (bf16 only), 3 = mma (bf16 only,
// S <= 32; splits and ws as for 0); for 1 and 2 ws
// holds x * gamma (S rows of d rounded up to 64, in the input type) and then
// S floats of inv_rms.  Returns the cudaError_t of the launches.
extern "C" int fused_norm_matmul_launch(const void* x, const void* gamma,
                                        const void* w, void* out, void* ws,
                                        int S, int d, int F, int dtype,
                                        float eps, int regime, int splits,
                                        int krange, void* stream) {
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
                       ws, S, d, F, eps, st);
  return static_cast<int>(err);
}
