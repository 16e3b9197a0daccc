// Backward of the fused RMSNorm -> projection (csrc/fused_norm_matmul.cu):
// given dy = dL/d(out) (S, F), with r[s] = rsqrt(mean_k x[s, k]^2 + eps),
// n = x * r and dN = dy @ w^T (S, d),
//   dx[s, k]  = r[s] * (g[s, k] - n[s, k] * mean_k(g * n)),  g = dN * gamma
//   dgamma[k] = sum_s dN[s, k] * n[s, k]
//   dw[k, f]  = sum_s (x[s, k] * r[s] * gamma[k]) * dy[s, f]
//
// Replaces no Pallas kernel: the TPU kernel of
// src/repro/kernels/fused_norm_matmul.py has no backward, because the
// reference's model computes rms_norm then einsum and lets XLA
// differentiate them.  The port routes every dense layer's norm ->
// projection pair through one forward kernel, so its gradient needs this
// one.  The plain version is repro_torch/kernels/ref.py::
// fused_norm_matmul_bwd_ref.  dN is a plain product of two tensors that
// exist (the wrapper's torch.matmul, as the reference's autodiff computes
// it outside any kernel); every other product and sum is here.
//
// Layouts: x (S, d), gamma (d,), w (d, F), dy (S, F), dN (S, d), dx (S, d),
// dw (d, F), all float or all bf16, row-major and contiguous; sums in
// float32, each output rounded once to the input type.  No atomics: every
// sum is taken in a fixed order, so two calls on the same inputs give the
// same bits (remat recomputes the forward; a restarted run replays bit for
// bit).
//
// ops.fused_norm_matmul_bwd_dw_plan picks a regime, dw's tile and S-splits
// and whether the row pass keeps a row in registers; the launch checks
// them.  In order on the caller's stream:
// (b) fused_norm_matmul_bwd_warp_rows_kernel, every regime: a warp a row
//     of x, blocks of ops.fused_norm_matmul_bwd_plan rows (8 warps, about
//     two blocks an SM).  The warp loads x and dN with 16-byte loads; where
//     a row's d * elt is at most 4 KB (d <= 2048 in bf16, 1024 in float32)
//     its lanes keep them in registers for both passes, else the second
//     pass reads the row again (from L2: the template's kReread).  r and
//     mean(g * n) = r * sum(g * x) / d come from shuffles alone.  It writes
//     dx, r (float32, S) and, in the wgmma regime, A = bf16(x * r * gamma)
//     to an (S, dp) workspace (dp = d rounded up to 64), rounded once.
//     dgamma: each warp adds dN * n of its rows to a partial in shared
//     memory, the block sums them in warp order (a fixed order) and its
//     partial goes to the workspace (past d of about 6400, where 8
//     partials do not fit, the warps add to one partial in turn).
// (c) fused_norm_matmul_bwd_reduce_kernel: dgamma[k] = the partials of
//     column k summed in a fixed order: 8 runs of consecutive blocks, each
//     in block order, then the runs in order.
// (a) dw, by regime:
//     wgmma (bf16, F % 8 == 0, dy on a 16-byte boundary):
//     fused_norm_matmul_bwd_wgmma_kernel, dw = A^T dy with K = S, tiles of
//     dw of 128 rows of d x 256 columns of F (128 where the plan finds too
//     few wide tiles to fill half the SMs) over a split's range of S.  A
//     producer warp keeps a 4-stage ring of 64-deep stages full with TMA
//     (full and empty mbarriers; 128-byte swizzle; zeros past S, d and F
//     from the tensor maps); two consumer warpgroups each run wgmma
//     m64n256k16 (m64n128k16) into float32 accumulators, one stage's
//     products in flight while the next stage is awaited.  Both operands
//     lie MN-major (A^T's M = d and dy's N = F are the contiguous axes),
//     so both transpose immediates are set.  With one split the epilogue
//     rounds once to bf16; with more, each split writes a float32 partial
//     (splits, d, F) and fused_norm_matmul_bwd_dwsum_kernel sums them in
//     split order and rounds once.  A costs 2 S dp bytes out and in again
//     (5 us at S = d = 2048), and buys a dw with no generic-proxy writes
//     into swizzled tiles.
//     mma (bf16 otherwise) and fma (float32):
//     fused_norm_matmul_bwd_dw_kernel recomputes A from x, r and gamma as
//     it stages each 32 (bf16) or 16 (float) rows of S through registers
//     into a double buffer; mma.sync m16n8k16 from ldmatrix.trans in bf16,
//     the CUDA cores in float32 (TF32 would miss the 1e-4 tolerance).
//
// Bound on an H100: operations at training shapes.  At S = 2048, d = 2048,
// F = 8192 the 2 S d F = 68.7 GFLOP of dw take 69 us at the bf16 tensor-core
// peak against 40 us for the bytes (x, gamma, w, dy read once; dx, dgamma,
// dw written once).  At F = 512 the bytes bound it (6.9 us), and dw has 64
// tiles on 132 SMs: the plan splits S so that tiles x splits fill the card.
// What binds the wgmma dw is the feed from L2: every block reads its A and
// dy tiles over all of S, 805 MB a call at F = 8192, and a copy without
// its products takes as long as the kernel (PERF.md, row 6).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 128, kBN = 128;  // a dw tile: rows of d x columns of F
// shared memory of a dw block: two buffers of A and two of B, kBK rows of
// S each; bf16 rows pitched 272 B and float rows 528 B so that ldmatrix
// rows and float4 reads fall in distinct bank groups
constexpr int kPitchH = kBN + 8;        // bf16 a row
constexpr int kPitchF = kBN + 4;        // floats a row
// (a step of 32 bf16 rows, 8704 B; 16 float rows take 8448 B of it)
constexpr int kTileBytes = 32 * kPitchH * 2;
constexpr int kSmemLimit = 232448;
// the row pass: 16-byte chunks of a row a lane keeps in registers
constexpr int kRowChunks = 8;
constexpr int kResidentBytes = 32 * kRowChunks * 16;  // 4 KB of a row
// the wgmma dw: kWgBM x BN tiles (BN = 128 or 256, the plan's), 64 rows
// of S a stage, 4 stages; boxes of 64 columns (128 bytes) x 64 rows
constexpr int kPad = 64;              // A's rows padded to this
constexpr int kWgBK = 64, kWgStages = 4;
constexpr int kWgInFlight = 1;        // stages of wgmma a consumer keeps open
constexpr int kWgConsumers = 2;       // warpgroups of 64 rows of d
constexpr int kWgBM = 64 * kWgConsumers;         // rows of d a block
constexpr int kWgThreads = 128 * kWgConsumers + 32;  // and a producer warp
constexpr int kWgBox = 64 * kWgBK * 2;           // 8 KB
// a stage: A's boxes, then dy's BN / 64
__host__ __device__ constexpr int wg_stage_bytes(int bn) {
  return (kWgConsumers + bn / 64) * kWgBox;
}
constexpr int wg_smem_bytes(int bn) {
  return kWgStages * wg_stage_bytes(bn) + 1024;
}
// polls of an mbarrier before a wait gives up and traps (a fault of the
// ring's protocol then ends the launch with an error, not a hang)
constexpr long long kMaxPolls = 1ll << 24;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of values of T: kVec of them, unpacked to float and packed back
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kVec = 4;
  using Bits = uint32_t;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
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
  __device__ static uint32_t pack2(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);  // a low
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

// Columns [col, col + kVec) of row `row` of a (rows, cols) matrix, as
// loaded: one 16-byte load where the chunk is whole and `vec` (cols a
// multiple of kVec, the matrix on a 16-byte boundary), else element by
// element; zeros outside the matrix.
template <typename T>
__device__ __forceinline__ uint4 load_raw(const T* __restrict__ m, int row,
                                          int rows, int col, int cols,
                                          bool vec) {
  constexpr int kVec = Vec<T>::kVec;
  using Bits = typename Vec<T>::Bits;
  union {
    uint4 u;
    Bits e[kVec];
  } c;
  c.u = make_uint4(0u, 0u, 0u, 0u);
  if (row >= rows) return c.u;
  const T* p = m + static_cast<size_t>(row) * cols + col;
  if (vec && col + kVec <= cols) {
    c.u = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      if (col + e < cols) c.e[e] = reinterpret_cast<const Bits*>(p)[e];
  }
  return c.u;
}

// n values of a row from column col on, rounded to U: one 16-byte store
// where n values of U are 16 whole bytes, `vec` and the chunk is whole,
// else element by element up to cols.
template <typename U, int n>
__device__ __forceinline__ void store_chunk(U* row, int col, int cols,
                                            const float* v, bool vec) {
  if constexpr (n * sizeof(U) == 16) {
    if (vec && col + n <= cols) {
      *reinterpret_cast<uint4*>(row + col) = Vec<U>::pack(v);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < n; ++e)
    if (col + e < cols) store(row + col + e, v[e]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// (b) the row pass: a warp a row, rows s0 + 8 i + warp of the block's
// `rows`.  Lane l takes the row's 16-byte chunks l, l + 32, ... (columns
// kVec * chunk on), kRowChunks of them at a time, all loaded before their
// first use.  Without kReread (d * sizeof(T) <= 4 KB) a lane loads its
// chunks of x and of dN once and keeps them for both passes; with it,
// each pass reads the row again, a segment of 32 kRowChunks chunks at a
// time.  dgamma: without kTurns each warp adds dN * n of its rows to a
// partial of its own in shared memory, and the block's partial sums the
// warps' in warp order at the end (so its rows in row order where a warp
// has one row); kTurns, where 8 partials and gamma do not fit in shared
// memory (d past about 6400), reads gamma from global memory and lets the
// warps add to the block's one partial in turn after each round of 8
// rows, 8 barriers a round.
template <typename T, bool kReread, bool kTurns>
__global__ void __launch_bounds__(kThreads, 2)
    fused_norm_matmul_bwd_warp_rows_kernel(
        const T* __restrict__ x, const T* __restrict__ gamma,
        const T* __restrict__ dn, T* __restrict__ dx,
        __nv_bfloat16* __restrict__ a, float* __restrict__ r_out,
        float* __restrict__ part, int S, int d, int dp, int rows, float eps,
        int vec) {
  constexpr int kVec = Vec<T>::kVec;
  constexpr int kSeg = 32 * kRowChunks;  // chunks a warp loads at a time
  // gamma (wide floats, zeros past d), then each warp's dgamma partial
  // (kWarps x wide); kTurns: the block's partial (wide)
  extern __shared__ __align__(16) float sm[];
  const int nch = (d + kVec - 1) / kVec;  // chunks a row
  const int wide = nch * kVec;            // d rounded up to whole chunks
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* gs = sm;
  float* acc = kTurns ? sm : sm + wide * (1 + warp);
  const int s0 = blockIdx.x * rows, s1 = min(S, s0 + rows);
  if constexpr (kTurns) {
    for (int k = tid; k < wide; k += kThreads) acc[k] = 0.f;
  } else {
    for (int k = tid; k < wide; k += kThreads)
      gs[k] = k < d ? to_f32(gamma[k]) : 0.f;
    for (int k = tid; k < kWarps * wide; k += kThreads) sm[wide + k] = 0.f;
  }
  __syncthreads();

  // gamma of chunk ch as floats
  auto gam = [&](int ch, float* g) {
    if constexpr (kTurns) {
      Vec<T>::unpack(load_raw(gamma, 0, 1, ch * kVec, d, vec), g);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; e += 4)
        *reinterpret_cast<float4*>(g + e) =
            *reinterpret_cast<const float4*>(gs + ch * kVec + e);
    }
  };
  // this lane's chunks of row s from chunk c0 on, zeros past d
  uint4 xr[kRowChunks], nr[kRowChunks];
  auto load = [&](int s, int c0) {
#pragma unroll
    for (int j = 0; j < kRowChunks; ++j) {
      xr[j] = load_raw(x, s, S, (c0 + lane + 32 * j) * kVec, d, vec);
      nr[j] = load_raw(dn, s, S, (c0 + lane + 32 * j) * kVec, d, vec);
    }
  };
  // f(x chunk, dN chunk, ch) over this lane's chunks of row s: from the
  // registers, or loaded again a segment at a time
  auto each = [&](int s, auto f) {
    for (int c0 = 0; c0 < (kReread ? nch : 1); c0 += kSeg) {
      if constexpr (kReread) load(s, c0);
#pragma unroll
      for (int j = 0; j < kRowChunks; ++j)
        if (c0 + lane + 32 * j < nch)
          f(xr[j], nr[j], c0 + lane + 32 * j);
    }
  };
  // acc += dN * n over row s (scale rr)
  auto add_dgamma = [&](int s, float rr) {
    each(s, [&](const uint4& xu, const uint4& nu, int ch) {
      float xv[kVec], nv[kVec];
      Vec<T>::unpack(xu, xv);
      Vec<T>::unpack(nu, nv);
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        float4* p = reinterpret_cast<float4*>(acc + ch * kVec + e);
        float4 v = *p;
        v.x = fmaf(nv[e], xv[e] * rr, v.x);
        v.y = fmaf(nv[e + 1], xv[e + 1] * rr, v.y);
        v.z = fmaf(nv[e + 2], xv[e + 2] * rr, v.z);
        v.w = fmaf(nv[e + 3], xv[e + 3] * rr, v.w);
        *p = v;
      }
    });
  };

  const int rounds = (rows + kWarps - 1) / kWarps;
  for (int round = 0; round < rounds; ++round) {
    const int s = s0 + round * kWarps + warp;
    const bool live = s < s1;
    float rr = 0.f;
    if (live) {
      if constexpr (!kReread) load(s, 0);
      float ss = 0.f, gx = 0.f;
      each(s, [&](const uint4& xu, const uint4& nu, int ch) {
        float xv[kVec], nv[kVec], g[kVec];
        Vec<T>::unpack(xu, xv);
        Vec<T>::unpack(nu, nv);
        gam(ch, g);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ss = fmaf(xv[e], xv[e], ss);
          gx = fmaf(nv[e] * g[e], xv[e], gx);
        }
      });
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
        gx += __shfl_xor_sync(0xffffffffu, gx, o);
      }
      rr = rsqrtf(ss / static_cast<float>(d) + eps);
      const float c = rr * gx / static_cast<float>(d);  // mean(g * n)
      if (lane == 0) r_out[s] = rr;
      T* dxs = dx + static_cast<size_t>(s) * d;
      __nv_bfloat16* as =
          a == nullptr ? nullptr : a + static_cast<size_t>(s) * dp;
      each(s, [&](const uint4& xu, const uint4& nu, int ch) {
        float xv[kVec], nv[kVec], g[kVec], o[kVec];
        Vec<T>::unpack(xu, xv);
        Vec<T>::unpack(nu, nv);
        gam(ch, g);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float n = xv[e] * rr;
          o[e] = rr * (nv[e] * g[e] - n * c);
          xv[e] = n * g[e];  // A, as the dw kernel's put() rounds it
        }
        store_chunk<T, kVec>(dxs, ch * kVec, d, o, vec);
        if (as != nullptr)
          store_chunk<__nv_bfloat16, kVec>(as, ch * kVec, d, xv, vec);
      });
      if constexpr (!kTurns) add_dgamma(s, rr);
    }
    if constexpr (kTurns) {
      for (int q = 0; q < kWarps; ++q) {  // dgamma, in warp order
        if (warp == q && live) add_dgamma(s, rr);
        __syncthreads();
      }
    }
  }
  float* dst = part + static_cast<size_t>(blockIdx.x) * d;
  if constexpr (kTurns) {
    for (int k = tid; k < d; k += kThreads) dst[k] = acc[k];
  } else {
    __syncthreads();
    for (int k = tid; k < d; k += kThreads) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += sm[wide * (1 + w) + k];
      dst[k] = t;
    }
  }
}

// (c) dgamma: the blocks' partials of each column, in a fixed order: a
// block takes 32 columns; its thread (q, c) sums run q of
// kReduceRuns runs of consecutive blocks (in block order), and the runs'
// sums are added in run order (so one batch of loads in flight a thread,
// not the whole column's in turn).
constexpr int kReduceRuns = 8;
template <typename T>
__global__ void __launch_bounds__(32 * kReduceRuns)
    fused_norm_matmul_bwd_reduce_kernel(const float* __restrict__ part,
                                        T* __restrict__ dgamma, int d,
                                        int blocks) {
  __shared__ float runs[kReduceRuns][32];
  const int c = threadIdx.x % 32, q = threadIdx.x / 32;
  const int k = blockIdx.x * 32 + c;
  const int per = (blocks + kReduceRuns - 1) / kReduceRuns;
  const int b1 = min(blocks, (q + 1) * per);
  float t = 0.f;
  if (k < d)
    for (int b = q * per; b < b1; ++b)
      t += part[static_cast<size_t>(b) * d + k];
  runs[q][c] = t;
  __syncthreads();
  if (q == 0 && k < d) {
    float u = runs[0][c];
#pragma unroll
    for (int i = 1; i < kReduceRuns; ++i) u += runs[i][c];
    store(dgamma + k, u);
  }
}

// (a), mma and fma: dw = (x * r * gamma)^T @ dy: a block a 128 x 128
// tile of dw over the whole of S, kBK = 4 * kVec rows of S a step (32 in
// bf16, 16 in float).
// Each thread stages two 16-byte chunks of A and two of B a step: chunk
// id = tid + 256 i is row id / (128 / kVec) of the step, columns
// (id % (128 / kVec)) * kVec of the tile.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    fused_norm_matmul_bwd_dw_kernel(const T* __restrict__ x,
                                    const T* __restrict__ gamma,
                                    const T* __restrict__ dy,
                                    const float* __restrict__ r,
                                    T* __restrict__ dw, int S, int d, int F,
                                    int vec_x, int vec_dy) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kVec = Vec<T>::kVec;
  constexpr int kCpr = kBM / kVec;     // chunks a staged row
  constexpr int kBK = 2 * kThreads / kCpr;  // rows of S a step
  constexpr int kPitchB = kBf16 ? kPitchH * 2 : kPitchF * 4;  // bytes
  __shared__ __align__(16) uint8_t smem[4 * kTileBytes];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int f0 = blockIdx.x * kBN, k0 = blockIdx.y * kBM;
  const int steps = (S + kBK - 1) / kBK;

  // gamma of the tile's rows of d, zeros past d
  __shared__ float gs[kBM];
  for (int k = tid; k < kBM; k += kThreads)
    gs[k] = k0 + k < d ? to_f32(gamma[k0 + k]) : 0.f;
  // this thread's chunks: rows and columns of a step
  int crow[2], ccol[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int id = tid + i * kThreads;
    crow[i] = id / kCpr;
    ccol[i] = (id % kCpr) * kVec;
  }
  // the next step's chunks as loaded, and r of their rows: the loads stay
  // in flight over a step's products and are first used in put()
  uint4 ra[2], rb[2];
  float rs[2];
  auto fetch = [&](int step) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int s = step * kBK + crow[i];
      ra[i] = load_raw(x, s, S, k0 + ccol[i], d, vec_x);
      rb[i] = load_raw(dy, s, S, f0 + ccol[i], F, vec_dy);
      rs[i] = s < S ? __ldg(r + s) : 0.f;
    }
  };
  // A = x * r * gamma, rounded once to T; B = dy as it is
  auto put = [&](int buf) {
    uint8_t* as = smem + buf * kTileBytes;
    uint8_t* bs = smem + (2 + buf) * kTileBytes;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float a[kVec];
      Vec<T>::unpack(ra[i], a);
#pragma unroll
      for (int e = 0; e < kVec; ++e) a[e] = a[e] * rs[i] * gs[ccol[i] + e];
      const int off = crow[i] * kPitchB + ccol[i] * static_cast<int>(sizeof(T));
      *reinterpret_cast<uint4*>(as + off) = Vec<T>::pack(a);
      *reinterpret_cast<uint4*>(bs + off) = rb[i];
    }
  };

  // bf16: warp (wm, wn) = (warp % 4, warp / 4) takes rows 32 wm.. of the
  // tile (two m16 tiles) and columns 64 wn.. (eight n8 tiles).  float: the
  // thread (tx, ty) = (tid % 16, tid / 16) takes rows 4 ty + {0..3, 64..67}
  // and columns 4 tx + {0..3, 64..67}.
  float c[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) c[i] = 0.f;

  __syncthreads();  // gs
  if (steps > 0) {
    fetch(0);
    put(0);
  }
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) fetch(step + 1);  // loads in flight over the math
    const uint8_t* as = smem + buf * kTileBytes;
    const uint8_t* bs = smem + (2 + buf) * kTileBytes;
    if constexpr (kBf16) {
      const int wm = warp % 4, wn = warp / 4, mi = lane / 8, ri = lane % 8;
      const uint32_t a_base = smem_u32(as), b_base = smem_u32(bs);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A^T fragments: matrices (s 0-7, k 0-7), (s 0-7, k 8-15),
        // (s 8-15, k 0-7), (s 8-15, k 8-15) of each 16 x 16 block
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4_trans(a_base + (kk * 16 + (mi / 2) * 8 + ri) * kPitchB +
                            (wm * 32 + i * 16 + (mi % 2) * 8) * 2,
                        a[i]);
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          // B fragments of n8 tiles j and j + 1: matrices (s 0-7, tile j),
          // (s 8-15, tile j), (s 0-7, tile j + 1), (s 8-15, tile j + 1)
          uint32_t b[4];
          ldsm_x4_trans(b_base + (kk * 16 + (mi % 2) * 8 + ri) * kPitchB +
                            (wn * 64 + (j + mi / 2) * 8) * 2,
                        b);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma_16816(&c[(i * 8 + j) * 4], a[i], b[0], b[1]);
            mma_16816(&c[(i * 8 + j + 1) * 4], a[i], b[2], b[3]);
          }
        }
      }
    } else {
      const int tx = tid % 16, ty = tid / 16;
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float* ar = reinterpret_cast<const float*>(as + kk * kPitchB);
        const float* br = reinterpret_cast<const float*>(bs + kk * kPitchB);
        float av[8], bv[8];
        Vec<float>::unpack(*reinterpret_cast<const uint4*>(ar + ty * 4), av);
        Vec<float>::unpack(*reinterpret_cast<const uint4*>(ar + 64 + ty * 4),
                           av + 4);
        Vec<float>::unpack(*reinterpret_cast<const uint4*>(br + tx * 4), bv);
        Vec<float>::unpack(*reinterpret_cast<const uint4*>(br + 64 + tx * 4),
                           bv + 4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            c[i * 8 + j] = fmaf(av[i], bv[j], c[i * 8 + j]);
      }
    }
    if (step + 1 < steps) put(buf ^ 1);
    __syncthreads();
  }

  if constexpr (kBf16) {
    // c[(i * 8 + j) * 4 + e]: row 32 wm + 16 i + lane / 4 (+ 8 for e >= 2),
    // column 64 wn + 8 j + 2 (lane % 4) + (e & 1)
    const int wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = k0 + wm * 32 + i * 16 + lane / 4 + (e >= 2 ? 8 : 0);
          const int f = f0 + wn * 64 + j * 8 + 2 * (lane % 4) + (e & 1);
          if (k < d && f < F)
            store(dw + static_cast<size_t>(k) * F + f, c[(i * 8 + j) * 4 + e]);
        }
  } else {
    const int tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
        const int f = f0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
        if (k < d && f < F)
          store(dw + static_cast<size_t>(k) * F + f, c[i * 8 + j]);
      }
  }
}

// ---- the wgmma dw (pieces copied from csrc/fused_norm_matmul.cu) ----
// A wgmma shared-memory descriptor for tiles in 128-byte swizzled rows
// (layout type 1): start address, leading byte offset (LBO) and stride
// byte offset (SBO), each in 16-byte units.  For an MN-major operand SBO
// is the stride between groups of 8 rows of K and LBO the stride between
// 64-column blocks of M or N (CUTLASS cute/arch/mma_sm90_desc.hpp,
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
  long long polls = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (++polls > kMaxPolls) __trap();
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
template <int kAcc>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 128, float32) += A (64 x 16) * B (16 x 128), bf16 in shared
// memory, both MN-major: the transpose immediates of A and of B are 1.
__device__ __forceinline__ void wgmma_m64n128k16_tt(float* d, uint64_t da,
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
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
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

// The same for B 16 x 256 (D 64 x 256).
__device__ __forceinline__ void wgmma_m64n256k16_tt(float* d, uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x BN) += A (64 x 16) * B (16 x BN), both MN-major
template <int kBN>
__device__ __forceinline__ void wgmma_tt(float* d, uint64_t da, uint64_t db) {
  if constexpr (kBN == 256)
    wgmma_m64n256k16_tt(d, da, db);
  else
    wgmma_m64n128k16_tt(d, da, db);
}

// (a), wgmma: dw = A^T dy over steps t0 .. t1 - 1 of 64 rows of S (split
// blockIdx.z of `per` steps), through 2-D tensor maps of A (S, d; row
// stride dp) and dy (S, F), boxes of 64 columns x 64 rows, 128-byte
// swizzle.  A stage holds A's columns m0 .. m0 + 127 (two boxes, one a
// consumer warpgroup) and dy's columns n0 .. n0 + kBN - 1 (kBN / 64
// boxes, 64 of N apart: the descriptor's LBO) over its 64 rows, 48 KB at
// kBN = 256.  The bytes come from L2, which feeds every block: a block
// reads 2 (128 + kBN) bytes of A and dy a row of S for its 128 x kBN
// outputs (clusters of two blocks along d that multicast dy measured no
// faster on an H100: the feed gained what the products lost).  Warps 0-7
// are two consumer warpgroups of 64 rows of d each; warp 8 is the
// producer, one thread of which keeps the ring full: it waits until both
// warpgroups have released a stage (its empty barrier), then loads it
// (the full barrier counts its bytes).  A consumer keeps kWgInFlight
// stages' groups of wgmma in flight and releases a stage once its group is
// done.  part == nullptr: dw rounded once to bf16; else the split's
// float32 partial at part + z * d * F.
template <int kBN>
__global__ void __launch_bounds__(kWgThreads, 1)
    fused_norm_matmul_bwd_wgmma_kernel(
        const __grid_constant__ CUtensorMap map_a,
        const __grid_constant__ CUtensorMap map_dy,
        __nv_bfloat16* __restrict__ dw, float* __restrict__ part, int d,
        int F, int steps, int per) {
  constexpr int kStageBytes = wg_stage_bytes(kBN), kAcc = kBN / 2;
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  __shared__ __align__(8) uint64_t full[kWgStages];
  __shared__ __align__(8) uint64_t empty[kWgStages];
  const uint32_t raw = smem_u32(wg_smem);
  uint8_t* base = wg_smem + ((1024 - (raw & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int wg = tid / 128, wl = (tid % 128) / 32, lane = tid & 31;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kWgBM, z = blockIdx.z;
  const int t0 = z * per, n = min(steps, t0 + per) - t0;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kWgConsumers) {  // the producer warp
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int st = i % kWgStages;
        if (i >= kWgStages) mbar_wait(&empty[st], ((i / kWgStages) - 1) & 1);
        uint8_t* p = base + st * kStageBytes;
        const int s = (t0 + i) * kWgBK;
        mbar_expect_tx(&full[st], kStageBytes);
#pragma unroll
        for (int b = 0; b < kWgConsumers; ++b)
          tma_load_2d(p + b * kWgBox, &map_a, &full[st], m0 + 64 * b, s);
#pragma unroll
        for (int b = 0; b < kBN / 64; ++b)
          tma_load_2d(p + (kWgConsumers + b) * kWgBox, &map_dy, &full[st],
                      n0 + 64 * b, s);
      }
    }
    return;
  }

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  for (int i = 0; i < n; ++i) {
    const int st = i % kWgStages;
    mbar_wait(&full[st], (i / kWgStages) & 1);
    const uint32_t a_addr = smem_u32(base + st * kStageBytes) + wg * kWgBox;
    const uint32_t b_addr =
        smem_u32(base + st * kStageBytes) + kWgConsumers * kWgBox;
    fence_acc<kAcc>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kWgBK / 16; ++kk) {
      // 16 rows of S are two 8-row groups of 128-byte rows (1024 B
      // each) in both operands; dy's 64-column boxes are kWgBox apart
      const uint64_t da = gmma_desc(a_addr + kk * 2048, kWgBox, 1024);
      const uint64_t db = gmma_desc(b_addr + kk * 2048, kWgBox, 1024);
      wgmma_tt<kBN>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kWgInFlight)
                 : "memory");
    fence_acc<kAcc>(acc);
    // the products of the stage kWgInFlight back are done: release it
    if (i >= kWgInFlight && tid % 128 == 0)
      mbar_arrive(&empty[(i - kWgInFlight) % kWgStages]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc<kAcc>(acc);

  // accumulator (i = 4j + 2h + c): row 16 wl + lane / 4 + 8h, column
  // 8j + 2 (lane % 4) + c of the warpgroup's 64 x kBN tile
  const int row = m0 + wg * 64 + wl * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= F) continue;  // F % 8 == 0: col + 1 < F too
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = row + 8 * h;
      if (k >= d) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (part != nullptr)
        *reinterpret_cast<float2*>(
            part + (static_cast<size_t>(z) * d + k) * F + col) =
            make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(
            dw + static_cast<size_t>(k) * F + col) =
            __floats2bfloat162_rn(v0, v1);
    }
  }
}

// dw = the splits' float32 partials (splits, n) summed in split order and
// rounded once, four values a thread (n % 8 == 0)
__global__ void __launch_bounds__(kThreads)
    fused_norm_matmul_bwd_dwsum_kernel(const float* __restrict__ part,
                                       __nv_bfloat16* __restrict__ dw,
                                       size_t n, int splits) {
  const size_t i =
      (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i >= n) return;
  float4 t = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < splits; ++z) {
    const float4 u = *reinterpret_cast<const float4*>(part + z * n + i);
    t.x += u.x;
    t.y += u.y;
    t.z += u.z;
    t.w += u.w;
  }
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(dw + i);
  o[0] = __floats2bfloat162_rn(t.x, t.y);
  o[1] = __floats2bfloat162_rn(t.z, t.w);
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

// A bf16 2-D tensor map of rows x cols with a row stride of `stride`
// values (a multiple of 8), boxes of 64 columns (128 bytes, swizzled in
// 128-byte rows) by 64 rows; reads outside rows x cols give zeros.
bool bf16_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int stride) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride) * 2};
  const cuuint32_t box[2] = {64, kWgBK};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// (b) then (c): dx, r, dgamma and, where a != nullptr, A
template <typename T>
cudaError_t launch_rows(const T* x, const T* gamma, const T* dn, T* dx,
                        T* dgamma, __nv_bfloat16* a, float* ws, int S, int d,
                        int dp, float eps, int rows, int reread,
                        cudaStream_t st) {
  constexpr int kVec = Vec<T>::kVec;
  const size_t wide = static_cast<size_t>(d + kVec - 1) / kVec * kVec;
  const bool turns = (1 + kWarps) * wide * 4 > kSmemLimit;
  const size_t smem = (turns ? 1 : 1 + kWarps) * wide * 4;
  if ((!reread && static_cast<size_t>(d) * sizeof(T) > kResidentBytes) ||
      smem > kSmemLimit)
    return cudaErrorInvalidValue;
  auto kern = !reread ? fused_norm_matmul_bwd_warp_rows_kernel<T, false, false>
              : turns ? fused_norm_matmul_bwd_warp_rows_kernel<T, true, true>
                      : fused_norm_matmul_bwd_warp_rows_kernel<T, true, false>;
  // once a kernel, to the limit (each launch asks for its own size)
  static bool smem_set[3] = {false, false, false};
  const int which = !reread ? 0 : turns ? 1 : 2;
  if (!smem_set[which]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return err;
    smem_set[which] = true;
  }
  const int blocks = (S + rows - 1) / rows;
  const int vec = d % kVec == 0 && aligned16(x) && aligned16(gamma) &&
                  aligned16(dn) && aligned16(dx);
  float* r = ws;
  float* part = ws + ((S + 3) / 4) * 4;
  kern<<<blocks, kThreads, smem, st>>>(x, gamma, dn, dx, a, r, part, S, d, dp,
                                       rows, eps, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_norm_matmul_bwd_reduce_kernel<T>
      <<<(d + 31) / 32, 32 * kReduceRuns, 0, st>>>(part, dgamma, d, blocks);
  return cudaGetLastError();
}

// Floats of the dw workspace that A (S, dp) bf16 takes (dp a multiple of
// 64: the splits' partials that follow start 128 bytes aligned).
size_t a_floats(int S, int dp) { return static_cast<size_t>(S) * dp / 2; }

// (a), wgmma with tiles of kBN columns: A is in ws_dw (from the row
// pass), then the partials
template <int kBN>
cudaError_t launch_wgmma_dw(const __nv_bfloat16* a, const __nv_bfloat16* dy,
                            __nv_bfloat16* dw, float* ws_dw, int S, int d,
                            int dp, int F, int splits, cudaStream_t st) {
  const int steps = (S + kWgBK - 1) / kWgBK;
  const int per = (steps + splits - 1) / splits;
  if (splits < 1 || splits > 65535 || (splits - 1) * per >= steps)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_dy;
  if (!bf16_map(&map_a, a, S, d, dp) || !bf16_map(&map_dy, dy, S, F, F))
    return cudaErrorInvalidValue;
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_norm_matmul_bwd_wgmma_kernel<kBN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, wg_smem_bytes(kBN));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  float* part = splits > 1 ? ws_dw + a_floats(S, dp) : nullptr;
  const dim3 grid((F + kBN - 1) / kBN, (d + kWgBM - 1) / kWgBM, splits);
  fused_norm_matmul_bwd_wgmma_kernel<kBN>
      <<<grid, kWgThreads, wg_smem_bytes(kBN), st>>>(map_a, map_dy, dw, part,
                                                     d, F, steps, per);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = static_cast<size_t>(d) * F;
  fused_norm_matmul_bwd_dwsum_kernel<<<
      static_cast<unsigned>((n / 4 + kThreads - 1) / kThreads), kThreads, 0,
      st>>>(part, dw, n, splits);
  return cudaGetLastError();
}

// regime: 0 = fma (float), 1 = mma (bf16), 2 = wgmma (bf16)
template <typename T>
cudaError_t launch_bwd(const T* x, const T* gamma, const T* dy, const T* dn,
                       T* dx, T* dgamma, T* dw, float* ws, float* ws_dw,
                       int S, int d, int F, float eps, int rows, int regime,
                       int tile_n, int splits, int reread, cudaStream_t st) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const bool wgmma = regime == 2;
  if (S < 1 || d < 1 || F < 1 || rows < 1 || ws == nullptr ||
      (d + kBM - 1) / kBM > 65535 ||
      (kBf16 ? regime != 1 && regime != 2 : regime != 0) ||
      (wgmma ? tile_n != 128 && tile_n != 256 : tile_n != kBN) ||
      (wgmma && (ws_dw == nullptr || !aligned16(ws_dw) || F % 8 != 0 ||
                 !aligned16(dy))))
    return cudaErrorInvalidValue;
  const int dp = (d + kPad - 1) / kPad * kPad;
  __nv_bfloat16* a =
      wgmma ? reinterpret_cast<__nv_bfloat16*>(ws_dw) : nullptr;
  cudaError_t err = launch_rows<T>(x, gamma, dn, dx, dgamma, a, ws, S, d, dp,
                                   eps, rows, reread, st);
  if (err != cudaSuccess) return err;
  if constexpr (kBf16) {
    if (wgmma && tile_n == 256)
      return launch_wgmma_dw<256>(a, dy, dw, ws_dw, S, d, dp, F, splits, st);
    if (wgmma)
      return launch_wgmma_dw<128>(a, dy, dw, ws_dw, S, d, dp, F, splits, st);
  }
  constexpr int kVec = Vec<T>::kVec;
  const int vec_x = d % kVec == 0 && aligned16(x);
  const int vec_dy = F % kVec == 0 && aligned16(dy);
  const dim3 grid((F + kBN - 1) / kBN, (d + kBM - 1) / kBM);
  fused_norm_matmul_bwd_dw_kernel<T><<<grid, kThreads, 0, st>>>(
      x, gamma, dy, ws, dw, S, d, F, vec_x, vec_dy);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float, 1 = bf16; regime as launch_bwd's, tile_n its tile's
// columns of F (128, or 256 for wgmma); reread: the row pass
// reads each row again for its second pass instead of keeping it in
// registers (required where d * elt > 4096).  dn = dy @ w^T (S, d) in the
// input type; ws holds S floats of r rounded up to a multiple of 4, then
// the dgamma partials, ceil(S / rows) rows of d floats; ws_dw (wgmma only,
// on a 16-byte boundary) holds A (S rows of d rounded up to 64, bf16)
// and, with splits > 1, the splits' float32 partials of dw (splits, d,
// F).  Returns the cudaError_t of the launches.
extern "C" int fused_norm_matmul_bwd_launch(
    const void* x, const void* gamma, const void* dy, const void* dn,
    void* dx, void* dgamma, void* dw, void* ws, void* ws_dw, int S, int d,
    int F, int dtype, float eps, int rows, int regime, int tile_n,
    int splits, int reread, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  float* wsd = static_cast<float*>(ws_dw);
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_bwd<float>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(dy), static_cast<const float*>(dn),
        static_cast<float*>(dx), static_cast<float*>(dgamma),
        static_cast<float*>(dw), wsf, wsd, S, d, F, eps, rows, regime,
        tile_n, splits, reread, st);
  else if (dtype == 1)
    err = launch_bwd<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
        static_cast<const bf16*>(dy), static_cast<const bf16*>(dn),
        static_cast<bf16*>(dx), static_cast<bf16*>(dgamma),
        static_cast<bf16*>(dw), wsf, wsd, S, d, F, eps, rows, regime,
        tile_n, splits, reread, st);
  return static_cast<int>(err);
}
