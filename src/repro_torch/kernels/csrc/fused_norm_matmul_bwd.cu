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
// it outside any kernel); every product and sum that needs the normalized
// rows is here, and n never goes to global memory.
//
// Layouts: x (S, d), gamma (d,), w (d, F), dy (S, F), dN (S, d), dx (S, d),
// dw (d, F), all float or all bf16, row-major and contiguous; sums in
// float32, each output rounded once to the input type.  No atomics: every
// sum is taken in a fixed order, so two calls on the same inputs give the
// same bits (remat recomputes the forward; a restarted run replays bit for
// bit).
//
// Three launches, in this order on the caller's stream:
// (b) fused_norm_matmul_bwd_rows_kernel, a block for each `rows` rows of x
//     (ops.fused_norm_matmul_bwd_plan: about two blocks an SM): for each
//     of its rows, one pass over d sums x^2 and (dN * gamma) * x (a block
//     reduction in warp order), so mean(g * n) = r * sum(g * x) / d; a
//     second pass writes dx and adds dN * n to the block's dgamma partial,
//     kept in shared memory (d floats, each thread owning its columns).
//     It writes r (float32, S) and the partial (float32, a row of d a
//     block) to the workspace.
// (c) fused_norm_matmul_bwd_reduce_kernel: dgamma[k] = the partials of
//     column k summed in block order, a thread a column.
// (a) fused_norm_matmul_bwd_dw_kernel: 128 x 128 tiles of dw (rows of d x
//     columns of F) over the whole of S, which is the K side of the
//     product.  Each step stages kBK rows of S: A = x * r * gamma,
//     recomputed from x, r and the block's gamma as the tile is staged
//     (so n is never written out), and B = dy, both through registers
//     into a double buffer in shared memory (one barrier a step): the next
//     step's loads are issued before a step's products and first used
//     after them.  Two blocks an SM.  bf16:
//     A rounded to bf16 once, mma.sync m16n8k16 with float32 accumulators,
//     both operands read with ldmatrix.trans (they lie K-major in shared
//     memory: [s][k] and [s][f]); 8 warps of 32 x 64.  float32: the CUDA
//     cores, a thread 8 x 8 outputs (TF32 would miss the 1e-4 tolerance).
//
// Bound on an H100: operations at training shapes.  At S = 2048, d = 2048,
// F = 8192 the 2 S d F = 68.7 GFLOP of dw take 69 us at the bf16 tensor-core
// peak against 40 us for the bytes (x, gamma, w, dy read once; dx, dgamma,
// dw written once).  This first kernel is mma.sync from registers without
// cp.async or TMA, a simple design that is right; wgmma and a TMA ring are
// later work.

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

// (b) the row pass: dx, r and a block's dgamma partial
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_norm_matmul_bwd_rows_kernel(const T* __restrict__ x,
                                      const T* __restrict__ gamma,
                                      const T* __restrict__ dn,
                                      T* __restrict__ dx,
                                      float* __restrict__ r_out,
                                      float* __restrict__ part, int S, int d,
                                      int rows, float eps) {
  extern __shared__ float acc[];  // d floats: this block's partial
  __shared__ float red[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * rows, s1 = min(S, s0 + rows);
  for (int k = tid; k < d; k += kThreads) acc[k] = 0.f;
  for (int s = s0; s < s1; ++s) {
    const T* xr = x + static_cast<size_t>(s) * d;
    const T* nr = dn + static_cast<size_t>(s) * d;
    float ss = 0.f, gx = 0.f;
    for (int k = tid; k < d; k += kThreads) {
      const float v = to_f32(xr[k]);
      ss = fmaf(v, v, ss);
      gx = fmaf(to_f32(nr[k]) * to_f32(gamma[k]), v, gx);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
    }
    if (lane == 0) {
      red[0][warp] = ss;
      red[1][warp] = gx;
    }
    __syncthreads();
    float tss = 0.f, tgx = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      tss += red[0][q];
      tgx += red[1][q];
    }
    __syncthreads();  // red is read by all before the next row writes it
    const float rr = rsqrtf(tss / static_cast<float>(d) + eps);
    const float c = rr * tgx / static_cast<float>(d);  // mean(g * n)
    if (tid == 0) r_out[s] = rr;
    T* dxr = dx + static_cast<size_t>(s) * d;
    for (int k = tid; k < d; k += kThreads) {
      const float dnv = to_f32(nr[k]);
      const float n = to_f32(xr[k]) * rr;
      store(dxr + k, rr * (dnv * to_f32(gamma[k]) - n * c));
      acc[k] = fmaf(dnv, n, acc[k]);
    }
  }
  float* dst = part + static_cast<size_t>(blockIdx.x) * d;
  for (int k = tid; k < d; k += kThreads) dst[k] = acc[k];
}

// (c) dgamma: the blocks' partials of each column, summed in block order
template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_norm_matmul_bwd_reduce_kernel(const float* __restrict__ part,
                                        T* __restrict__ dgamma, int d,
                                        int blocks) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= d) return;
  float t = 0.f;
  for (int b = 0; b < blocks; ++b) t += part[static_cast<size_t>(b) * d + k];
  store(dgamma + k, t);
}

// (a) dw = (x * r * gamma)^T @ dy: a block a 128 x 128 tile of dw over the
// whole of S, kBK = 4 * kVec rows of S a step (32 in bf16, 16 in float).
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

template <typename T>
cudaError_t launch_bwd(const T* x, const T* gamma, const T* dy, const T* dn,
                       T* dx, T* dgamma, T* dw, float* ws, int S, int d,
                       int F, float eps, int rows, cudaStream_t st) {
  if (S < 1 || d < 1 || F < 1 || rows < 1 || ws == nullptr ||
      static_cast<size_t>(d) * 4 > kSmemLimit || (d + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  const int blocks = (S + rows - 1) / rows;
  const size_t smem = static_cast<size_t>(d) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_norm_matmul_bwd_rows_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  float* r = ws;
  float* part = ws + ((S + 3) / 4) * 4;
  fused_norm_matmul_bwd_rows_kernel<T><<<blocks, kThreads, smem, st>>>(
      x, gamma, dn, dx, r, part, S, d, rows, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fused_norm_matmul_bwd_reduce_kernel<T>
      <<<(d + kThreads - 1) / kThreads, kThreads, 0, st>>>(part, dgamma, d,
                                                          blocks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int kVec = Vec<T>::kVec;
  const int vec_x =
      d % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_dy =
      F % kVec == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  const dim3 grid((F + kBN - 1) / kBN, (d + kBM - 1) / kBM);
  fused_norm_matmul_bwd_dw_kernel<T><<<grid, kThreads, 0, st>>>(
      x, gamma, dy, r, dw, S, d, F, vec_x, vec_dy);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float, 1 = bf16.  dn = dy @ w^T (S, d) in the input type; ws
// holds S floats of r rounded up to a multiple of 4, then the dgamma
// partials, ceil(S / rows) rows of d floats.  Returns the cudaError_t of
// the launches.
extern "C" int fused_norm_matmul_bwd_launch(const void* x, const void* gamma,
                                            const void* dy, const void* dn,
                                            void* dx, void* dgamma, void* dw,
                                            void* ws, int S, int d, int F,
                                            int dtype, float eps, int rows,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = launch_bwd<float>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(dy), static_cast<const float*>(dn),
        static_cast<float*>(dx), static_cast<float*>(dgamma),
        static_cast<float*>(dw), wsf, S, d, F, eps, rows, st);
  else if (dtype == 1)
    err = launch_bwd<bf16>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(gamma),
        static_cast<const bf16*>(dy), static_cast<const bf16*>(dn),
        static_cast<bf16*>(dx), static_cast<bf16*>(dgamma),
        static_cast<bf16*>(dw), wsf, S, d, F, eps, rows, st);
  return static_cast<int>(err);
}
