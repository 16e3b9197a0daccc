// Fused RMSNorm -> projection: out = (x * rsqrt(mean(x^2) + eps) * gamma) @ w.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/fused_norm_matmul.py:
//   fused_norm_matmul_launch  <- fused_norm_matmul_kernel (_kernel)
// Layouts, as there: x (S, d), gamma (d,), w (d, F), all float or all bf16,
// row-major and contiguous; out (S, F) in the type of x.  The norm and the
// product accumulate in float32, and the normalized activation never goes
// to device memory: only the output is rounded to the input type (with
// __float2bfloat16_rn for bf16).  The plain version is
// repro_torch/kernels/ref.py::fused_norm_matmul_ref.  On the model path it
// is the entry of every layer's q, k and v projections and of its SwiGLU
// gate and up projections.
//
// Bound on an H100: bytes, since every weight is read once for 2 * S
// flops: w is d * F * 2 B in bf16 (8 MiB for the 2048 x 2048 q projection
// of llama3.2-1b, 2.5 us at 3.35 TB/s).  At decode (S = 8 lanes) the flops
// are 3 orders of magnitude below that; even at a prefill of S = 256 rows,
// d = 2048, F = 8192, the 8.6 GFLOP take 8.7 us at the bf16 tensor-core
// rate against 11.5 us for the 38.8 MB moved.  On the CUDA cores (67
// TFLOP/s in float32) the same prefill takes at least 128 us.
//
// Design (simple first; no tensor cores yet): a grid of
// (ceil(F / 64), ceil(S / BS)) blocks of 256 threads, BS = 8 rows when
// S <= 8 and 32 otherwise.  Blocks run in any order, so each recomputes the
// float32 inverse RMS of its BS rows over the whole of d first (one warp a
// row, a shuffle reduction), as the Pallas kernel recomputes the norm for
// every F-block.  The block then walks d in chunks of 64: it stages the
// normalized chunk x * inv_rms * gamma (BS x 64 floats) and the w chunk
// (64 x 64 floats, loaded coalesced along F) in shared memory, 18-24 KB in
// all, so any d needs no opt-in.  Each thread keeps BS / 4 outputs of one
// column in float32 registers and accumulates them with FMAs on the CUDA
// cores.  Every ragged edge in S, F and d is masked: staged values outside
// the tensors are zero and outputs outside are not written.  At decode the
// kernel is far from its byte bound: a block waits for each 8 KB chunk of w
// before it computes, and F = 512 gives only 8 blocks on 132 SMs.
// wgmma/TMA, split-K for small S, and pipelined loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBF = 64;  // output columns of a block
constexpr int kBK = 64;  // depth of one staged chunk of d
constexpr int kRowGroups = kThreads / kBF;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T, int BS>
__global__ void __launch_bounds__(kThreads)
    fused_norm_matmul_kernel(const T* __restrict__ x,
                             const T* __restrict__ gamma,
                             const T* __restrict__ w, T* __restrict__ out,
                             int S, int d, int F, float eps) {
  constexpr int kRows = BS / kRowGroups;  // outputs of a thread
  __shared__ float inv_rms[BS];
  __shared__ float xs[BS][kBK];
  __shared__ float ws[kBK][kBF];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int f0 = blockIdx.x * kBF;
  const int s0 = blockIdx.y * BS;

  // Rows first: the float32 inverse RMS of each row over the whole of d.
  for (int r = warp; r < BS; r += kThreads / 32) {
    float ss = 0.f;
    if (s0 + r < S) {
      const T* row = x + static_cast<size_t>(s0 + r) * d;
      for (int k = lane; k < d; k += 32) {
        const float v = to_f32(row[k]);
        ss = fmaf(v, v, ss);
      }
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) inv_rms[r] = rsqrtf(ss / static_cast<float>(d) + eps);
  }
  __syncthreads();

  // Then the product, one chunk of d at a time.  A warp holds 32
  // consecutive columns of one row group, so it reads ws without bank
  // conflicts and xs as a broadcast.
  const int col = tid % kBF;
  const int rg = tid / kBF;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < d; k0 += kBK) {
    for (int e = tid; e < BS * kBK; e += kThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int s = s0 + r, k = k0 + kk;
      float v = 0.f;
      if (s < S && k < d)
        v = to_f32(x[static_cast<size_t>(s) * d + k]) * inv_rms[r] *
            to_f32(gamma[k]);
      xs[r][kk] = v;
    }
    for (int e = tid; e < kBK * kBF; e += kThreads) {
      const int kk = e / kBF, ff = e % kBF;
      const int k = k0 + kk, f = f0 + ff;
      ws[kk][ff] =
          (k < d && f < F) ? to_f32(w[static_cast<size_t>(k) * F + f]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float wv = ws[kk][col];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[i] = fmaf(xs[rg + i * kRowGroups][kk], wv, acc[i]);
    }
    __syncthreads();
  }
  const int f = f0 + col;
  if (f >= F) return;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s = s0 + rg + i * kRowGroups;
    if (s < S) store(out + static_cast<size_t>(s) * F + f, acc[i]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* w, void* out,
                   int S, int d, int F, float eps, cudaStream_t stream) {
  const dim3 block(kThreads);
  const int fb = (F + kBF - 1) / kBF;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (S <= 8) {
    fused_norm_matmul_kernel<T, 8>
        <<<dim3(fb, (S + 7) / 8), block, 0, stream>>>(xp, gp, wp, op, S, d,
                                                       F, eps);
  } else {
    fused_norm_matmul_kernel<T, 32>
        <<<dim3(fb, (S + 31) / 32), block, 0, stream>>>(xp, gp, wp, op, S, d,
                                                        F, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float, 1 = bf16.  Returns the cudaError_t of the launch.
extern "C" int fused_norm_matmul_launch(const void* x, const void* gamma,
                                        const void* w, void* out, int S,
                                        int d, int F, int dtype, float eps,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch<float>(x, gamma, w, out, S, d, F, eps, st));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, gamma, w, out, S, d, F, eps, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
