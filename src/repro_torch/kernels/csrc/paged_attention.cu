// Paged flash decode over a KV page pool, for one sequence: the Ludo-paged
// kernel and its two-fetch cuckoo baseline.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/paged_attention.py:
//   paged_attention_launch         <- paged_attention_kernel (_ludo_kernel,
//                                     _flash_step)
//   cuckoo_paged_attention_launch  <- cuckoo_paged_attention_kernel
//                                     (_cuckoo_kernel, _flash_step)
// Layouts, as there: q (n_kv, g, d); k_pool, v_pool (P, ps, n_kv, d) of
// float or bf16; page ids int32.  Outputs are the float32 flash partials
// o (n_kv, g, d), m and l (n_kv, g).  For every step (one page), with
// s = q.k^T / sqrt(d) in float32 and positions >= seq_len set to the finite
// sentinel -1e30:
//   m_new = max(m, max_t s);  alpha = exp(m - m_new);  p = exp(s - m_new)
//   l = l * alpha + sum_t p;  acc = acc * alpha + p.v;  m = m_new
// and at the end o = acc / max(l, 1e-30).  The Ludo kernel walks page_map
// (L steps).  The cuckoo kernel walks page_map2 (L, 2) as 2L steps: step i
// loads page pm2[i / 2][i % 2], both candidates' K and V really stream in,
// and the step scores as masked unless select[i / 2] == i % 2.  The finite
// sentinel matters there: when step 0 is the unselected candidate, m stays
// -1e30, p = exp(0) = 1 and l, acc take the decoy in; the first valid step
// then has alpha = exp(-1e30 - m_new) = 0 and washes it out.  With -inf
// the same step would give exp(-inf + inf) = NaN.  The plain version is
// repro_torch/kernels/ref.py::paged_attention_ref (the cuckoo one on the
// gathered selected pages).
//
// Bound on an H100: bytes.  Every step reads a K and a V tile of
// ps x d values for each KV head, 2 * L * ps * n_kv * d * 2 B in bf16 for
// the Ludo kernel (64.0 MB, 19.1 us at 3.35 TB/s for L = 1954, ps = 16,
// n_kv = 8, d = 64) and twice that for the cuckoo kernel.  The work is
// 4 * n_kv * g * d flops a token, 8 per byte: far below the FMA rate.
//
// Design (simple first): one block per KV head; the block loops over the
// page map, which replaces the TPU's sequential grid axis, and reads the
// page ids from device memory itself, which replaces scalar prefetch.  Each
// step copies the head's K and V tiles (token stride n_kv * d) into shared
// memory as float, computes the g x ps scores (one thread a score, the K
// rows padded by one float against bank conflicts), runs the online softmax
// with one thread a query row, and updates acc (g x d floats in shared
// memory, one thread an element).  Only n_kv of the card's 132 SMs work on
// one sequence, and each step waits for its own page: the kernel is bound
// by one SM's load latency, far above its byte bound.  Splitting the pages
// over blocks (flash-decoding) and pipelining the page loads are later work.
// A page id outside [0, P) is never read: its step scores as masked over
// zero tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory, in floats: q and acc (g x D each), the K tile (ps rows of
// D + 1), the V tile (ps x D), the scores (g x ps) and m, l, alpha (g each).
inline size_t smem_floats(int d, int ps, int g) {
  return static_cast<size_t>(2 * g * d + ps * (d + 1) + ps * d + g * ps +
                             3 * g);
}

template <typename T, int D, bool kCuckoo>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                        const T* __restrict__ v_pool,
                        const int32_t* __restrict__ page_ids,
                        const int32_t* __restrict__ select,
                        float* __restrict__ o, float* __restrict__ m_out,
                        float* __restrict__ l_out, int n_steps, int n_pool,
                        int ps, int n_kv, int g, int seq_len) {
  extern __shared__ float smem[];
  constexpr int KS = D + 1;
  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  float* q_s = smem;
  float* acc = q_s + g * D;
  float* k_s = acc + g * D;
  float* v_s = k_s + ps * KS;
  float* s_s = v_s + ps * D;
  float* m_s = s_s + g * ps;
  float* l_s = m_s + g;
  float* a_s = l_s + g;
  const float root_d = sqrtf(static_cast<float>(D));

  for (int i = tid; i < g * D; i += kThreads) {
    q_s[i] = to_f32(q[static_cast<size_t>(h) * g * D + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  const size_t tok_stride = static_cast<size_t>(n_kv) * D;

  for (int step = 0; step < n_steps; ++step) {
    const int page_pos = kCuckoo ? step >> 1 : step;
    const int page = page_ids[step];
    const bool in_pool = page >= 0 && page < n_pool;
    const bool valid =
        in_pool && (!kCuckoo || select[page_pos] == (step & 1));
    __syncthreads();  // the last step's readers of the tiles are done
    const size_t base =
        (static_cast<size_t>(in_pool ? page : 0) * ps * n_kv + h) * D;
    for (int i = tid; i < ps * D; i += kThreads) {
      const int t = i / D, j = i % D;
      const size_t off = base + t * tok_stride + j;
      k_s[t * KS + j] = in_pool ? to_f32(k_pool[off]) : 0.f;
      v_s[t * D + j] = in_pool ? to_f32(v_pool[off]) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < g * ps; i += kThreads) {
      const int gi = i / ps, t = i % ps;
      const float* qr = q_s + gi * D;
      const float* kr = k_s + t * KS;
      float dot = 0.f;
#pragma unroll 16
      for (int j = 0; j < D; ++j) dot += qr[j] * kr[j];
      const bool live = valid && page_pos * ps + t < seq_len;
      s_s[i] = live ? dot / root_d : kNegInf;
    }
    __syncthreads();
    for (int gi = tid; gi < g; gi += kThreads) {
      float* sr = s_s + gi * ps;
      const float m_prev = m_s[gi];
      float m_new = m_prev;
      for (int t = 0; t < ps; ++t) m_new = fmaxf(m_new, sr[t]);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float p = expf(sr[t] - m_new);
        sr[t] = p;
        sum += p;
      }
      l_s[gi] = l_s[gi] * alpha + sum;
      a_s[gi] = alpha;
      m_s[gi] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < g * D; i += kThreads) {
      const int gi = i / D, j = i % D;
      const float* pr = s_s + gi * ps;
      float pv = 0.f;
      for (int t = 0; t < ps; ++t) pv += pr[t] * v_s[t * D + j];
      acc[i] = acc[i] * a_s[gi] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < g * D; i += kThreads) {
    o[static_cast<size_t>(h) * g * D + i] = acc[i] / fmaxf(l_s[i / D], 1e-30f);
  }
  for (int gi = tid; gi < g; gi += kThreads) {
    m_out[h * g + gi] = m_s[gi];
    l_out[h * g + gi] = l_s[gi];
  }
}

template <typename T, int D, bool kCuckoo>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const void* page_ids, const void* select, void* o,
                 void* m_out, void* l_out, int n_steps, int n_pool, int ps,
                 int n_kv, int g, int seq_len, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, D, kCuckoo>;
  const size_t smem = smem_floats(D, ps, g) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_ids),
      static_cast<const int32_t*>(select), static_cast<float*>(o),
      static_cast<float*>(m_out), static_cast<float*>(l_out), n_steps, n_pool,
      ps, n_kv, g, seq_len);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16; d: 64 or 128.  Any other pair returns
// cudaErrorInvalidValue without launching.
template <bool kCuckoo>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* page_ids, const void* select, void* o, void* m_out,
             void* l_out, int n_steps, int n_pool, int ps, int n_kv, int g,
             int d, int dtype, int seq_len, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_LAUNCH(T, D)                                                  \
  return launch_typed<T, D, kCuckoo>(q, k_pool, v_pool, page_ids, select, o, \
                                     m_out, l_out, n_steps, n_pool, ps, n_kv, \
                                     g, seq_len, s)
  if (dtype == 0 && d == 64) PAGED_LAUNCH(float, 64);
  if (dtype == 0 && d == 128) PAGED_LAUNCH(float, 128);
  if (dtype == 1 && d == 64) PAGED_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) PAGED_LAUNCH(__nv_bfloat16, 128);
#undef PAGED_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Ludo-paged decode: L = n_pages steps over page_map.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_map,
                                      void* o, void* m_out, void* l_out,
                                      int n_pages, int n_pool, int ps,
                                      int n_kv, int g, int d, int dtype,
                                      int seq_len, void* stream) {
  return dispatch<false>(q, k_pool, v_pool, page_map, nullptr, o, m_out,
                         l_out, n_pages, n_pool, ps, n_kv, g, d, dtype,
                         seq_len, stream);
}

// Cuckoo baseline: 2 * n_pages steps over page_map2 (n_pages, 2), select
// (n_pages,).  Launches on `stream` and returns cudaGetLastError().
extern "C" int cuckoo_paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_map2, const void* select, void* o, void* m_out,
    void* l_out, int n_pages, int n_pool, int ps, int n_kv, int g, int d,
    int dtype, int seq_len, void* stream) {
  return dispatch<true>(q, k_pool, v_pool, page_map2, select, o, m_out, l_out,
                        2 * n_pages, n_pool, ps, n_kv, g, d, dtype, seq_len,
                        stream);
}
