// Paged flash decode over a KV page pool, for one sequence: the Ludo-paged
// kernel and its two-fetch cuckoo baseline, as split-KV flash decode
// (flash-decoding): a split pass over KV heads x runs of pages, then a
// combine pass.
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
// The Ludo kernel walks page_map (L steps).  The cuckoo kernel walks
// page_map2 (L, 2) as 2L steps: step i loads page pm2[i / 2][i % 2], both
// candidates' K and V really stream in, and the step scores as masked
// unless select[i / 2] == i % 2.  The finite sentinel matters there: when
// the first step of a run is the unselected candidate, m stays -1e30,
// p = exp(0) = 1 and l, acc take the decoy in; the first valid step then
// has alpha = exp(-1e30 - m_new) = 0 and washes it out.  With -inf the same
// step would give exp(-inf + inf) = NaN.  The plain version is
// repro_torch/kernels/ref.py::paged_attention_ref (the cuckoo one on the
// gathered selected pages); ref.py::paged_split_partials and
// combine_split_partials model this file's decomposition.
//
// Bound on an H100: bytes.  Every step reads a K and a V tile of
// ps x d values for each KV head, 2 * L * ps * n_kv * d * 2 B in bf16 for
// the Ludo kernel (64.0 MB, 19.1 us at 3.35 TB/s for L = 1954, ps = 16,
// n_kv = 8, d = 64) and twice that for the cuckoo kernel.  The work is
// 4 * n_kv * g * d flops a token, 8 per byte: far below the FMA rate.  To
// come near the byte bound some 2-3 MB must be in flight across the card
// (3.35 TB/s x ~700 ns), 16-24 KB an SM: memory-level parallelism, not
// tensor cores.
//
// Design: flash-decoding in two launches.
// 1. Split pass, grid (n_splits, n_kv x query tiles): a block takes one KV
//    head, a tile of kQ = 4 of its query rows (held in registers) and a run
//    of split_pages logical pages, 16 to 64 of them (both cuckoo candidates
//    of a page in one run); ops.paged_split_plan sizes the runs so that
//    about 6 blocks land on each SM, the most the 80 registers a thread
//    allow.  The block reads its run's page ids into shared memory once,
//    then walks the run a loop step (two 16-token pages) at a time, keeping
//    `stages` (2-4) loop steps of K and V rows in flight in a shared-memory
//    ring, copied with cp.async (16 B a thread, zero-filled for a page
//    outside the pool; a head's rows are d values at a token stride of
//    n_kv * d, whole 128-byte lines).  One __syncthreads a loop step: each
//    warp then works alone on its own K rows.  Scores: d / 8 lanes share a
//    K row, each with 8 values of it against the 4 query rows, and a
//    transposing butterfly (4-5 shuffles) leaves every lane with one query
//    row's full dot.  Each warp runs its own online softmax (m, l in the
//    lanes of each query row; maxima and sums by shuffles across its rows)
//    and keeps p.v in registers, a lane d / 32 values of each query row.
//    At the end the block merges its 4 warps in warp order and writes
//    float32 partials (acc, m, l) of its run to a workspace the wrapper
//    allocates (n_kv * g * n_splits * (d + 2) floats), or with a single run
//    (o, m, l) itself.
// 2. Combine pass, one block a query row (n_kv * g blocks): thread groups
//    take the runs in a fixed order with a running maximum, then merge in
//    group order: m = max m_i, l = sum l_i exp(m_i - m),
//    o = sum acc_i exp(m_i - m) / max(l, 1e-30), without atomics, so every
//    run gives the same bits.  A run whose tokens all lie past seq_len ends
//    with m = -1e30 and weighs exp(-1e30 - m) = 0.
// Simpler split passes (three block-wide syncs a page, scores and softmax
// spread over the block) were bound by the work a page, not the bytes:
// with every load removed they took as long (PERF.md).  The design above
// cuts the instructions and block-wide waits a page; with it the loads
// alone (tools/paged_probe.py) take most of the split pass's time.
// A page id outside [0, P) is never read: its rows are zero-filled and its
// step scores as masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the finite sentinel of a masked score
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 4;  // query rows a block: a tile of the group
constexpr int kRowsPerIter = 32;  // K and V rows a loop step aims at
constexpr int kWarpFloats = 32;   // a warp's p and alpha in shared memory
constexpr int kMaxStages = 4;
constexpr int kMaxSplitPages = 64;  // ops.PAGED_MAX_SPLIT_PAGES
constexpr int kCombineThreads = 256;
// the most dynamic shared memory a block may take on Hopper (227 KB)
constexpr size_t kSmemLimit = 232448;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The 16 bytes at p (shared memory) as floats: 4 floats or 8 bf16 values.
__device__ __forceinline__ void chunk_floats(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void chunk_floats(const __nv_bfloat16* p,
                                             float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Two neighbouring values at p (shared memory) as floats.
__device__ __forceinline__ float2 pair_floats(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_floats(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes = 0 fills zeros and
// reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait for the oldest of the `stages` - 1 groups a ring keeps in flight.
__device__ __forceinline__ void wait_oldest(int stages) {
  if (stages >= 4) {
    cp_async_wait<2>();
  } else if (stages == 3) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
}

// Steps (pages) a loop step of the split pass takes: about kRowsPerIter
// rows, at least one page.
__host__ __device__ inline int steps_per_iter(int ps) {
  return ps >= kRowsPerIter ? 1 : kRowsPerIter / ps;
}

// Bytes of the split pass's ring of `stages` slots (a slot: the K rows, then
// the V rows, of one loop step), at least the kWarps x kQ x d floats of the
// final merge of the warps, which reuses it.
__host__ __device__ inline size_t ring_bytes(int stages, int ps, int d,
                                              int elt) {
  const size_t ring = static_cast<size_t>(stages) * 2 * steps_per_iter(ps) *
                      ps * d * elt;
  const size_t red = sizeof(float) * kWarps * kQ * d;
  return ring > red ? ring : red;
}

// Shared memory of the split pass, in bytes: the ring, a warp's p and alpha
// (kWarpFloats floats each warp), the run's page ids and selects, and a
// flag a step in the ring.  ops.py::paged_smem_bytes is the same formula.
inline size_t split_smem_bytes(int stages, int ps, int d, int elt) {
  return ring_bytes(stages, ps, d, elt) +
         sizeof(float) * kWarps * kWarpFloats +
         sizeof(int) * (3 * kMaxSplitPages + stages * steps_per_iter(ps));
}

// A K row's dots with the kQ query rows, summed over the kLpr lanes that
// share the row, transposed on the way: lane bits 2 and 1 pick the query
// row whose full dot the lane ends with, gi = 2 * bit2 + bit1.
static_assert(kQ == 4, "row_dot transposes 4 query rows");
template <int kLpr>
__device__ __forceinline__ float row_dot(const float (&dot)[kQ], int lane) {
  const bool b2 = lane & 4, b1 = lane & 2;
  const float v0 = (b2 ? dot[2] : dot[0]) +
                   __shfl_xor_sync(kFull, b2 ? dot[0] : dot[2], 4);
  const float v1 = (b2 ? dot[3] : dot[1]) +
                   __shfl_xor_sync(kFull, b2 ? dot[1] : dot[3], 4);
  float w = (b1 ? v1 : v0) + __shfl_xor_sync(kFull, b1 ? v0 : v1, 2);
  w += __shfl_xor_sync(kFull, w, 1);
  if (kLpr == 16) w += __shfl_xor_sync(kFull, w, 8);
  return w;
}

template <typename T, int D, bool kCuckoo>
__global__ void __launch_bounds__(kThreads, 6)
    paged_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ page_ids,
                       const int32_t* __restrict__ select,
                       float* __restrict__ o, float* __restrict__ m_out,
                       float* __restrict__ l_out, float* __restrict__ ws,
                       int n_pages, int n_pool, int ps, int n_kv, int g,
                       int seq_len, int split_pages, int n_splits,
                       int stages) {
  constexpr int kPer = 16 / sizeof(T);  // values a 16-byte chunk
  constexpr int kCpr = D / kPer;        // chunks a row
  constexpr int kLpr = D / 8;           // lanes a K row, 8 values each
  constexpr int kRpw = 32 / kLpr;       // rows a warp takes a pass
  constexpr int kRowsPerPass = kWarps * kRpw;
  constexpr int kVpl = D / 32;          // output values a lane, a query
  constexpr int kFetch = kCuckoo ? 2 : 1;  // steps a page
  static_assert(kRpw * kQ + kQ <= kWarpFloats, "a warp's p and alpha");
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x;
  const int n_qt = (g + kQ - 1) / kQ;
  const int h = blockIdx.y / n_qt, g0 = (blockIdx.y % n_qt) * kQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % kLpr, grp = lane / kLpr;  // lane in a row, row
  const int my_q = 2 * ((lane >> 2) & 1) + ((lane >> 1) & 1);  // row_dot
  const int spi = steps_per_iter(ps), rows = spi * ps;
  const size_t slot_vals = static_cast<size_t>(2) * rows * D;
  T* ring = reinterpret_cast<T*>(smem);
  float* pw_all = reinterpret_cast<float*>(
      smem + ring_bytes(stages, ps, D, sizeof(T)));
  float* pw = pw_all + warp * kWarpFloats;  // p (kRpw x kQ), then alpha
  int* ids_s = reinterpret_cast<int*>(pw_all + kWarps * kWarpFloats);
  int* sel_s = ids_s + 2 * kMaxSplitPages;
  int* flag_s = sel_s + kMaxSplitPages;
  const size_t tok_stride = static_cast<size_t>(n_kv) * D;
  const size_t page_stride = tok_stride * ps;
  const float root_d = sqrtf(static_cast<float>(D));
  const int p0 = split * split_pages;
  const int p1 = min(n_pages, p0 + split_pages);
  const int s0 = p0 * kFetch, n_steps = (p1 - p0) * kFetch;
  const int n_iter = (n_steps + spi - 1) / spi;

  // the run's page ids (and selects) once; the block's query rows in
  // registers: lane `sub` of a K row holds values sub * 8 .. sub * 8 + 7
  for (int i = tid; i < n_steps; i += kThreads) ids_s[i] = page_ids[s0 + i];
  if (kCuckoo)
    for (int i = tid; i < p1 - p0; i += kThreads) sel_s[i] = select[p0 + i];
  float qr[kQ][8];
#pragma unroll
  for (int gi = 0; gi < kQ; ++gi) {
    const size_t base = (static_cast<size_t>(h) * g + g0 + gi) * D + sub * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e)
      qr[gi][e] = g0 + gi < g ? to_f32(q[base + e]) : 0.f;
  }
  // the warp's online softmax: lane state for query row my_q
  float m_me = kNegInf, l_me = 0.f;
  float acc[kQ][kVpl];
#pragma unroll
  for (int gi = 0; gi < kQ; ++gi)
#pragma unroll
    for (int v = 0; v < kVpl; ++v) acc[gi][v] = 0.f;
  __syncthreads();

  // Issue the copies of loop step `it`'s pages into ring slot `slot`, and
  // flag each of its steps: 1 scores, 0 masked (outside the pool, or the
  // unselected cuckoo candidate), 2 past the run (adds nothing).
  auto issue = [&](int it, int slot) {
    T* kd = ring + slot * slot_vals;
    T* vd = kd + static_cast<size_t>(rows) * D;
    for (int k = 0; k < spi; ++k) {
      const int si = it * spi + k;
      const int page = si < n_steps ? ids_s[si] : -1;
      const bool in_pool = page >= 0 && page < n_pool;
      const size_t base =
          static_cast<size_t>(in_pool ? page : 0) * page_stride +
          static_cast<size_t>(h) * D;
      for (int c = tid; c < ps * kCpr; c += kThreads) {
        const int t = c / kCpr, j = (c % kCpr) * kPer;
        const size_t off = base + t * tok_stride + j;
        const int dst = (k * ps + t) * D + j;
        cp_async16(kd + dst, k_pool + off, in_pool ? 16 : 0);
        cp_async16(vd + dst, v_pool + off, in_pool ? 16 : 0);
      }
    }
    if (tid < spi) {
      const int si = it * spi + tid;
      int flag = 2;
      if (si < n_steps) {
        const int page = ids_s[si];
        flag = page >= 0 && page < n_pool &&
               (!kCuckoo || sel_s[si / 2] == (si & 1));
      }
      flag_s[slot * spi + tid] = flag;
    }
  };

  for (int k = 0; k < stages - 1; ++k) {
    if (k < n_iter) issue(k, k);
    cp_async_commit();
  }
  // this lane's K row of the first pass, as (step in the loop step, token)
  const int r_first = warp * kRpw + grp;
  const int k_first = r_first / ps, t_first = r_first - k_first * ps;
  int slot = 0;
  for (int it = 0; it < n_iter; ++it) {
    wait_oldest(stages);
    // this step's rows have landed for every thread, and every reader of
    // the slot refilled below (the last step's) is done
    __syncthreads();
    const int ahead = it + stages - 1;
    if (ahead < n_iter) issue(ahead, ahead % stages);
    cp_async_commit();
    const T* kt = ring + slot * slot_vals;
    const T* vt = kt + static_cast<size_t>(rows) * D;
    int k = k_first, t = t_first;
    for (int r0 = 0; r0 < rows; r0 += kRowsPerPass) {
      // scores: kLpr lanes a K row, 8 values of d each against the kQ query
      // rows in registers; each lane ends with one query row's score
      const int r = r0 + r_first;
      float kf[8];
#pragma unroll
      for (int c = 0; c < 8; c += kPer)
        chunk_floats(kt + min(r, rows - 1) * D + sub * 8 + c, kf + c);
      float dot[kQ];
#pragma unroll
      for (int gi = 0; gi < kQ; ++gi) {
        dot[gi] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot[gi] += qr[gi][e] * kf[e];
      }
      const float d_me = row_dot<kLpr>(dot, lane);
      float s = __int_as_float(0xff800000);  // -inf: past the loop step
      if (r < rows) {
        const int flag = flag_s[slot * spi + k];
        const int64_t pos =
            static_cast<int64_t>((s0 + it * spi + k) / kFetch) * ps + t;
        if (flag == 1 && pos < seq_len)
          s = d_me / root_d;
        else if (flag != 2)
          s = kNegInf;
      }
      // online softmax over the warp's kRpw rows of the pass
      float mx = s;
#pragma unroll
      for (int off = kLpr; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_me, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int off = kLpr; off < 32; off <<= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      const float alpha = expf(m_me - m_new);
      l_me = l_me * alpha + sum;
      m_me = m_new;
      __syncwarp();  // the last pass's readers of pw are done
      pw[grp * kQ + my_q] = p;
      pw[kRpw * kQ + my_q] = alpha;
      __syncwarp();
      // acc = acc * alpha + p.v over the warp's rows: a lane keeps kVpl
      // values of each query row (pairs at lane * 2 + 64 u)
      const float4 al = *reinterpret_cast<const float4*>(pw + kRpw * kQ);
      const float alphas[kQ] = {al.x, al.y, al.z, al.w};
#pragma unroll
      for (int gi = 0; gi < kQ; ++gi)
#pragma unroll
        for (int v = 0; v < kVpl; ++v) acc[gi][v] *= alphas[gi];
#pragma unroll
      for (int rr = 0; rr < kRpw; ++rr) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + rr * kQ);
        const float ps4[kQ] = {p4.x, p4.y, p4.z, p4.w};
        const T* vr = vt + min(r0 + warp * kRpw + rr, rows - 1) * D;
#pragma unroll
        for (int u = 0; u < kVpl / 2; ++u) {
          const float2 v = pair_floats(vr + u * 64 + lane * 2);
#pragma unroll
          for (int gi = 0; gi < kQ; ++gi) {
            acc[gi][2 * u] += ps4[gi] * v.x;
            acc[gi][2 * u + 1] += ps4[gi] * v.y;
          }
        }
      }
      for (t += kRowsPerPass; t >= ps; t -= ps) ++k;
    }
    slot = slot + 1 == stages ? 0 : slot + 1;
  }
  __syncthreads();  // the ring is free: it takes the warps' states

  // merge the warps in warp order: m = max m_w, weights exp(m_w - m)
  float* red = reinterpret_cast<float*>(smem);  // acc (kWarps, kQ, D)
  float* red_m = pw_all;                         // (kWarps, kQ)
  float* red_l = pw_all + kWarps * kQ;
#pragma unroll
  for (int gi = 0; gi < kQ; ++gi)
#pragma unroll
    for (int u = 0; u < kVpl / 2; ++u)
      *reinterpret_cast<float2*>(red + (warp * kQ + gi) * D + u * 64 +
                                 lane * 2) =
          make_float2(acc[gi][2 * u], acc[gi][2 * u + 1]);
  red_m[warp * kQ + my_q] = m_me;
  red_l[warp * kQ + my_q] = l_me;
  __syncthreads();
  // a query row's partial (acc, m, l) of this run, or with one run its
  // (o, m, l)
  const size_t n_rows = static_cast<size_t>(n_kv) * g;
  for (int i = tid; i < kQ * D; i += kThreads) {
    const int gi = i / D, j = i % D;
    if (g0 + gi >= g) continue;
    float m = red_m[gi];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_m[w * kQ + gi]);
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(red_m[w * kQ + gi] - m);
      a += red[(w * kQ + gi) * D + j] * wt;
      l += red_l[w * kQ + gi] * wt;
    }
    const size_t row = static_cast<size_t>(h) * g + g0 + gi;
    if (n_splits == 1) {
      o[row * D + j] = a / fmaxf(l, 1e-30f);
      if (j == 0) {
        m_out[row] = m;
        l_out[row] = l;
      }
    } else {
      ws[(row * n_splits + split) * D + j] = a;
      if (j == 0) {  // m (n_rows, n_splits) after the accs, then l
        const size_t base = n_rows * n_splits * D;
        ws[base + row * n_splits + split] = m;
        ws[base + (n_rows + row) * n_splits + split] = l;
      }
    }
  }
}

// One block a query row: its runs' partials (acc (n_splits, D), m and l
// (n_splits,) in the workspace) -> o (D,), m, l.  Thread group `grp` takes
// runs grp, grp + kGroups, ... in order with a running maximum (no wait for
// the row's maximum before the loads), then the groups merge in group
// order: m = max m_i, l = sum l_i exp(m_i - m), o = sum acc_i exp(m_i - m)
// / max(l, 1e-30), the same bits in every run.
template <int D>
__global__ void __launch_bounds__(kCombineThreads)
    paged_combine_kernel(const float* __restrict__ ws, float* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         int n_rows, int n_splits) {
  constexpr int kCols = D / 4;                      // float4 columns
  constexpr int kGroups = kCombineThreads / kCols;  // runs taken at once
  __shared__ float4 part[kCombineThreads];
  __shared__ float part_m[kGroups], part_l[kGroups];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int c = tid % kCols, grp = tid / kCols;
  const size_t all = static_cast<size_t>(n_rows) * n_splits;
  const float4* acc =
      reinterpret_cast<const float4*>(ws + static_cast<size_t>(row) *
                                               n_splits * D);
  const float* m_ws = ws + all * D + static_cast<size_t>(row) * n_splits;
  const float* l_ws = m_ws + all;

  float m = __int_as_float(0xff800000), l = 0.f;  // -inf: no run yet
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int s = grp; s < n_splits; s += kGroups) {
    const float ms = m_ws[s], ls = l_ws[s];
    const float4 x = acc[static_cast<size_t>(s) * kCols + c];
    const float m_new = fmaxf(m, ms);
    const float c_old = expf(m - m_new), c_new = expf(ms - m_new);
    a.x = a.x * c_old + x.x * c_new;
    a.y = a.y * c_old + x.y * c_new;
    a.z = a.z * c_old + x.z * c_new;
    a.w = a.w * c_old + x.w * c_new;
    l = l * c_old + ls * c_new;
    m = m_new;
  }
  part[tid] = a;
  if (c == 0) {
    part_m[grp] = m;
    part_l[grp] = l;
  }
  __syncthreads();
  if (tid < kCols) {
    float mx = part_m[0];
    for (int k = 1; k < kGroups; ++k) mx = fmaxf(mx, part_m[k]);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    float lt = 0.f;
    for (int k = 0; k < kGroups; ++k) {
      const float w = expf(part_m[k] - mx);
      const float4 x = part[k * kCols + tid];
      t.x += x.x * w;
      t.y += x.y * w;
      t.z += x.z * w;
      t.w += x.w * w;
      lt += part_l[k] * w;
    }
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    reinterpret_cast<float4*>(o + static_cast<size_t>(row) * D)[tid] =
        make_float4(t.x * inv, t.y * inv, t.z * inv, t.w * inv);
    if (tid == 0) {
      m_out[row] = mx;
      l_out[row] = lt;
    }
  }
}

template <typename T, int D, bool kCuckoo>
int launch_typed(const void* q, const void* k_pool, const void* v_pool,
                 const void* page_ids, const void* select, void* o,
                 void* m_out, void* l_out, void* ws, int n_pages, int n_pool,
                 int ps, int n_kv, int g, int seq_len, int split_pages,
                 cudaStream_t stream) {
  const int n_qt = (g + kQ - 1) / kQ;
  if (split_pages < 1 || split_pages > kMaxSplitPages || n_pages < 1 ||
      g < 1 || static_cast<int64_t>(n_kv) * n_qt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_splits = (n_pages - 1) / split_pages + 1;
  if (n_splits > 1 && ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int stages = kMaxStages;
  size_t smem = split_smem_bytes(stages, ps, D, sizeof(T));
  while (smem > kSmemLimit && stages > 2)
    smem = split_smem_bytes(--stages, ps, D, sizeof(T));
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = paged_split_kernel<T, D, kCuckoo>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(n_splits, n_kv * n_qt), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int32_t*>(page_ids),
      static_cast<const int32_t*>(select), static_cast<float*>(o),
      static_cast<float*>(m_out), static_cast<float*>(l_out),
      static_cast<float*>(ws), n_pages, n_pool, ps, n_kv, g, seq_len,
      split_pages, n_splits, stages);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  paged_combine_kernel<D><<<n_kv * g, kCombineThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(o),
      static_cast<float*>(m_out), static_cast<float*>(l_out), n_kv * g,
      n_splits);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16; d: 64 or 128.  Any other pair returns
// cudaErrorInvalidValue without launching.
template <bool kCuckoo>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const void* page_ids, const void* select, void* o, void* m_out,
             void* l_out, void* ws, int n_pages, int n_pool, int ps, int n_kv,
             int g, int d, int dtype, int seq_len, int split_pages,
             void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_LAUNCH(T, D)                                                  \
  return launch_typed<T, D, kCuckoo>(q, k_pool, v_pool, page_ids, select, o, \
                                     m_out, l_out, ws, n_pages, n_pool, ps,  \
                                     n_kv, g, seq_len, split_pages, s)
  if (dtype == 0 && d == 64) PAGED_LAUNCH(float, 64);
  if (dtype == 0 && d == 128) PAGED_LAUNCH(float, 128);
  if (dtype == 1 && d == 64) PAGED_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && d == 128) PAGED_LAUNCH(__nv_bfloat16, 128);
#undef PAGED_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Ludo-paged decode: L = n_pages steps over page_map, in runs of
// split_pages pages.  `ws` holds n_kv * n_splits * g * (d + 2) floats
// (n_splits = ceil(n_pages / split_pages)); it may be null for one split.
// Launches the split pass, and the combine pass for more than one split, on
// `stream`, and returns cudaGetLastError() (0 on success).
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_map,
                                      void* o, void* m_out, void* l_out,
                                      void* ws, int n_pages, int n_pool,
                                      int ps, int n_kv, int g, int d,
                                      int dtype, int seq_len, int split_pages,
                                      void* stream) {
  return dispatch<false>(q, k_pool, v_pool, page_map, nullptr, o, m_out,
                         l_out, ws, n_pages, n_pool, ps, n_kv, g, d, dtype,
                         seq_len, split_pages, stream);
}

// Cuckoo baseline: 2 * n_pages steps over page_map2 (n_pages, 2), select
// (n_pages,), in runs of split_pages logical pages (2 * split_pages steps).
// The rest as paged_attention_launch.
extern "C" int cuckoo_paged_attention_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_map2, const void* select, void* o, void* m_out,
    void* l_out, void* ws, int n_pages, int n_pool, int ps, int n_kv, int g,
    int d, int dtype, int seq_len, int split_pages, void* stream) {
  return dispatch<true>(q, k_pool, v_pool, page_map2, select, o, m_out, l_out,
                        ws, n_pages, n_pool, ps, n_kv, g, d, dtype, seq_len,
                        split_pages, stream);
}
