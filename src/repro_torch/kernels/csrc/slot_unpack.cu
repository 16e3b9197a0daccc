// Vectorised unpack of the 64-bit DMPH slot bitfield: the MN-side decode.
//
// Replaces the Pallas TPU kernel src/repro/kernels/slot_unpack.py
// (slot_unpack_kernel, body _kernel).  For each slot (lo, hi):
//   cache = hi >> 31 & 1,  fp = hi >> 25 & 0x3F,  len = hi >> 16 & 0x1FF,
//   addr = lo   (addr_hi, bits 15:0 of hi, is dropped as in the reference)
// The plain version is repro_torch/kernels/ref.py::slot_unpack_ref.
//
// Bound on an H100: bytes.  8 B read and 16 B written a slot, three shifts
// and masks of work; at 2^20 slots that is 25 MB, about 7.5 us at
// 3.35 TB/s.  At the serving window (1024 slots) the kernel is bound by
// launch latency.
//
// Design: one thread per slot, native uint32_t shifts, ragged edge masked
// here.  Neighbouring threads read and write neighbouring words, so every
// access coalesces; no shared memory is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void slot_unpack_kernel(const uint32_t* __restrict__ s_lo,
                                   const uint32_t* __restrict__ s_hi,
                                   int32_t* __restrict__ cache,
                                   int32_t* __restrict__ fp,
                                   int32_t* __restrict__ len,
                                   uint32_t* __restrict__ addr, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t hi = s_hi[i];
  cache[i] = static_cast<int32_t>((hi >> 31) & 1u);
  fp[i] = static_cast<int32_t>((hi >> 25) & 0x3Fu);
  len[i] = static_cast<int32_t>((hi >> 16) & 0x1FFu);
  addr[i] = s_lo[i];
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int slot_unpack_launch(const void* s_lo, const void* s_hi,
                                  void* cache, void* fp, void* len,
                                  void* addr, int n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  slot_unpack_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(s_lo), static_cast<const uint32_t*>(s_hi),
      static_cast<int32_t*>(cache), static_cast<int32_t*>(fp),
      static_cast<int32_t*>(len), static_cast<uint32_t*>(addr), n);
  return static_cast<int>(cudaGetLastError());
}
