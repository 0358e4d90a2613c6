// Row gather out[n, :] = table[idx[n], :], hand-written for Hopper (sm_90a).
//
// Replaces the Pallas kernel grmonty_tpu/ops/gather.py:63 `_gather_kernel`
// (wrapper `vmem_row_gather`), which gathers rows of the raw 32-wide
// bilinear corner table for the hot step, the event phase and the
// fresh-lane init under reference semantics.  The TPU kernel held the whole
// table in VMEM and permuted it per sublane; here the table stays in device
// memory and the 50 MB L2 caches it (the 256x256 table is 8.4 MB).
//
// Contract (the TPU kernel's): table (Z, W) float32, contiguous, W a
// multiple of 4, 16-byte aligned; idx (N,) int32 in [0, Z), unchecked (the
// TPU kernel's PROMISE_IN_BOUNDS); out (N, W) float32, contiguous.
//
// Design: one thread per float4 of output.  W/4 neighbouring threads copy
// one row (eight for W = 32, so a warp moves four 128 B rows), each with
// one 16 B load through the read-only path (__ldg) and one 16 B store; the
// stores are fully coalesced, the loads are whole 128 B lines.  What bounds
// it on the H100: bytes.  Per row it reads 128 B of table and 4 B of index
// and writes 128 B, 17.0 MB at N = 65536, 5.1 us at 3.35 TB/s; it does no
// arithmetic beyond the address.
//
// Interface: the plain C convention of hot_step.cu: an array of device
// pointers (table, idx, out), an array of double scalars (W), the row count
// N and the CUDA stream; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    row_gather_kernel(const float4 *__restrict__ table,
                      const int32_t *__restrict__ idx, float4 *__restrict__ out,
                      int n, int w4) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)n * w4) return;
  const int64_t row = t / w4;
  const int64_t q = t - row * w4;
  out[t] = __ldg(table + (int64_t)__ldg(idx + row) * w4 + q);
}

}  // namespace

extern "C" {

int row_gather_nptrs() { return 3; }
int row_gather_nscal() { return 1; }

int row_gather_launch(void **ptrs, const double *scal, int n, void *stream) {
  const int w4 = (int)scal[0] / 4;
  const int64_t total = (int64_t)n * w4;
  if (total > 0) {
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    row_gather_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4 *)ptrs[0], (const int32_t *)ptrs[1], (float4 *)ptrs[2], n,
        w4);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
