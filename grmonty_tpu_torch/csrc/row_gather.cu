// Row gather out[n, :] = table[idx[n], :], hand-written for Hopper (sm_90a),
// in float (row_gather) and in double (row_gather_f64).
//
// Replaces the Pallas kernel grmonty_tpu/ops/gather.py:63 `_gather_kernel`
// (wrapper `vmem_row_gather`), which gathers rows of the raw 32-wide
// bilinear corner table for the hot step, the event phase and the
// fresh-lane init under reference semantics.  The TPU kernel held the whole
// table in VMEM and permuted it per sublane; here the table stays in device
// memory and the 50 MB L2 caches it (the 256x256 table is 8.4 MB in float,
// 16.8 MB in double).
//
// Contract (the TPU kernel's): table (Z, W) float or double, contiguous,
// 16-byte aligned, W a multiple of 4 (float) or of 2 (double); idx (N,)
// int32 in [0, Z), unchecked (the TPU kernel's PROMISE_IN_BOUNDS); out (N,
// W) of the table's type, contiguous.
//
// Design: one thread per 16-byte unit of output (a float4 or a double2).
// The units of one row go to neighbouring threads (eight for W = 32 in
// float, sixteen in double), each with one 16 B load through the read-only
// path (__ldg) and one 16 B store; the stores are fully coalesced, the loads
// are whole 128 B lines.  What bounds it on the H100: bytes.  Per row it
// reads W values of table and 4 B of index and writes W values: at N =
// 65536 and W = 32, 17.0 MB in float (5.1 us at 3.35 TB/s) and 33.8 MB in
// double (10.1 us); it does no arithmetic beyond the address.
//
// Interface: the plain C convention of hot_step.cu: an array of device
// pointers (table, idx, out), an array of double scalars (W), the row count
// N and the CUDA stream; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// V: the 16-byte unit, float4 or double2; u: the units of a row.
template <typename V>
__global__ void __launch_bounds__(THREADS)
    row_gather_kernel(const V *__restrict__ table, const int32_t *__restrict__ idx,
                      V *__restrict__ out, int n, int u) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)n * u) return;
  const int64_t row = t / u;
  const int64_t q = t - row * u;
  out[t] = __ldg(table + (int64_t)__ldg(idx + row) * u + q);
}

template <typename V>
int launch_gather(void **ptrs, int n, int u, void *stream) {
  const int64_t total = (int64_t)n * u;
  if (total > 0) {
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    row_gather_kernel<V><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const V *)ptrs[0], (const int32_t *)ptrs[1], (V *)ptrs[2], n, u);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int row_gather_nptrs() { return 3; }
int row_gather_nscal() { return 1; }
int row_gather_f64_nptrs() { return 3; }
int row_gather_f64_nscal() { return 1; }

int row_gather_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_gather<float4>(ptrs, n, (int)scal[0] / 4, stream);
}

int row_gather_f64_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_gather<double2>(ptrs, n, (int)scal[0] / 2, stream);
}

}  // extern "C"
