// The engine run's exit test, hand-written for Hopper (sm_90a): whether the
// next block runs, computed on the card into words the engine owns, so that
// a block replayed from a CUDA graph runs under a conditional node on that
// word and the host reads it one replay behind.
//
// Replaces no TPU kernel: it is the `cond` of the JAX engine's
// `lax.while_loop` (grmonty_tpu/transport/engine.py, `run`), which XLA
// evaluates on the device between two bodies:
//
//   go = (sum(occupied) > tail_exit | backlog_pos < n_valid | sec.count > 0)
//        & (bodies * n_super < max_outer)
//
// (the JAX engine caps the state's own `it`; the port caps the iterations
// of this run, bodies * n_super, as its host loop did).  It writes
// word = [occ, pos, sec, bodies + go, go] (int64) and go (bool), and adds
// go to the run's body count held in word[3]: word[3] counts the bodies
// the run has run or is about to.  Inside a captured graph it also sets
// the condition of the conditional IF node that guards the next block
// (a handle passed in, `set_handle`).  The plain version is
// engine.exit_test_plain.
//
// Contract: occupied (N,) bool (bytes 0 or 1), any alignment; backlog_pos,
// sec_count, n_valid, tail_exit int64 scalars; word (5,) int64; go one
// bool byte; all on the card; the handle (a cudaGraphConditionalHandle
// passed as a pointer's bits, read only where set_handle).  Scalars:
// n_super, max_outer, set_handle.  One launch of one block, in place on
// word and go.
//
// What bounds it on the H100: latency.  It reads N bytes of occupied (64 KiB
// at the path's 65,536 lanes, 0.02 us at 3.35 TB/s) and a few words; its
// time is one launch and one block's reduction.  Design: one block of 1,024
// threads; each thread counts its 16-byte units of the mask (a uint4 load,
// the set bytes counted by __popc of each 32-bit word, since a set bool is
// the byte 1), the unaligned head and tail byte by byte; a warp's counts are
// summed by shuffles, the warps' by the first warp, and thread 0 writes the
// word.  The count is exact, so the word is bit for bit the plain version's.
//
// Interface: the plain C convention of hot_step.cu: an array of device
// pointers (occupied, backlog_pos, sec_count, n_valid, tail_exit, word, go,
// the handle), an array of double scalars (n_super, max_outer, set_handle),
// the lane count N and the CUDA stream; returns cudaGetLastError() after
// the launch.
//
// The same file builds the conditional nodes that guard the blocks of a
// replay on `go`, through the CUDA runtime on the graph that PyTorch is
// capturing (exit_guard_handle, exit_guard_begin / exit_guard_end): a
// conditional handle on that graph for each block, made before the exit
// test that sets it is captured; an IF node on it, and the block captured
// into the node's body graph from a second stream; the capture stream then
// continues after the node.  The exit test after block i sets block i + 1's
// condition.  The first block of a replay has no test before it in the same
// graph launch (its test closed the previous replay, or ran at the run's
// entry outside the graph), and a condition's value does not carry over
// from one launch of a graph to the next; so one one-thread kernel at the
// head of each replay (exit_guard_kernel) sets that block's condition from
// `go`.  (PyTorch 2.11's CUDAGraph has no conditional node of its own; this
// is what its later begin_capture_to_if_node does.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
    exit_test_kernel(const unsigned char *__restrict__ occupied, int n,
                     const long long *__restrict__ backlog_pos,
                     const long long *__restrict__ sec_count,
                     const long long *__restrict__ n_valid,
                     const long long *__restrict__ tail_exit, long long *__restrict__ word,
                     bool *__restrict__ go, long long n_super, long long max_outer,
                     cudaGraphConditionalHandle handle, int set_handle) {
  __shared__ unsigned warp_sum[WARPS];
  const int t = threadIdx.x;
  const uintptr_t at = (uintptr_t)occupied;
  int head = (int)((16 - (at & 15)) & 15);
  if (head > n) head = n;
  const int units = (n - head) / 16;
  const int tail = head + 16 * units;
  unsigned count = 0;
  if (t < head) count += occupied[t] != 0;
  const uint4 *v = reinterpret_cast<const uint4 *>(occupied + head);
  for (int i = t; i < units; i += THREADS) {
    const uint4 q = v[i];
    count += __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w);
  }
  if (tail + t < n) count += occupied[tail + t] != 0;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) count += __shfl_down_sync(0xffffffffu, count, d);
  if ((t & 31) == 0) warp_sum[t >> 5] = count;
  __syncthreads();
  if (t >= 32) return;
  count = t < WARPS ? warp_sum[t] : 0u;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) count += __shfl_down_sync(0xffffffffu, count, d);
  if (t != 0) return;
  const long long occ = (long long)count;
  const long long pos = *backlog_pos, sec = *sec_count;
  const long long bodies = word[3];
  const bool work = (occ > *tail_exit) || (pos < *n_valid) || (sec > 0);
  const bool g = work && (bodies * n_super < max_outer);
  word[0] = occ;
  word[1] = pos;
  word[2] = sec;
  word[3] = bodies + (g ? 1 : 0);
  word[4] = g ? 1 : 0;
  *go = g;
  if (set_handle) cudaGraphSetConditional(handle, g ? 1u : 0u);
}

// The condition of a replay's first block from the exit word's go, at the
// head of each graph launch.
__global__ void exit_guard_kernel(cudaGraphConditionalHandle handle, const bool *go) {
  cudaGraphSetConditional(handle, *go ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus *status, cudaGraph_t *graph,
                         const cudaGraphNode_t **deps, size_t *n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, nullptr, n_deps);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps, n_deps);
#endif
}

}  // namespace

extern "C" {

// Make a conditional handle (default 0 at each launch) on the graph that
// `stream` is capturing.  Returns a CUDA error, or -1 when `stream` is not
// capturing.
int exit_guard_handle(void *stream, unsigned long long *handle) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t *deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info((cudaStream_t)stream, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, cudaGraphCondAssignDefault);
  *handle = (unsigned long long)h;
  return (int)err;
}

// Capture an IF node on `handle` (exit_guard_handle) into the graph that
// `stream` is capturing, after one launch of exit_guard_kernel that sets
// its condition from *go where go is not null (a replay's first block),
// and start capturing `body_stream` into the node's body graph.  Returns a
// CUDA error, or -1 when `stream` is not capturing.
int exit_guard_begin(void *stream, void *body_stream, unsigned long long handle,
                     const void *go) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t *deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(s, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  if (go != nullptr) {
    exit_guard_kernel<<<1, 1, 0, s>>>((cudaGraphConditionalHandle)handle, (const bool *)go);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    err = capture_info(s, &status, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return (int)err;
  }
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body, nullptr, nullptr,
                                            0, cudaStreamCaptureModeThreadLocal);
}

// End the capture of the node's body (exit_guard_begin).
int exit_guard_end(void *body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

int exit_test_nptrs() { return 8; }
int exit_test_nscal() { return 3; }

int exit_test_launch(void **ptrs, const double *scal, int n, void *stream) {
  exit_test_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const unsigned char *)ptrs[0], n, (const long long *)ptrs[1],
      (const long long *)ptrs[2], (const long long *)ptrs[3], (const long long *)ptrs[4],
      (long long *)ptrs[5], (bool *)ptrs[6], (long long)scal[0], (long long)scal[1],
      (cudaGraphConditionalHandle)(uintptr_t)ptrs[7], scal[2] != 0.0);
  return (int)cudaGetLastError();
}

}  // extern "C"
