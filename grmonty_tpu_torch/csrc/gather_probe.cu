// Gather-and-row-sum kernels of the gather probes, hand-written for Hopper
// (sm_90a).  They answer, on the card, the question the TPU probes answered
// for the TPU: how should a row gather from a (Z, w) table be laid out over
// threads and memory?
//
// Replaces the Pallas kernels of the three probes under tools/ (each a
// gather followed by a row sum, out[n] = sum_j table[idx[n], j], except
// the last, a row copy):
//   gather_rowsum_coop        tools/probe_gather.py:104 `kernel` (pallas_gather),
//                             tools/probe_pallas_gather.py:99 `takeB_kernel`,
//                             tools/probe_vmem_gather.py:106 `take_kernel` and
//                             :142 `taa_kernel` (jnp.take and take_along_axis
//                             differ only in how Mosaic lowers the gather; on
//                             Hopper the two are one kernel);
//   gather_rowsum_persistent  tools/probe_pallas_gather.py:74 `take1_kernel`
//                             (one grid step over the whole pool);
//   gather_rowsum_rowloop     tools/probe_gather.py:133 `kernel2` (a scalar
//                             loop over the rows, pallas_loop);
//   gather_rowsum_smem        tools/probe_pallas_gather.py:125 `dsB_kernel`
//                             (rows copied one by one into a scratch tile,
//                             then summed);
//   row_gather_rowloop        tools/probe_vmem_gather.py:178 `ds_kernel`
//                             (out[n, :] = table[idx[n], :], one row per step).
//
// Contract (the TPU kernels'): table (Z, w) float32, contiguous, 16-byte
// aligned, w a multiple of 4; idx (N,) int32 in [0, Z), unchecked; out (N,)
// float32 for a row sum, (N, w) for the row copy.  Every kernel masks its
// own ragged edge, so N need not be a multiple of any block.
//
// What bounds them on the H100: bytes.  At N = Z = 65,536 and uniform
// indices about Z (1 - 1/e) = 41,427 distinct rows are read once.  At
// w = 32 (128 B rows) a row sum moves 5.30 MB of rows, 0.26 MB of indices
// and 0.26 MB of output, 1.74 us at 3.35 TB/s; the row copy writes 8.39 MB
// more, 4.17 us.  At w = 216 (864 B rows) the rows are 35.79 MB: 10.84 us
// for a row sum, and with 56.62 MB written 27.66 us for the row copy.  Up
// to w = 128 (33.5 MB) the table fits the 50 MB L2; at w = 216 and 256
// (56.6 and 67.1 MB) it does not, though the rows one index set touches
// (35.8 MB at w = 216) may stay there across launches.  The designs differ
// in how the row's bytes reach a thread:
//   coop        one wave of persistent blocks of ROWSUM_THREADS; a warp
//               takes a batch of B rows: the batch's indices in one
//               coalesced load (lane l holds row l's), then G lanes a row
//               (G the largest power of two at most 32 and at most w/4;
//               P = 32/G rows side by side) and U row passes, every 16 B
//               __ldg of the batch issued before the first add (U * K
//               loads a lane in flight, K = 1 or 2 float4s a lane a row,
//               about ROWSUM_LOADS_NARROW for rows under 32 float4s and
//               ROWSUM_LOADS above), shuffle reductions, and the B sums in
//               one coalesced store; the next batch's indices are loaded
//               before this batch's rows.  At w = 32: G = 8, U = 4, B = 16
//               rows; at w = 216: G = 32, K = 2 (54 float4s, lanes 22-31
//               take one), U = 4, B = 4.  The index -> row -> store chain
//               runs once for every row at once, where two waves of
//               one-row-per-group blocks ran it twice.  What is left at
//               w = 32 is not the HBM bound: the rows sit in L2 across
//               launches, every one of the N row reads (8.4 MB with the
//               repeats) crosses from L2 to the SMs, and a launch of a
//               single row takes a large part of the time.  The launch
//               is programmatic (PDL): the next launch's blocks are
//               scheduled while this one drains and wait in
//               griddepcontrol.wait, which takes part of that floor out of
//               a chain of launches;
//   persistent  one grid step over the whole pool: one wave of blocks of
//               PERSIST_THREADS, sized by occupancy (no more than the rows
//               need) and bound to every thread an SM can hold, over the
//               flat list of (row, lane) pairs, G lanes a row as in coop.
//               Where coop hands each warp batches of consecutive rows,
//               here thread t takes pair t of every pass, a pass being the
//               grid's threads: its rows lie one pass (grid threads / G
//               rows) apart.  The passes are fixed at launch from N; a
//               thread loads the indices of a group of U passes, then
//               issues every 16 B __ldg of their rows (U K a lane, U =
//               PERSIST_LOADS / K, or PERSIST_LOADS_NARROW / K for rows
//               under 32 float4s) with the next group's indices, then adds,
//               reduces by shuffles and stores: the index -> row -> store
//               chain runs once for U passes, where a grid-stride loop ran
//               it once a pass, and the next indices are in flight with the
//               rows.  At w = 32 (G = 8) N = 65,536 rows are 524,288 pairs,
//               two passes of the 270,336 threads; at w = 216 (G = 32,
//               K = 2) 2.1 M pairs, eight passes in four groups.  The
//               launch is programmatic, as coop's;
//   rowloop     the TPU kernel's form: an owner that walks its rows in order,
//               a step at a time.  Each warp walks a run of consecutive steps,
//               P = 32/G rows a step side by side, G lanes a row on 16 B
//               loads (G and K as coop's), a wider row's chunks of G K
//               float4s in turn.  The walk is a software pipeline of fixed
//               depth held in registers: a ring of D + 1 slots, the row loads
//               of the D items after the one being summed in flight (D =
//               ROWLOOP_LOADS / K for G = 32, ROWLOOP_LOADS_NARROW / K
//               below), each item's index loaded D + 1 items ahead of its
//               row; the item's load D ahead is issued before its adds, a
//               step's sum reduces by shuffles and stays with one lane of its
//               group, and every 32 rows (Q = G steps) go out in one
//               coalesced store.  One wave of blocks of ROWLOOP_THREADS
//               sized by occupancy (no more warps than the steps fill; each
//               takes ceil(steps / warps)), launched programmatically.  Where
//               coop issues a batch's loads at once and then adds them all,
//               this walk streams with a bounded number in flight.  What the
//               card showed (PERF.md): at w = 32 a warp's run is 4 steps, so
//               the cost is the walk's own instructions, not its depth: the
//               counters are 32-bit, a lane's live items end at one limit,
//               the loads past a run's end are skipped by uniform branches,
//               and the registers are capped for ROWLOOP_MIN_BLOCKS blocks an
//               SM (one 512-thread block an SM at 85-105 registers cost 35%).
//               At w = 32: G = 8, P = 4, D = 4; at w = 216: G = 32, K = 2,
//               P = 1, D = 4.  It replaced one thread a row making w scalar
//               4 B loads in order, where each warp load touched 32 rows'
//               lines to use 128 bytes and fed one serial add chain;
//   smem        the rows land in shared memory before they are summed.  One
//               wave of persistent blocks of SMEM_THREADS (sized by
//               occupancy, launched programmatically) walks tiles of T
//               consecutive rows, a warp a tile, T = min(blk, 32, the rows
//               a warp's stage holds): blk, the JAX probe's grid block, only
//               caps the stage.  It no longer sets the grid, which on this
//               card left SMs idle (at blk = 8,192 and N = 65,536, 8 blocks
//               on 132 SMs).  Each warp has two stages of SMEM_STAGE_F4
//               float4s (2 KB: T = 16 rows at w = 32, 2 at w = 216): while it
//               sums its tile in one, the 16 B cp.async copies of its next
//               tile fill the other (commit_group, wait_group 1), the
//               tile's indices having come a tile ahead in one coalesced
//               load (lane l holds row l's).  Copy and sum share one
//               layout, G lanes a row (G as coop's) on consecutive float4s
//               and P = 32 / G rows side by side, so that a warp reads
//               whole rows from memory and conflict-free float4s from
//               shared memory; shuffle reductions leave lane l with row l's
//               sum, and the tile's sums go out in one coalesced store.
//               Only the warp synchronises: tiles of a whole block, with
//               __syncthreads at each step, waited for the block's slowest
//               warp and lost to the old one-thread-a-row kernel at blk 256
//               on the card.  What this design pays beyond coop is the trip
//               through shared memory: the N rows are written to it and
//               read back (16.8 MB at w = 32, about 0.5 us at 128 B a clock
//               an SM), and few blocks win (512 threads a block);
//   row_gather_rowloop  the output of T consecutive rows is one contiguous
//               tile of 4 w T bytes (T = COPY_STAGE_BYTES / (4 w): 64 rows
//               at w = 32, 9 at w = 216, 8 at w = 256).  Persistent CTAs
//               (one wave, launched programmatically as coop is) walk the
//               tiles: the CTA's threads gather a tile's rows into a
//               shared-memory stage with 16 B cp.async (consecutive
//               threads on consecutive float4s of a row, so a warp reads
//               whole rows), wait, fence the shared memory to the async
//               proxy, and one thread writes the whole tile out with one
//               bulk copy (cp.async.bulk.global.shared::cta) that runs
//               while the CTA gathers its next tile into the other stage
//               (COPY_STAGES stages; a stage is refilled once the bulk copy
//               that read it has finished reading).  Every store is one
//               bulk write of contiguous bytes.  One cp.async.bulk a row
//               into the stage, completing on an mbarrier, was tried
//               instead of the lanes' 16 B copies and lost at w = 8 (a bulk
//               request for every 32 B row) without winning elsewhere.
//
// Interface: the plain C convention of row_gather.cu: an array of device
// pointers (table, idx, out), an array of double scalars (w; for smem also
// T, the rows of one stage, which the wrapper derives from blk), the row
// count N and the CUDA stream; returns cudaGetLastError() after the launch.
// gather_rowsum_persistent_pass_rows(w) gives the rows one pass of the
// persistent kernel covers on the current device, and
// gather_rowsum_rowloop_wave_rows(w) the rows of the rowloop kernel's
// whole wave at one step a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Sizes of the redesigned kernels, chosen on the card at w = 8, 32, 216
// and 256 (PERF.md): gather_rowsum_coop's block size and the 16-byte
// loads a lane has in flight per batch, for rows of 32 float4s or more
// (G = 32) and for narrower rows; the bytes and number of
// row_gather_rowloop's shared-memory stages (a row must fit a stage, so
// w <= COPY_STAGE_BYTES / 4 = 2,048); gather_rowsum_smem's block size and
// the float4s of one warp's stage (a row must fit a stage, so w <= 4
// SMEM_STAGE_F4 = hot_kernels.SMEM_STAGE_FLOATS = 512); gather_rowsum_
// persistent's block size and 16-byte loads a lane has in flight, as
// coop's; gather_rowsum_rowloop's block size, the 16-byte loads a lane
// has in flight behind the item it sums (as coop's) and the blocks an SM
// its registers are capped for (256-thread blocks and three an SM lost on
// the card).
constexpr int ROWSUM_THREADS = 512;
constexpr int ROWSUM_LOADS = 8;
constexpr int ROWSUM_LOADS_NARROW = 4;
constexpr int COPY_STAGE_BYTES = 8192;
constexpr int COPY_STAGES = 2;
constexpr int SMEM_THREADS = 512;
constexpr int SMEM_STAGE_F4 = 128;
constexpr int PERSIST_THREADS = 256;
constexpr int PERSIST_LOADS = 4;
constexpr int PERSIST_LOADS_NARROW = 2;
constexpr int ROWLOOP_THREADS = 512;
constexpr int ROWLOOP_LOADS = 8;
constexpr int ROWLOOP_LOADS_NARROW = 4;
constexpr int ROWLOOP_MIN_BLOCKS = 2;

constexpr int THREADS = 256;
constexpr int COOP_WARPS = ROWSUM_THREADS / 32;
constexpr int SMEM_WARPS = SMEM_THREADS / 32;
constexpr int ROWLOOP_WARPS = ROWLOOP_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
static_assert(COPY_STAGE_BYTES % 128 == 0 && COPY_STAGES >= 2 &&
                  COPY_STAGES * COPY_STAGE_BYTES <= 48 * 1024,
              "row copy stages: 128-byte multiples, at least two, within 48 KB");
static_assert(SMEM_THREADS / 32 * 2 * SMEM_STAGE_F4 * 16 <= 227 * 1024,
              "smem: two stages a warp within a block's shared memory");

// Programmatic dependent launch (the redesigned kernels): let the
// stream's next launch be scheduled now, then wait until the launches
// before this one have finished and their writes are visible.  A kernel
// reads nothing before it.
__device__ __forceinline__ void pdl_begin() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The batch of gather_rowsum_coop for G lanes a row and K float4s a lane
// a row: P rows side by side, U row passes, B = U P rows (at most 32, one
// lane each for the batch's indices and sums).
template <int G, int K>
struct CoopShape {
  static constexpr int P = 32 / G;
  static constexpr int U_WANT = (G == 32 ? ROWSUM_LOADS : ROWSUM_LOADS_NARROW) / K;
  static constexpr int U = U_WANT < 1 ? 1 : (U_WANT > G ? G : U_WANT);
  static constexpr int B = U * P;
};

template <int G, int K>
__global__ void __launch_bounds__(ROWSUM_THREADS)
    rowsum_coop_kernel(const float4 *__restrict__ table, const int32_t *__restrict__ idx,
                       float *__restrict__ out, int n, int w4) {
  using S = CoopShape<G, K>;
  constexpr int P = S::P, U = S::U, B = S::B;
  pdl_begin();
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);  // lane within its row's group
  const int grp = lane / G;        // the group: row u * P + grp of pass u
  const int64_t warps = (int64_t)gridDim.x * COOP_WARPS;
  const int64_t batches = ((int64_t)n + B - 1) / B;
  int64_t b = (int64_t)blockIdx.x * COOP_WARPS + threadIdx.x / 32;
  // lane l holds the index of the batch's row l; b is warp-uniform, so every
  // shuffle below runs with the whole warp
  int id = 0;
  if (b < batches && lane < B && b * B + lane < n) id = __ldg(idx + b * B + lane);
  for (; b < batches; b += warps) {
    const int64_t base = b * B;
    const int64_t next = (b + warps) * B + lane;
    int id_next = 0;
    if (b + warps < batches && lane < B && next < n) id_next = __ldg(idx + next);
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = 0.0f;
    for (int c0 = 0; c0 < w4; c0 += G * K) {  // one chunk unless G = 32, w4 > 64
      float4 v[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = u * P + grp;
        const float4 *row = table + (int64_t)__shfl_sync(FULL, id, r) * w4;
        const bool live = base + r < n;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int q = c0 + sub + k * G;
          v[u][k] = (live && q < w4) ? __ldg(row + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) s[u] += (v[u][k].x + v[u][k].y) + (v[u][k].z + v[u][k].w);
    }
    // every lane of a group ends with its row's sum; lane l then takes row
    // l = u * P + p from the first lane of group p
    float res = 0.0f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) s[u] += __shfl_xor_sync(FULL, s[u], off);
      const float t = __shfl_sync(FULL, s[u], (lane % P) * G);
      if (lane / P == u) res = t;
    }
    if (lane < B && base + lane < n) out[base + lane] = res;
    id = id_next;
  }
}

// The passes of gather_rowsum_persistent a thread holds at once, for G
// lanes a row and K float4s a lane a row.
template <int G, int K>
struct PersistShape {
  static constexpr int U_WANT = (G == 32 ? PERSIST_LOADS : PERSIST_LOADS_NARROW) / K;
  static constexpr int U = U_WANT < 1 ? 1 : U_WANT;
};

// The indices of passes p .. p + U - 1 of a thread whose first row is row0
// (0 past the pool).
template <int U>
__device__ __forceinline__ void persist_ids(const int32_t *__restrict__ idx, int n,
                                            int64_t row0, int64_t step, int p, int (&id)[U]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t r = row0 + (int64_t)(p + u) * step;
    id[u] = r < n ? __ldg(idx + r) : 0;
  }
}

// Pass p of thread t (of the grid's T threads) takes lane t % G of row
// (p T + t) / G; `passes` is fixed at launch, and the loop over groups of U
// passes is grid-uniform, so every shuffle runs with the whole warp.
template <int G, int K>
__global__ void __launch_bounds__(PERSIST_THREADS, 2048 / PERSIST_THREADS)
    rowsum_persistent_kernel(const float4 *__restrict__ table,
                             const int32_t *__restrict__ idx, float *__restrict__ out,
                             int n, int w4, int passes) {
  constexpr int U = PersistShape<G, K>::U;
  pdl_begin();
  const int sub = threadIdx.x & (G - 1);
  const int64_t step = (int64_t)gridDim.x * (PERSIST_THREADS / G);  // rows of a pass
  const int64_t row0 = ((int64_t)blockIdx.x * PERSIST_THREADS + threadIdx.x) / G;
  int id[U];
  persist_ids<U>(idx, n, row0, step, 0, id);
  for (int p0 = 0; p0 < passes; p0 += U) {
    int id_next[U];  // the next group's, in flight with this group's rows
    persist_ids<U>(idx, n, row0, step, p0 + U, id_next);
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = 0.0f;
    for (int c0 = 0; c0 < w4; c0 += G * K) {  // one chunk unless G = 32, w4 > 64
      float4 v[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool live = row0 + (int64_t)(p0 + u) * step < n;
        const float4 *row = table + (int64_t)id[u] * w4;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int q = c0 + sub + k * G;
          v[u][k] = (live && q < w4) ? __ldg(row + q) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) s[u] += (v[u][k].x + v[u][k].y) + (v[u][k].z + v[u][k].w);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) s[u] += __shfl_xor_sync(FULL, s[u], off);
      const int64_t r = row0 + (int64_t)(p0 + u) * step;
      if (sub == 0 && r < n) out[r] = s[u];
      id[u] = id_next[u];
    }
  }
}

// The walk of gather_rowsum_rowloop for G lanes a row and K float4s a lane
// a row: P rows a step, D items (a step's chunk of G K float4s a row) in
// flight behind the one being summed, a ring of R = D + 1 register slots,
// Q steps to a coalesced store of 32 sums.  A row wider than one chunk
// (WIDE: G = 32, K = 2, more than 64 float4s) takes several items.
template <int G, int K>
struct LoopShape {
  static constexpr int P = 32 / G;
  static constexpr int D_WANT = (G == 32 ? ROWLOOP_LOADS : ROWLOOP_LOADS_NARROW) / K;
  static constexpr int D = D_WANT < 1 ? 1 : D_WANT;
  static constexpr int R = D + 1;
  static constexpr int Q = 32 / P;
};

// Warp w walks steps [s0, s1) = [w run, w run + run) of the pool, P rows a
// step, item by item: item i is chunk i % chunks of step s0 + i / chunks
// (one item a step unless WIDE).  Each item: the row load of item i + D
// issued into the ring slot item i - 1 freed, the index of item i + D + R
// (the next to use that slot) loaded into the slot's index register, then
// item i's adds; at a step's last chunk the G lanes' partial sums reduce
// by shuffles and lane q of group p keeps row q P + p of the 32
// consecutive rows of Q = G steps (step q of the Q), and every Q steps
// (and at the run's end) the 32 sums go out in one coalesced store.  A lane's live items are those before m (its group's
// row below N, the step inside the run): past them it loads nothing.  The
// walk is warp-uniform, so every shuffle runs with the whole warp; its
// counters are 32-bit (N < 2^31), which keeps the kernel within the
// registers of ROWLOOP_MIN_BLOCKS blocks an SM.
template <int G, int K, bool WIDE>
__global__ void __launch_bounds__(ROWLOOP_THREADS, ROWLOOP_MIN_BLOCKS)
    rowsum_rowloop_kernel(const float4 *__restrict__ table, const int32_t *__restrict__ idx,
                          float *__restrict__ out, int n, int w4, int chunks, int run) {
  using S = LoopShape<G, K>;
  constexpr int P = S::P, D = S::D, R = S::R, Q = S::Q;
  pdl_begin();
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);  // lane within its row's group
  const int grp = lane / G;        // the group: row s P + grp of step s
  const int steps = (int)(((int64_t)n + P - 1) / P);
  const int64_t first = ((int64_t)blockIdx.x * ROWLOOP_WARPS + threadIdx.x / 32) * run;
  if (first >= steps) return;  // warp-uniform
  const int s0 = (int)first;
  const int len = (s0 + run < steps ? s0 + run : steps) - s0;  // steps of the run
  const int per = WIDE ? chunks : 1;                            // items a step
  const int items = len * per;
  // the run's steps whose row this lane's group holds (s P + grp < N)
  const int own = (n - grp + P - 1) / P - s0;
  const int m = (own < len ? own : len) * per;
  const int32_t *ip = idx + s0 * P + grp;  // this lane's index at the run's first step
  const float4 *tp = table + sub;
  auto index = [&](int i) { return i < m ? __ldg(ip + (WIDE ? i / chunks : i) * P) : 0; };
  auto load = [&](int i, int id, float4 (&v)[K]) {
    const int c = WIDE ? i % chunks * (G * K) : 0;  // the chunk's first float4
    const float4 *row = tp + (int64_t)id * w4 + c;
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] = (i < m && c + sub + k * G < w4) ? __ldg(row + k * G)
                                             : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 v[R][K];
  int id[R];
  // the prologue: the indices of items 0 .. D, the rows of items 0 .. D-1
  // in flight, slot j's index register then holding item j + R's
#pragma unroll
  for (int j = 0; j <= D; ++j) id[j] = j < items ? index(j) : 0;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (j < items) load(j, id[j], v[j]);
    if (j + R < items) id[j] = index(j + R);
  }
  float acc = 0.0f, res = 0.0f;
  for (int t = 0; t < items; t += R) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int i = t + j;
      if (i >= items) break;
      const int ahead = (j + D) % R;  // the slot item i - 1 freed
      if (i + D < items) load(i + D, id[ahead], v[ahead]);
      if (i + D + R < items) id[ahead] = index(i + D + R);
#pragma unroll
      for (int k = 0; k < K; ++k) acc += (v[j][k].x + v[j][k].y) + (v[j][k].z + v[j][k].w);
      if (!WIDE || i % chunks == chunks - 1) {
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
        // step q of a store's Q = G steps: lane q of group p keeps row q P + p
        const int s = WIDE ? i / chunks : i;  // the step within the run
        const int q = s % Q;
        if (sub == q) res = acc;
        if (q == Q - 1 || s == len - 1) {
          const int r = (s0 + s - q + sub) * P + grp;
          if (sub <= q && r < n) out[r] = res;
        }
        acc = 0.0f;
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void *smem_dst, const void *gmem_src) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}


__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes visible to the async proxy (the
// bulk copies).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from shared to global memory, in its own bulk group.
__device__ __forceinline__ void bulk_store(void *gmem, const void *smem, unsigned bytes) {
  const unsigned src = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(gmem),
      "r"(src), "r"(bytes)
      : "memory");
}

// Wait until at most N of this thread's bulk groups are still reading
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The rows of tile t: rows [t T, t T + T) of the pool, T = `tile`, cut at N.
__device__ __forceinline__ int smem_rows(int n, int tile, int64_t t) {
  const int64_t left = (int64_t)n - t * tile;
  return (int)(left < tile ? left : tile);
}

// Lane l's share of tile t's indices: row l's (0 past the tile).
__device__ __forceinline__ int smem_id(const int32_t *__restrict__ idx, int n, int tile,
                                       int64_t t, int64_t tiles, int lane) {
  return t < tiles && lane < smem_rows(n, tile, t) ? __ldg(idx + t * tile + lane) : 0;
}

// Start the copies of tile t's rows into the warp's `stage` as one cp.async
// group: G lanes a row and P rows side by side, as the sum reads them, lane
// sub of a row's group copying its float4s q = sub, sub + G, ... to
// stage[r w4 + q] (the rows dense at pitch w4); row r's index comes from
// lane r's `id`.  The group is committed, empty, past the last tile too, so
// that each step of the kernel's loop commits one.
template <int G>
__device__ __forceinline__ void smem_fill(float4 *stage, const float4 *__restrict__ table,
                                          int n, int w4, int tile, int64_t t, int64_t tiles,
                                          int id, int lane) {
  if (t < tiles) {  // warp-uniform: the shuffles run with the whole warp
    const int rows = smem_rows(n, tile, t);
    const int sub = lane & (G - 1);
    for (int rb = 0; rb < rows; rb += 32 / G) {
      const int r = rb + lane / G;
      const int64_t row = __shfl_sync(FULL, id, r < 32 ? r : 31);
      if (r < rows)
        for (int q = sub; q < w4; q += G) cp_async16(stage + r * w4 + q, table + row * w4 + q);
    }
  }
  cp_async_commit();
}

// Tile t by warp t % (the grid's warps), the warp's k-th tile in its stage
// k % 2.  Each step: the next tile's copies started (its indices loaded a
// step before), the indices of the one after loaded, this tile's copies
// waited for, its rows summed by groups of G lanes, P rows side by side,
// lane l left with row l's sum, and the tile's sums stored at once.  Only
// the warp synchronises.
template <int G>
__global__ void __launch_bounds__(SMEM_THREADS)
    rowsum_smem_kernel(const float4 *__restrict__ table, const int32_t *__restrict__ idx,
                       float *__restrict__ out, int n, int w4, int tile) {
  extern __shared__ __align__(16) float4 smem_stages[];  // two stages a warp
  constexpr int P = 32 / G;
  pdl_begin();
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);  // lane within its row's group
  const int grp = lane / G;        // the group: row rb + grp of a pass rb
  float4 *stages = smem_stages + (threadIdx.x / 32) * 2 * SMEM_STAGE_F4;
  const int64_t warps = (int64_t)gridDim.x * SMEM_WARPS;
  const int64_t tiles = ((int64_t)n + tile - 1) / tile;
  int64_t t = (int64_t)blockIdx.x * SMEM_WARPS + threadIdx.x / 32;
  int id = smem_id(idx, n, tile, t, tiles, lane);
  smem_fill<G>(stages, table, n, w4, tile, t, tiles, id, lane);
  id = smem_id(idx, n, tile, t + warps, tiles, lane);
  for (int k = 0; t < tiles; t += warps, ++k) {  // warp-uniform
    const float4 *stage = stages + (k & 1) * SMEM_STAGE_F4;
    smem_fill<G>(stages + ((k + 1) & 1) * SMEM_STAGE_F4, table, n, w4, tile, t + warps, tiles,
                 id, lane);
    id = smem_id(idx, n, tile, t + 2 * warps, tiles, lane);
    cp_async_wait_group<1>();  // this lane's copies of tile t have landed
    __syncwarp();              // and every lane's
    const int rows = smem_rows(n, tile, t);
    float res = 0.0f;
    for (int rb = 0; rb < rows; rb += P) {
      const int r = rb + grp;
      float s = 0.0f;
      if (r < rows) {
        for (int q = sub; q < w4; q += G) {
          const float4 v = stage[r * w4 + q];
          s += (v.x + v.y) + (v.z + v.w);
        }
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      // row rb + p sits with lane p G
      const float v = __shfl_sync(FULL, s, (lane % P) * G);
      if (lane / P == rb / P) res = v;
    }
    if (lane < rows) out[t * tile + lane] = res;
    __syncwarp();  // every lane is done with the stage the next step refills
  }
}

// Tiles of `tile_rows` consecutive output rows, tile t by CTA t % grid, the
// CTA's k-th tile in stage k % COPY_STAGES.
__global__ void __launch_bounds__(THREADS)
    row_copy_kernel(const float4 *__restrict__ table, const int32_t *__restrict__ idx,
                    float4 *__restrict__ out, int n, int w4, int tile_rows) {
  extern __shared__ __align__(128) float4 stages[];
  constexpr int STAGE_F4 = COPY_STAGE_BYTES / (int)sizeof(float4);
  pdl_begin();
  const int64_t tiles = ((int64_t)n + tile_rows - 1) / tile_rows;
  int k = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, ++k) {
    float4 *stage = stages + (k % COPY_STAGES) * STAGE_F4;
    const int64_t r0 = t * tile_rows;
    const int count = (int)(n - r0 < tile_rows ? n - r0 : tile_rows) * w4;
    // the bulk copy that read this stage COPY_STAGES tiles ago is done reading
    if (threadIdx.x == 0) bulk_wait_read<COPY_STAGES - 1>();
    __syncthreads();
    for (int e = threadIdx.x; e < count; e += THREADS) {
      const int r = e / w4;
      cp_async16(stage + e, table + (int64_t)__ldg(idx + r0 + r) * w4 + (e - r * w4));
    }
    cp_async_wait_all();
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) bulk_store(out + r0 * w4, stage, (unsigned)count * sizeof(float4));
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// The group width of coop/persistent: the largest power of two that is at
// most 32 and at most w4.
int group_for(int w4) {
  int g = 1;
  while (g < 32 && 2 * g <= w4) g *= 2;
  return g;
}

int sm_count() {
  static int count[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev >= MAX_DEVICES) return -(int)cudaErrorInvalidDevice;
  if (count[dev] == 0) {
    cudaDeviceProp prop;
    err = cudaGetDeviceProperties(&prop, dev);
    if (err != cudaSuccess) return -(int)err;
    count[dev] = prop.multiProcessorCount;
  }
  return count[dev];
}

// The blocks of a one-wave persistent launch of `kernel` (blocks of
// `threads`, `smem` bytes of dynamic shared memory): `wanted`, at most what
// the card holds at once, SM count x resident blocks (*per_sm, found once);
// a CUDA error as a negative number.
template <typename Kernel>
int64_t wave_blocks(Kernel kernel, int threads, int *per_sm, size_t smem, int64_t wanted) {
  if (*per_sm == 0) {
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return -(int64_t)err;
  }
  const int sms = sm_count();
  if (sms < 0) return sms;
  const int64_t most = (int64_t)sms * *per_sm;
  return wanted < most ? wanted : most;
}

// Launch `kernel` on `grid` blocks of `threads` with programmatic stream
// serialization: its blocks may be scheduled while the stream's previous
// launch drains (they wait in pdl_begin).  Returns the CUDA error.
template <typename... Params, typename... Args>
int launch_pdl(void (*kernel)(Params...), int64_t grid, int threads, size_t smem,
               cudaStream_t stream, Args... args) {
  if (grid <= 0) return grid < 0 ? (int)-grid : (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int G, int K>
int launch_coop(void **ptrs, int n, int w4, cudaStream_t stream) {
  static int per_sm = 0;
  const int64_t batches = ((int64_t)n + CoopShape<G, K>::B - 1) / CoopShape<G, K>::B;
  const int64_t grid = wave_blocks(rowsum_coop_kernel<G, K>, ROWSUM_THREADS, &per_sm, 0,
                                   (batches + COOP_WARPS - 1) / COOP_WARPS);
  return launch_pdl(rowsum_coop_kernel<G, K>, grid, ROWSUM_THREADS, 0, stream,
                    (const float4 *)ptrs[0], (const int32_t *)ptrs[1], (float *)ptrs[2], n, w4);
}

int dispatch_coop(void **ptrs, const double *scal, int n, void *stream) {
  const int w4 = (int)scal[0] / 4;
  if (n <= 0) return (int)cudaGetLastError();
  if (w4 <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // K = 2 where w4 is not a power of two below 64 (w4 < 2 G then), or for
  // G = 32 chunks of 64 float4s
#define COOP_CASE(G) \
  case G: return w4 > G ? launch_coop<G, 2>(ptrs, n, w4, st) : launch_coop<G, 1>(ptrs, n, w4, st)
  switch (group_for(w4)) {
    COOP_CASE(1);
    COOP_CASE(2);
    COOP_CASE(4);
    COOP_CASE(8);
    COOP_CASE(16);
    default: return w4 > 32 ? launch_coop<32, 2>(ptrs, n, w4, st) : launch_coop<32, 1>(ptrs, n, w4, st);
  }
#undef COOP_CASE
}

// The persistent kernel's one-wave grid for `wanted` blocks (resident
// blocks of this instance on one SM found once); a CUDA error as a
// negative number.
template <int G, int K>
int64_t persistent_grid(int64_t wanted) {
  static int per_sm = 0;
  return wave_blocks(rowsum_persistent_kernel<G, K>, PERSIST_THREADS, &per_sm, 0, wanted);
}

// No more blocks than the (row, lane) pairs fill; the passes follow.
template <int G, int K>
int launch_persistent(void **ptrs, int n, int w4, cudaStream_t stream) {
  const int64_t grid =
      persistent_grid<G, K>(((int64_t)n * G + PERSIST_THREADS - 1) / PERSIST_THREADS);
  const int64_t step = grid * (PERSIST_THREADS / G);
  const int passes = grid > 0 ? (int)((n + step - 1) / step) : 0;
  return launch_pdl(rowsum_persistent_kernel<G, K>, grid, PERSIST_THREADS, 0, stream,
                    (const float4 *)ptrs[0], (const int32_t *)ptrs[1], (float *)ptrs[2], n, w4,
                    passes);
}

// The rows of one pass of the whole wave.
template <int G, int K>
int pass_rows() {
  const int64_t grid = persistent_grid<G, K>(INT64_MAX);
  return grid < 0 ? (int)grid : (int)(grid * (PERSIST_THREADS / G));
}

// The (G, K) instance of persistent and rowloop for w4 float4s a row: G
// as coop's, K as coop's, 2 where w4 is not a power of two below 64, or for
// G = 32 chunks of 64 float4s.
#define GROUP_SWITCH(CALL)                               \
  switch (group_for(w4)) {                               \
    case 1: return CALL(1, 1);                           \
    case 2: return w4 > 2 ? CALL(2, 2) : CALL(2, 1);     \
    case 4: return w4 > 4 ? CALL(4, 2) : CALL(4, 1);     \
    case 8: return w4 > 8 ? CALL(8, 2) : CALL(8, 1);     \
    case 16: return w4 > 16 ? CALL(16, 2) : CALL(16, 1); \
    default: return w4 > 32 ? CALL(32, 2) : CALL(32, 1); \
  }

int dispatch_persistent(void **ptrs, const double *scal, int n, void *stream) {
  const int w4 = (int)scal[0] / 4;
  if (n <= 0) return (int)cudaGetLastError();
  if (w4 <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(G, K) launch_persistent<G, K>(ptrs, n, w4, st)
  GROUP_SWITCH(LAUNCH)
#undef LAUNCH
}

int persistent_pass_rows(int w) {
  const int w4 = w / 4;
  if (w4 <= 0) return -(int)cudaErrorInvalidValue;
#define PASS(G, K) pass_rows<G, K>()
  GROUP_SWITCH(PASS)
#undef PASS
}

// The rowloop kernel's one-wave grid for `wanted` blocks (resident blocks
// of this instance on one SM found once); a CUDA error as a negative number.
template <int G, int K, bool WIDE>
int64_t rowloop_grid(int64_t wanted) {
  static int per_sm = 0;
  return wave_blocks(rowsum_rowloop_kernel<G, K, WIDE>, ROWLOOP_THREADS, &per_sm, 0, wanted);
}

// No more warps than the steps fill; each walks a run of ceil(steps / warps)
// consecutive steps.
template <int G, int K, bool WIDE>
int launch_rowloop_as(void **ptrs, int n, int w4, cudaStream_t stream) {
  constexpr int P = LoopShape<G, K>::P;
  const int64_t steps = ((int64_t)n + P - 1) / P;
  const int64_t grid = rowloop_grid<G, K, WIDE>((steps + ROWLOOP_WARPS - 1) / ROWLOOP_WARPS);
  if (grid <= 0) return grid < 0 ? (int)-grid : (int)cudaErrorInvalidConfiguration;
  const int64_t warps = grid * ROWLOOP_WARPS;
  const int64_t run = (steps + warps - 1) / warps;
  const int64_t chunks = (w4 + G * K - 1) / (G * K);
  if (run * chunks > INT32_MAX) return (int)cudaErrorInvalidValue;  // 32-bit walk
  return launch_pdl(rowsum_rowloop_kernel<G, K, WIDE>, grid, ROWLOOP_THREADS, 0, stream,
                    (const float4 *)ptrs[0], (const int32_t *)ptrs[1], (float *)ptrs[2], n, w4,
                    (int)chunks, (int)run);
}

// A row takes several chunks (items) only at G = 32, K = 2 and more than
// 64 float4s.
template <int G, int K>
int launch_rowloop(void **ptrs, int n, int w4, cudaStream_t stream) {
  if constexpr (G == 32 && K == 2)
    if (w4 > G * K) return launch_rowloop_as<G, K, true>(ptrs, n, w4, stream);
  return launch_rowloop_as<G, K, false>(ptrs, n, w4, stream);
}

// The rows of a whole wave's warps, one step each.
template <int G, int K>
int wave_rows(int w4) {
  int64_t grid = 0;
  if constexpr (G == 32 && K == 2)
    if (w4 > G * K) grid = rowloop_grid<G, K, true>(INT64_MAX);
  if (grid == 0) grid = rowloop_grid<G, K, false>(INT64_MAX);
  return grid < 0 ? (int)grid : (int)(grid * ROWLOOP_WARPS * LoopShape<G, K>::P);
}

int dispatch_rowloop(void **ptrs, const double *scal, int n, void *stream) {
  const int w4 = (int)scal[0] / 4;
  if (n <= 0) return (int)cudaGetLastError();
  if (w4 <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(G, K) launch_rowloop<G, K>(ptrs, n, w4, st)
  GROUP_SWITCH(LAUNCH)
#undef LAUNCH
}

int rowloop_wave_rows(int w) {
  const int w4 = w / 4;
  if (w4 <= 0) return -(int)cudaErrorInvalidValue;
#define ROWS(G, K) wave_rows<G, K>(w4)
  GROUP_SWITCH(ROWS)
#undef ROWS
}
#undef GROUP_SWITCH

template <int G>
int launch_smem(void **ptrs, int n, int w4, int tile, cudaStream_t stream) {
  static int per_sm = 0;
  constexpr size_t smem = (size_t)SMEM_WARPS * 2 * SMEM_STAGE_F4 * sizeof(float4);
  if (per_sm == 0 && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rowsum_smem_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t tiles = ((int64_t)n + tile - 1) / tile;
  const int64_t grid = wave_blocks(rowsum_smem_kernel<G>, SMEM_THREADS, &per_sm, smem,
                                   (tiles + SMEM_WARPS - 1) / SMEM_WARPS);
  return launch_pdl(rowsum_smem_kernel<G>, grid, SMEM_THREADS, smem, stream,
                    (const float4 *)ptrs[0], (const int32_t *)ptrs[1], (float *)ptrs[2], n, w4,
                    tile);
}

int dispatch_smem(void **ptrs, const double *scal, int n, void *stream) {
  const int w4 = (int)scal[0] / 4;
  const int tile = (int)scal[1];
  if (n <= 0) return (int)cudaGetLastError();
  if (w4 <= 0 || tile <= 0 || tile > 32 || (int64_t)tile * w4 > SMEM_STAGE_F4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group_for(w4)) {
    case 1: return launch_smem<1>(ptrs, n, w4, tile, st);
    case 2: return launch_smem<2>(ptrs, n, w4, tile, st);
    case 4: return launch_smem<4>(ptrs, n, w4, tile, st);
    case 8: return launch_smem<8>(ptrs, n, w4, tile, st);
    case 16: return launch_smem<16>(ptrs, n, w4, tile, st);
    default: return launch_smem<32>(ptrs, n, w4, tile, st);
  }
}

}  // namespace

extern "C" {

int gather_rowsum_coop_nptrs() { return 3; }
int gather_rowsum_coop_nscal() { return 1; }
int gather_rowsum_coop_launch(void **ptrs, const double *scal, int n, void *stream) {
  return dispatch_coop(ptrs, scal, n, stream);
}

int gather_rowsum_persistent_nptrs() { return 3; }
int gather_rowsum_persistent_nscal() { return 1; }
int gather_rowsum_persistent_launch(void **ptrs, const double *scal, int n, void *stream) {
  return dispatch_persistent(ptrs, scal, n, stream);
}
// The rows one pass of the persistent kernel covers at row width w on the
// current device, or a CUDA error as a negative number.
int gather_rowsum_persistent_pass_rows(int w) { return persistent_pass_rows(w); }

int gather_rowsum_rowloop_nptrs() { return 3; }
int gather_rowsum_rowloop_nscal() { return 1; }
int gather_rowsum_rowloop_launch(void **ptrs, const double *scal, int n, void *stream) {
  return dispatch_rowloop(ptrs, scal, n, stream);
}
// The rows one wave of the rowloop kernel covers with one step a warp at
// row width w on the current device, or a CUDA error as a negative number.
int gather_rowsum_rowloop_wave_rows(int w) { return rowloop_wave_rows(w); }

int gather_rowsum_smem_nptrs() { return 3; }
int gather_rowsum_smem_nscal() { return 2; }
int gather_rowsum_smem_launch(void **ptrs, const double *scal, int n, void *stream) {
  return dispatch_smem(ptrs, scal, n, stream);
}

int row_gather_rowloop_nptrs() { return 3; }
int row_gather_rowloop_nscal() { return 1; }
int row_gather_rowloop_launch(void **ptrs, const double *scal, int n, void *stream) {
  const int w4 = (int)scal[0] / 4;
  if (n <= 0) return (int)cudaGetLastError();
  // a row must fit a stage: w up to COPY_STAGE_BYTES / 4 = 2,048 floats
  if (w4 <= 0 || w4 * (int)sizeof(float4) > COPY_STAGE_BYTES) return (int)cudaErrorInvalidValue;
  const int tile_rows = COPY_STAGE_BYTES / (w4 * (int)sizeof(float4));
  const size_t smem = (size_t)COPY_STAGES * COPY_STAGE_BYTES;
  static int per_sm = 0;
  const int64_t grid = wave_blocks(row_copy_kernel, THREADS, &per_sm, smem,
                                   ((int64_t)n + tile_rows - 1) / tile_rows);
  return launch_pdl(row_copy_kernel, grid, THREADS, smem, (cudaStream_t)stream,
                    (const float4 *)ptrs[0], (const int32_t *)ptrs[1], (float4 *)ptrs[2], n, w4,
                    tile_rows);
}

}  // extern "C"
