// The hot step of the transport engine, one hand-written kernel for Hopper
// (sm_90a): hot_step_kernel<kRef, T, G, THREADS, kDraw>, G threads per
// photon lane in blocks of THREADS, computing engine.hot_step_plain in float
// (T = float) or double (T = double).
//
// It replaces the Pallas kernels grmonty_tpu/transport/hotstep_pallas.py:104
// `kernel_a` (body engine.hot_phase_a) and hotstep_pallas.py:152 `kernel_b`
// (body engine.hot_phase_b), and under reference semantics the corner-row
// gather between them (grmonty_tpu/ops/gather.py:63 `_gather_kernel`).  In
// one launch each lane runs:
//   1. phase A: the step size, one implicit-midpoint Kerr push with the
//      closed-form 40-term connection and FP_ITERS fixed-point rounds, the
//      commit gate, the step control (kRef: the halve/double ladder; else
//      the error-proportional control and the grown-step optical-depth
//      cap), the pend/arrival bookkeeping, the stop test with Russian
//      roulette and the bilinear cell z;
//   2. the corner row at z: 44 derived values from hot_tab, or (kRef) 32
//      raw values from corner_rows;
//   3. phase B: the blend (raw rows through the metric pair), nu, the sin
//      pitch angle, the Chebyshev hotcross alpha_scatt, the Kirchhoff
//      alpha_abs with the Chebyshev K2, dtau, the biased scatter decision
//      with rollback, the weight decay, the step count and stall kill, and
//      (shipped) the vacuum-to-matter entry rollback of grown steps;
//   4. the epilogue: (shipped) the dl_shrink clamp and the detached-event
//      capture (engine._capture_events); the lane-slot census and the
//      hotcross clamp count as warp ballots, a block sum and one 64-bit
//      integer atomic per counter and block, exact in any order.
// A launch runs a lane's `steps` steps (the JAX engine's lax.fori_loop over
// hot_step, grmonty_tpu/transport/engine.py:2536): the lane loads its state
// once, holds it across the steps (registers; in double also the warp's
// LaneSlots for the connection), and the first thread of its group stores
// it once.  Every load comes before every store and no field is read
// through the non-coherent path, so the post-step pool may be the pre-step
// pool's own tensors: the drawing instances run in place, a block's run of
// hot steps one launch (hot_kernels.hot_run); the explicit instances run
// one step into new tensors (hot_kernels.hot_step).  The census ballots
// are summed over the steps and added once a launch, ls_iters by the steps
// and ls_slots by the steps times n: the integers a launch a step adds.
//
// The step's two uniforms, the roulette's u_roul and the optical depth's
// u_x1: the instance kDraw = false reads them from the caller's (N,)
// tensors; kDraw = true (the engine's block on the card) draws them itself,
// slots 0 and 1 of the lane's Philox4x64-10 block at the counter (lane,
// S_HOT, step, 0) under the block's key (physics.cuh's philox; each word
// made a uniform as torch.rand makes one, unif), so that a run of a block's
// hot steps is one launch.  The key is two int64 words the engine draws
// from the run's generator once a block (hot_kernels.draw_key), the step
// the iteration's index in the block: the run's first step a launch scalar,
// then one more a step; ops/draws.py hot_uniforms is the plain version of
// the draws.  Every thread of a lane's group computes the
// same block.  The drawing costs one Philox block a lane, about 260 integer
// instructions, drawn at the stop test so that only u_x1 is held through
// the row fetch and phase B: measured within a microsecond of the explicit
// instance at every width, with no new spills (PERF.md).
//
// Float.  What bounds it on an H100 80GB HBM3 at 700 W.  At the pool's
// 65,536 lanes (one thread a lane: 2,048 warps, 15.5 an SM, one wave
// filling a quarter of the warp slots) a lane moves about 370 B (shipped) or
// 270 B (reference), rows included: 7.3 and 5.3 us at 3.35 TB/s; it issues
// about 3,800 float32 operations, each multiply and add on its own under
// -fmad=false, 7.4 us at the 33.5 T instructions/s of the float32 pipes;
// the launch is bound by issue and latency at that occupancy.  A narrow
// launch (the cascade's 512 and 4,096 lanes, the gate's 1,024) is one lane's
// chain: at one thread a lane in 256-thread blocks 512 lanes ran on 2 of the
// 132 SMs in 17.6 us (shipped) and 14.9 (reference), one lane alone in 16.1
// / 13.8, and a clock64 breakdown (tools/clock_hot_step.py) put 37% / 30%
// of a warp's cycles in the lane's hotcross sum and 15% (shipped) in the
// epilogue's stores, the capture's input loads each behind a store that
// may alias it.  What the design does:
//   1. The launch follows the pool (hot_shape): up to 4,096 lanes eight
//      threads a lane, up to 16,384 two, in 128-thread blocks spread over
//      the SMs; beyond, one thread a lane in 256-thread blocks, at most 128
//      registers (__launch_bounds__(256, 2)), the pool in one wave.
//   2. A lane's group splits the hotcross sum in its variant's own order,
//      the same bits: the reference variant's columns (hotcross_cols), the
//      shipped variant's rows (hotcross_rows, the rows staged 36 values
//      apart); the warp fetches its 32 / G lanes' corner rows alone.
//   3. The surface (41 rows, 16-byte broadcast loads at one thread a lane)
//      is copied by cp.async behind the lane's loads and phase A, and a
//      warp waits on the barrier only just before the hotcross sum.
//   4. Metric row 0 and (reference) the metric pair reuse the connection's
//      transcendentals.
//   5. One launch for the three TPU kernels, the warp fetching its corner
//      rows through a shared-memory stage at an odd pitch, and the
//      epilogue's ~25 torch launches inside.
//   6. A run of steps a launch: the lane's loads and stores once a run, no
//      launch or graph node between its steps.
// Measured (PERF.md, same card, in turns with the previous kernel, the same
// bits), the drawing instance a step: 17.8 -> 9.6 us (shipped) and 15.0 ->
// 9.7 (reference) at 512 lanes, 17.9 -> 10.8 and 15.1 -> 10.9 at 4,096,
// 24.0 -> 22.0 and 20.6 -> 19.2 at 65,536; at 512 lanes a warp's chain is
// 14,700 cycles (31,200 before), no segment of it above 17%.  In a run of
// 64 steps: 5.7 us a step at 512 lanes, 6.3 at 4,096, 16.3 / 14.2
// at 65,536; the held state costs the one-thread-a-lane shipped instance
// 16 bytes of spill at its 128 registers, and one step alone 23.4 / 19.9 us
// there.
//
// Double.  What bounds it (same card): a lane moves twice the bytes (14.1
// and 10.2 us at 65,536 lanes) and its chain of dependent double
// operations, transcendentals and divisions is long: one lane alone takes
// about 12 us (a 1-lane launch, 15 us with the launch).  A clock64
// breakdown (tools/clock_hot_step.py) of the float64 kernel before this
// design (one warp at 512 lanes, 41,500 cycles) put 16,900 cycles in the
// hotcross sum (41 serial rows of 31 additions in the shipped order), 4,700
// in the shipped epilogue's stores (ten loads each behind a store that may
// alias it), 4,300 in the connection, 4,000 in K2, synch and b_nu and 2,000
// in the surface's staging; and at 206 registers two 128-thread blocks an
// SM ran the pool in two waves.  What the design does:
//   1. The hotcross sum in double is the column form for both variants
//      (u_j = sum_ix T_ix(tx) c[ix, j], then sum_j u_j T_j(ty)).  At one
//      thread a lane the warp computes its 32 lanes' u_j as one matrix
//      product on the FP64 tensor cores (hotcross_mma: 176 m8n8k4 products
//      a warp, its lanes' T_ix(tx) in a swizzled table in shared memory).
//      In narrow pools a lane's group of G = 8 threads splits the columns,
//      4 fused multiply-add chains a thread, its partial sums added by
//      shuffles (hotcross_group).
//   2. The launch follows the pool (hot_shape): up to 2,048 lanes (the
//      cascade's 512, the gate's 1,024) eight threads a lane in 128-thread
//      blocks; up to 32,768 one thread a lane in 64-thread blocks, four or
//      more an SM, the launch spread over the SMs; beyond, 256-thread
//      blocks at two an SM and at most 128 registers, the 65,536 lanes in
//      one wave.  The crossovers were measured (PERF.md).
//   3. Registers at one thread a lane: the connection's 40 terms live in
//      shared memory (LaneSlots), the push forms its midpoint state after
//      the connection, and metric row 0 and (reference) the metric pair
//      reuse the connection's transcendentals.  Held across a run's steps,
//      the lane keeps both its pre-step and its pushed state.
//   4. The surface is copied by cp.async at entry behind phase A; each
//      thread arrives on a shared-memory barrier once its copies land, and
//      a warp waits on it only just before the hotcross sum.
// Measured (PERF.md, same card, in turns with the previous kernel): 42.5 /
// 32.5 us at 65,536 lanes (from 64.8 / 46.4), 15.3 / 14.9 us at 512 (from
// 23.6 / 19.5); at 65,536 lanes the reference variant's hotcross sum is
// 11,600 of a warp's 59,700 cycles, the rest spread over the double
// connection, rounds, metric pair, K2 and synch.  Held across a run's
// steps, the state spills at the 65,536-lane instance's 128
// registers (718 / 494 bytes of stores): one step alone 62.6 / 42.1 us
// there, a step of a run of 64 37.0 / 27.7; a step of a run of 64 at 512
// lanes 9.4 / 9.8.

// Numerics: the arithmetic mirrors the plain torch versions operation by
// operation in the kernel's type T (same association order, constants
// folded in double first where the Python expression folds them, then
// rounded to T; every literal is T(x) and every function the T overload of
// namespace fm, so that the double instantiation has no float step).
// PyTorch on the card divides a tensor by a Python scalar as a multiply by
// the scalar's reciprocal in the tensor's type, and a scalar by a tensor as
// the tensor's reciprocal times the scalar; the kernel uses the same two
// forms (the inv_* constants, read from PyTorch per type), so that phase
// A's rounding matches op for op.  In float the hotcross sum keeps the order
// of each variant (shipped: s_ix = sum_j c[ix, j] T_j(ty), then sum_ix
// T_ix(tx) s_ix; reference: u_j = sum_ix T_ix(tx) c[ix, j] as fused
// multiply-adds, then sum_j u_j T_j(ty)); in double it is reassociated (the
// column form, the tensor cores' or the group's partial sums), which moves
// it by about 1e-16 relative.  The build must not use --use_fast_math: the
// commit gate and the step controller test isfinite(err), which fast math
// folds to true, and flushing denormals would zero the fluid-frame
// frequency of the lowest-energy photons.
//
// Interface: plain C entry points for ctypes, hot_step and hot_step_ref
// (float) and hot_step_f64 and hot_step_ref_f64 (double), and each of them
// with _draw after its name for the instance that draws its uniforms.  Each
// takes an array of device pointers in the order of HotPtrs (the Python
// wrapper in transport/hot_kernels.py lists the same order and checks the
// counts; a drawing entry passes the key in u_roul's place and null in
// u_x1's), an array of double scalars in the order of HotScal (a drawing
// entry then the run's first step and its steps), the lane count and the
// CUDA stream, and returns cudaGetLastError() after the launch; each picks
// its instance from the lane count (hot_shape), and <entry>_group,
// <entry>_threads and <entry>_blocks_per_sm give that instance's shape.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

typedef unsigned char u8;

// the device physics shared with fresh_init.cu and event_fluid.cu: the math
// of the type, the scalars, the connection, the blend, the kinematics, the
// hotcross, K2, synch, B_nu and the bias clamp
#include "physics.cuh"

namespace {

// ---------------------------------------------------------------------------
// phase A: the geodesic push
// ---------------------------------------------------------------------------

// A lane's connection coefficients c[m] in shared memory, at a stride of 32
// values (the warp's lanes side by side, so that a warp's access to one m
// hits every bank once): the double push keeps them there, not in 80
// registers, across its fixed-point rounds.
template <typename T>
struct LaneSlots {
  T *p;
  __device__ __forceinline__ T &operator[](int m) const { return p[m * 32]; }
};

// Where the push keeps its connection: registers (float) or the lane's
// slots in shared memory (double).
template <bool kShared, typename T>
__device__ __forceinline__ auto conn_slots(T *regs, T *slots) {
  if constexpr (kShared)
    return LaneSlots<T>{slots};
  else
    return regs;
}

// Metric row 0 (g00, g01, g03) at the connection's point, from the
// transcendentals it kept there.
template <typename T>
__device__ __forceinline__ void metric_row0(const T *keep, const AConst<T> &CA, T &g00, T &g01,
                                            T &g03) {
  const T eps = T(EPS_D);
  const T r = keep[0] + CA.r_0;
  const T sth = fm::fabs(keep[3]) + eps;
  const T cth = keep[4];
  const T rho2 = r * r + CA.a2 * cth * cth;
  const T tworr = T(2.0) * r / rho2;
  g00 = T(-1.0) + tworr;
  g01 = tworr * (r - CA.r_0);
  g03 = CA.neg_a * sth * sth * tworr;
}

template <typename T>
__device__ __forceinline__ T step_size(T x1, T x2, T k1, T k2, T k3, T x2_stop) {
  const T eps = T(EPS_D), se = T(0.04);
  const T dl1 = se * x1 / (fm::fabs(k1) + eps);
  const T dl2 = se * jmin(x2, x2_stop - x2) / (fm::fabs(k2) + eps);
  const T dl3 = (T(1.0) / (fm::fabs(k3) + eps)) * se;
  return T(1.0) / (T(1.0) / (fm::fabs(dl1) + eps) + T(1.0) / (fm::fabs(dl2) + eps) +
                   T(1.0) / (fm::fabs(dl3) + eps));
}

// ---------------------------------------------------------------------------
// the fused hot step
// ---------------------------------------------------------------------------

// The least blocks an SM of an instance in blocks of THREADS, which caps
// its registers: two of 256 threads (at most 128 registers: float, and
// double at the pool's width, whose 65,536 lanes then run in one wave);
// two of 128 or four of 64 (up to 255: double's narrower pools).
__host__ __device__ constexpr int min_blocks(int threads) { return threads >= 128 ? 2 : 4; }

constexpr unsigned FULL = 0xffffffffu;
// Double stages the surface as HC_ROWS_D rows (three of zeros, so that the
// matrix products' k runs in steps of 4) of HC_PITCH_D values (31, then
// zeros; 36 = 4 mod 16, so that a warp's operand loads hit distinct banks),
// then one unit for the barrier its copies arrive on.
constexpr int HC_ROWS_D = 44, HC_PITCH_D = 36, HC_SURF_UNITS_D = HC_ROWS_D * HC_PITCH_D / 2;
// Float stages it as HC_NX rows of HC_PITCH values (31, then a zero), or of
// HC_PITCH_RF in the shipped variant's row deal over a group (G > 1), then
// the barrier's unit.
constexpr int HC_PITCH_RF = 36;
template <bool kRef, typename T, int G>
__host__ __device__ constexpr int hc_pitch() {
  return sizeof(T) == 8 ? HC_PITCH_D : (!kRef && G > 1) ? HC_PITCH_RF : HC_PITCH;
}
// 16-byte units of the staged surface, and with the barrier's
template <bool kRef, typename T, int G>
__host__ __device__ constexpr int hc_surf_units() {
  return sizeof(T) == 8 ? HC_SURF_UNITS_D : HC_NX * hc_pitch<kRef, T, G>() * (int)sizeof(T) / 16;
}
template <bool kRef, typename T, int G>
__host__ __device__ constexpr int hc_units() {
  return hc_surf_units<kRef, T, G>() + 1;
}

// sigma_hot from the Chebyshev sum acc (double): the Klein-Nishina cold
// limit only on the lanes that take it, the Thomson limit.
__device__ __forceinline__ double hotcross_out(double acc, double w, double te) {
  const double interp = fm::exp(acc * 2.302585092994046);
  double out = interp;
  if (te < 1.0e-4) out = hc_klein_nishina(w) * SIGMA_T_D;
  return (w * te < 1.0e-6) ? SIGMA_T_D : out;
}

// One m8n8k4 product of doubles on the tensor cores, d += a b, a warp's
// fragments (PTX mma.m8n8k4 .f64: a = A[lane / 4][lane % 4], b = B[lane %
// 4][lane / 4], d = D[lane / 4][2 (lane % 4) + 0, 1]).
__device__ __forceinline__ void dmma(double &d0, double &d1, double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d0), "+d"(d1)
               : "d"(a), "d"(b));
}

// The double hotcross at one thread a lane, the warp's 32 lanes together:
// u_j = sum_ix T_ix(tx) c[ix, j] for all of them as one matrix product on
// the tensor cores, U^T (32 columns x 32 lanes) = C^T (32 x 44) T^T (44 x 32
// lanes), in 4 x 4 tiles of 8 x 8 over 11 steps of k = 4: 176 products a
// warp where the lanes' own sums take 1,271 fused multiply-adds each.  Each
// lane writes its T_ix(tx), ix < 44, into its row of `tt` (the warp's
// region, 44 values a lane), the products read them as B (without bank
// conflicts), the staged surface (HC_PITCH_D) as A, and each tile of 8
// lanes' u_j overwrites those lanes' rows once their last B is read; then
// each lane sums u_j T_j(ty) in j order (the reference variant's).
__device__ __forceinline__ double hotcross_mma(double w, double te, const BConst<double> &C,
                                               const double *hs, double *tt, int lane) {
  const double l_w = jclip(fm::log10(jmax(w, 1e-30)), C.hc_xlo, C.hc_xhi);
  const double l_t = jclip(fm::log10(jmax(te, 1e-30)), C.hc_ylo, C.hc_yhi);
  const double tx = (2.0 * l_w - C.hc_xsum) * C.inv_hc_xdiff;
  const double ty = (2.0 * l_t - C.hc_ysum) * C.inv_hc_ydiff;
  double *row = tt + lane * HC_ROWS_D;
  __syncwarp();  // every lane's row read from the stage before the table lands on it
  {
    double tm2 = 1.0, tm1 = tx;
#pragma unroll
    for (int ix = 0; ix < HC_ROWS_D; ++ix) row[ix] = cheb_next(ix, tx, tm1, tm2);
  }
  __syncwarp();
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int nt = 0; nt < 4; ++nt) {  // the tile's lanes: 8 nt + [0, 8)
    double d[4][2] = {};  // tile mt: the columns 8 mt + [0, 8)
#pragma unroll
    for (int ks = 0; ks < HC_ROWS_D / 4; ++ks) {
      const double b = tt[(8 * nt + g) * HC_ROWS_D + 4 * ks + q];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        dmma(d[mt][0], d[mt][1], hs[(4 * ks + q) * HC_PITCH_D + 8 * mt + g], b);
    }
    __syncwarp();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {  // lanes 8 nt + 2 q + (0, 1), column 8 mt + g
      tt[(8 * nt + 2 * q) * HC_ROWS_D + 8 * mt + g] = d[mt][0];
      tt[(8 * nt + 2 * q + 1) * HC_ROWS_D + 8 * mt + g] = d[mt][1];
    }
  }
  __syncwarp();
  double acc = 0.0, bm2 = 1.0, bm1 = ty;
#pragma unroll
  for (int j = 0; j < HC_NY; ++j) acc += row[j] * cheb_next(j, ty, bm1, bm2);
  return hotcross_out(acc, w, te);
}

// The double hotcross at G > 1 threads a lane: u_j = sum_ix T_ix(tx)
// c[ix, j] as one fused multiply-add chain in ix order, then sum_j u_j
// T_j(ty), with the columns split over the lane's group: thread `sub` takes
// the 32 / G columns from sub * 32 / G (the pad column's coefficients are
// zeros), every row's loads in flight at once, and the group's partial sums
// are added by butterfly shuffles in a fixed order, so that every thread of
// the group holds the same total.
template <int G>
__device__ __forceinline__ double hotcross_group(double w, double te, const BConst<double> &C,
                                                 const double2 *hs, int sub) {
  static_assert(G > 1 && HC_PITCH % (2 * G) == 0, "an even share of the columns a thread");
  constexpr int COLS = HC_PITCH / G;
  const double l_w = jclip(fm::log10(jmax(w, 1e-30)), C.hc_xlo, C.hc_xhi);
  const double l_t = jclip(fm::log10(jmax(te, 1e-30)), C.hc_ylo, C.hc_yhi);
  const double tx = (2.0 * l_w - C.hc_xsum) * C.inv_hc_xdiff;
  const double ty = (2.0 * l_t - C.hc_ysum) * C.inv_hc_ydiff;
  double ty_j[COLS], u[COLS];  // T_j(ty) and u_j of this thread's columns
  {
    double bm2 = 1.0, bm1 = ty;
#pragma unroll
    for (int j = 0; j < HC_PITCH; ++j) {
      const double t = cheb_next(j, ty, bm1, bm2);
      if (j / COLS == sub) ty_j[j % COLS] = t;
    }
  }
#pragma unroll
  for (int k = 0; k < COLS; ++k) u[k] = 0.0;
  double tm2 = 1.0, tm1 = tx;
#pragma unroll
  for (int ix = 0; ix < HC_NX; ++ix) {
    const double t = cheb_next(ix, tx, tm1, tm2);
    double c[COLS];
#pragma unroll
    for (int q = 0; q < COLS / 2; ++q)
      Vec16<double>::unpack(hs[ix * (HC_PITCH_D / 2) + sub * (COLS / 2) + q], c + 2 * q);
#pragma unroll
    for (int k = 0; k < COLS; ++k) u[k] = fm::fma_rn(t, c[k], u[k]);
  }
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < COLS; ++k) acc += u[k] * ty_j[k];
#pragma unroll
  for (int s = 1; s < G; s <<= 1) acc += __shfl_xor_sync(FULL, acc, s);
  return hotcross_out(acc, w, te);
}

// A lane's corner row, the W values at table[z * W], into row[], fetched by
// the warp: its rows are staged in shared memory (`stage`, up to 32 rows at
// a pitch of an odd number of 16-byte units), neighbouring threads loading
// one row's units, then each thread reads its own.  At G threads a lane the
// warp holds 32 / G lanes and fetches their rows alone.
template <int W, int G, typename T>
__device__ __forceinline__ void fetch_row(const T *table, int z, int lane,
                                          typename Vec16<T>::type *stage, T *row) {
  using V = typename Vec16<T>::type;
  constexpr int E = Vec16<T>::n, NQ = W / E, PITCH = NQ | 1;
  const V *tab = reinterpret_cast<const V *>(table);
  if constexpr (G == 1) {
#pragma unroll
    for (int it = 0; it < NQ; ++it) {
      const int idx = it * 32 + lane;
      const int r = idx / NQ, q = idx - r * NQ;
      const int zr = __shfl_sync(FULL, z, r);
      stage[r * PITCH + q] = __ldg(tab + (size_t)zr * NQ + q);
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < NQ; ++q) Vec16<T>::unpack(stage[lane * PITCH + q], row + E * q);
  } else {
    constexpr int UNITS = 32 / G * NQ;  // the warp's lanes' rows, in 16-byte units
#pragma unroll
    for (int it = 0; it < (UNITS + 31) / 32; ++it) {
      const int idx = it * 32 + lane;
      const int r = idx / NQ, q = idx - r * NQ;
      const int zr = __shfl_sync(FULL, z, r * G);  // the row of the warp's lane r
      if (UNITS % 32 == 0 || idx < UNITS) stage[r * PITCH + q] = __ldg(tab + (size_t)zr * NQ + q);
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < NQ; ++q) Vec16<T>::unpack(stage[lane / G * PITCH + q], row + E * q);
  }
}

template <typename T>
struct HotPtrs {  // order = hot_kernels._HOT_PTRS
  // the pool the launch reads (a run: the one it writes too)
  const T *x0, *x1, *x2, *x3, *k0, *k1, *k2, *k3, *d0, *d1, *d2, *d3;
  const T *e_0_s, *dl_shrink, *pend_dl;
  const u8 *pend_push, *at_event, *alive;
  const T *w;
  const u8 *record_pending;
  const T *alpha_scatti, *alpha_absi, *bi, *tau_abs, *tau_scatt;
  const u8 *interacting;
  const T *sec_w;
  const int32_t *n_step;
  const u8 *occupied;
  // the step's uniforms (a drawing instance: the key's two words in
  // u_roul's place, u_x1 unused), the bias scale (one value), the corner
  // table and the (41, 31) hotcross surface
  union {
    const T *u_roul;
    const unsigned long long *key;
  };
  const T *u_x1, *bias_scale, *table, *hc;
  // the census counters (int64 scalars), added to in place
  unsigned long long *ls_iters, *ls_slots, *ls_occupied, *ls_moving, *ls_committed,
      *ls_parked, *n_hc_clamp;
  // the pool the launch writes
  T *ox0, *ox1, *ox2, *ox3, *ok0, *ok1, *ok2, *ok3, *od0, *od1, *od2, *od3;
  T *oe_0_s, *odl_shrink, *opend_dl;
  u8 *opend_push, *oat_event, *oalive;
  T *ow;
  u8 *orecord_pending;
  T *oalpha_scatti, *oalpha_absi, *obi, *otau_abs, *otau_scatt;
  u8 *ointeracting;
  T *osec_w;
  int32_t *on_step;
  // the shipped profile only: the detached-event registers in and out, and
  // occupied out (reference semantics pass the pointers before ev_x0)
  const T *ev_x0, *ev_x1, *ev_x2, *ev_x3, *ev_k0, *ev_k1, *ev_k2, *ev_k3, *ev_w;
  const u8 *ev_pending;
  T *oev_x0, *oev_x1, *oev_x2, *oev_x3, *oev_k0, *oev_k1, *oev_k2, *oev_k3, *oev_w;
  u8 *oev_pending, *ooccupied;
};
constexpr int HOT_NPTRS = sizeof(HotPtrs<float>) / sizeof(void *);
constexpr int HOT_REF_NPTRS = offsetof(HotPtrs<float>, ev_x0) / sizeof(void *);
static_assert(sizeof(HotPtrs<double>) == sizeof(HotPtrs<float>), "one pointer layout");


// A warp's region of shared memory after the staged surface, in 16-byte
// units: its 32 row stages (at an odd pitch), in double also the 40
// connection coefficients of its lanes (LaneSlots), which it holds first.
template <bool kRef, typename T>
__host__ __device__ constexpr int warp_units() {
  constexpr int units = ((kRef ? RAW_W : ROW_W) * (int)sizeof(T) / 16 | 1) * 32;
  // double: the connection's 40 values a lane, then the hotcross's 44
  constexpr int held = sizeof(T) == 8 ? HC_ROWS_D * 32 * 8 / 16 : 0;
  return units > held ? units : held;
}

// A lane's state, the pool's fields: what a launch loads once, holds across
// its steps and stores once (ev and ev_pending, the detached-event
// registers, the shipped variant's alone).
template <typename T>
struct Lane {
  T x[4], k[4], dk[4];
  T e_0_s, dl_shrink, pend_dl, w, alpha_scatti, alpha_absi, bi, tau_abs, tau_scatt, sec_w;
  T ev[9];
  int32_t n_step;
  bool pend_push, at_event, alive, record_pending, interacting, occupied, ev_pending;
};

// The lane's fields at i, read from the pool before anything is stored
// (plain loads: in place the launch writes these addresses).
template <bool kRef, typename T>
__device__ __forceinline__ Lane<T> load_lane(const HotPtrs<T> &P, int i) {
  Lane<T> s = {};
  s.x[0] = P.x0[i]; s.x[1] = P.x1[i]; s.x[2] = P.x2[i]; s.x[3] = P.x3[i];
  s.k[0] = P.k0[i]; s.k[1] = P.k1[i]; s.k[2] = P.k2[i]; s.k[3] = P.k3[i];
  s.dk[0] = P.d0[i]; s.dk[1] = P.d1[i]; s.dk[2] = P.d2[i]; s.dk[3] = P.d3[i];
  s.e_0_s = P.e_0_s[i];
  s.dl_shrink = P.dl_shrink[i];
  s.pend_dl = P.pend_dl[i];
  s.w = P.w[i];
  s.alpha_scatti = P.alpha_scatti[i];
  s.alpha_absi = P.alpha_absi[i];
  s.bi = P.bi[i];
  s.tau_abs = P.tau_abs[i];
  s.tau_scatt = P.tau_scatt[i];
  s.sec_w = P.sec_w[i];
  s.n_step = P.n_step[i];
  s.pend_push = P.pend_push[i];
  s.at_event = P.at_event[i];
  s.alive = P.alive[i];
  s.record_pending = P.record_pending[i];
  s.interacting = P.interacting[i];
  s.occupied = P.occupied[i];
  if constexpr (!kRef) {
    const T *const evs[9] = {P.ev_x0, P.ev_x1, P.ev_x2, P.ev_x3, P.ev_k0,
                             P.ev_k1, P.ev_k2, P.ev_k3, P.ev_w};
#pragma unroll
    for (int m = 0; m < 9; ++m) s.ev[m] = evs[m][i];
    s.ev_pending = P.ev_pending[i];
  }
  return s;
}

// The lane's fields into the post-step pool at i (reference semantics
// write no event registers and leave occupied as it is).
template <bool kRef, typename T>
__device__ __forceinline__ void store_lane(const HotPtrs<T> &P, int i, const Lane<T> &s) {
  P.ox0[i] = s.x[0]; P.ox1[i] = s.x[1]; P.ox2[i] = s.x[2]; P.ox3[i] = s.x[3];
  P.ok0[i] = s.k[0]; P.ok1[i] = s.k[1]; P.ok2[i] = s.k[2]; P.ok3[i] = s.k[3];
  P.od0[i] = s.dk[0]; P.od1[i] = s.dk[1]; P.od2[i] = s.dk[2]; P.od3[i] = s.dk[3];
  P.oe_0_s[i] = s.e_0_s;
  P.odl_shrink[i] = s.dl_shrink;
  P.opend_dl[i] = s.pend_dl;
  P.opend_push[i] = s.pend_push;
  P.oat_event[i] = s.at_event;
  P.oalive[i] = s.alive;
  P.ow[i] = s.w;
  P.orecord_pending[i] = s.record_pending;
  P.oalpha_scatti[i] = s.alpha_scatti;
  P.oalpha_absi[i] = s.alpha_absi;
  P.obi[i] = s.bi;
  P.otau_abs[i] = s.tau_abs;
  P.otau_scatt[i] = s.tau_scatt;
  P.ointeracting[i] = s.interacting;
  P.osec_w[i] = s.sec_w;
  P.on_step[i] = s.n_step;
  if constexpr (!kRef) {
    T *const oevs[9] = {P.oev_x0, P.oev_x1, P.oev_x2, P.oev_x3, P.oev_k0,
                        P.oev_k1, P.oev_k2, P.oev_k3, P.oev_w};
#pragma unroll
    for (int m = 0; m < 9; ++m) oevs[m][i] = s.ev[m];
    P.oev_pending[i] = s.ev_pending;
    P.ooccupied[i] = s.occupied;
  }
}

// kRef = false: the shipped profile (kernel A's step control and optical
// depth cap, the derived 44-wide row from hot_tab, the dl_shrink clamp and
// the detached-event capture); kRef = true: reference semantics (the
// ladder, the raw 32-wide row from corner_rows through the metric pair, no
// clamp, no capture).  G threads share a lane: they run it alike, but for
// their share of the hotcross sum (and, in float, of the warp's row
// fetch), and the first of them stores and counts; every thread of a group
// draws the same Philox block and ends each step with the same state.
// Lanes at or past n compute lane n - 1 and store nothing, so that every
// lane of a warp reaches its shuffles and ballots.  A launch runs `steps`
// steps of each lane (the explicit instance one); kDraw: the uniforms of
// step j drawn from the lane's Philox block at (lane, S_HOT, step0 + j, 0)
// under P.key (`step0` is read by this instance alone).
template <bool kRef, typename T, int G, int THREADS>
__host__ __device__ constexpr int smem_bytes() {  // the staged surface, the warps' regions
  return 16 * (hc_units<kRef, T, G>() + THREADS / 32 * warp_units<kRef, T>());
}

template <bool kRef, typename T, int G, int THREADS, bool kDraw>
__global__ void __launch_bounds__(THREADS, min_blocks(THREADS))
    hot_step_kernel(const HotPtrs<T> P, const AConst<T> CA, const BConst<T> CB, int n,
                    unsigned long long step0, int steps) {
  using V = typename Vec16<T>::type;
  constexpr bool kD = sizeof(T) == 8;
  constexpr int W = kRef ? RAW_W : ROW_W, M = kRef ? RAW_NC : NC;
  constexpr int WPITCH = warp_units<kRef, T>() / 32;  // a warp's region, 32 rows of this
  extern __shared__ float4 smem[];  // smem_bytes<kRef, T, G, THREADS>()
  __shared__ unsigned census[5];
  const V *hs = reinterpret_cast<const V *>(smem);
  V *stage = reinterpret_cast<V *>(smem) + hc_units<kRef, T, G>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const int sub = threadIdx.x % G;  // this thread's place in its lane's group
  const bool valid = i0 < n && sub == 0;  // the thread that stores and counts
  const int i = i0 < n ? i0 : n - 1;
  const T eps = T(EPS_D);
  if (threadIdx.x < 5) census[threadIdx.x] = 0u;
  // the surface's copies run behind phase A of the first step (double:
  // issued at entry; float: behind the lane's loads); each thread arrives
  // on the barrier after the surface once its own have landed
  unsigned long long *const hc_bar = reinterpret_cast<unsigned long long *>(
      reinterpret_cast<V *>(smem) + hc_surf_units<kRef, T, G>());
  if constexpr (kD) {
    if (threadIdx.x == 0) barrier_init(hc_bar, THREADS);
    __syncthreads();
    for (int t = threadIdx.x; t < HC_ROWS_D * HC_PITCH_D; t += THREADS) {
      const int ix = t / HC_PITCH_D, j = t - ix * HC_PITCH_D;
      const bool pad = ix >= HC_NX || j >= HC_NY;
      cp_async8(reinterpret_cast<T *>(smem) + t, P.hc + (pad ? 0 : ix * HC_NY + j), pad);
    }
    cp_async_arrive(hc_bar);
  }

  // the lane's state, loaded once and held across the steps
  Lane<T> s = load_lane<kRef>(P, i);
  if constexpr (!kD) {
    if (threadIdx.x == 0) barrier_init(hc_bar, THREADS);
    __syncthreads();
    constexpr int PITCH = hc_pitch<kRef, T, G>();
    for (int t = threadIdx.x; t < HC_NX * PITCH; t += THREADS) {
      const int ix = t / PITCH, j = t - ix * PITCH;
      const bool pad = j >= HC_NY;
      cp_async4(reinterpret_cast<T *>(smem) + t, P.hc + (pad ? 0 : ix * HC_NY + j), pad);
    }
    cp_async_arrive(hc_bar);
  }
  unsigned long long key0 = 0, key1 = 0;  // kDraw: the block's key
  if constexpr (kDraw) {
    key0 = __ldg(P.key);
    key1 = __ldg(P.key + 1);
  }
  // the warp's census ballots, summed over the steps
  unsigned c_occ = 0, c_mov = 0, c_com = 0, c_par = 0, c_hc = 0;

  for (int j = 0; j < steps; ++j) {
    // every lane done with the warp's region (its row stage, and in double
    // its connection slots and hotcross table) before this step writes it
    __syncwarp();
    // ---- phase A (engine.hot_phase_a) ----
    T x[4] = {s.x[0], s.x[1], s.x[2], s.x[3]};
    T k[4] = {s.k[0], s.k[1], s.k[2], s.k[3]};
    T dk[4] = {s.dk[0], s.dk[1], s.dk[2], s.dk[3]};
    const T e_0_s = s.e_0_s, dl_shrink = s.dl_shrink, pend_dl = s.pend_dl, w = s.w;
    const bool pend_push = s.pend_push, at_event = s.at_event, alive = s.alive;
    const T alpha_scatti = s.alpha_scatti, alpha_absi = s.alpha_absi, bi = s.bi;

    const bool moving = alive && !at_event;
    const T dl_full =
        pend_push ? pend_dl : step_size(x[1], x[2], k[1], k[2], k[3], CA.x_stop2);
    T seg = dl_full * dl_shrink;
    if (pend_push) seg = jmin(seg, dl_full);
    if (!kRef && !pend_push) {  // cap the biased scattering depth a grown step carries
      const T seg_tau = (T(1.0) / (CA.half_dtk * alpha_scatti * bi + eps)) * CA.grow_tau_cap;
      seg = jmin(seg, jmax(seg_tau, dl_full));
    }
    const bool at_floor = dl_shrink <= CA.shrink_floor;
    const bool act = moving && !(x[1] < CA.x_start1);

    // one implicit-midpoint attempt (harm_model.cpp:1217-1289)
    const T dl_2 = T(0.5) * seg;
    T k_half[4], k_pred[4], x_new[4];
    if constexpr (kD) {  // the midpoint's (x1, x2) alone before the connection
#pragma unroll
      for (int m = 1; m < 3; ++m) x_new[m] = x[m] + (k[m] + dk[m] * dl_2) * seg;
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        k_half[m] = k[m] + dk[m] * dl_2;
        k_pred[m] = k_half[m] + dk[m] * dl_2;
        x_new[m] = x[m] + k_half[m] * seg;
      }
    }
    T conn_regs[kD ? 1 : 40];
    const auto conn = conn_slots<kD>(
        conn_regs, reinterpret_cast<T *>(stage + warp * 32 * WPITCH) + lane);
    T keep[5];  // the connection's transcendentals at x_new
    connection(x_new[1], x_new[2], CA, conn, keep);
    if constexpr (kD) {  // the rest of the push, after the connection
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        k_half[m] = k[m] + dk[m] * dl_2;
        k_pred[m] = k_half[m] + dk[m] * dl_2;
        x_new[m] = x[m] + k_half[m] * seg;
      }
    }
    // metric row 0 at x_new from the connection's values: float beside the
    // rounds, double after them (so that it holds no registers through them)
    T g00, g01, g03;
    if constexpr (!kD) metric_row0(keep, CA, g00, g01, g03);
    T err = T(0.0);
    T dk_new[4] = {dk[0], dk[1], dk[2], dk[3]};
    for (int it = 0; it < CA.fp_iters; ++it) {
      geodesic_rhs(conn, k_pred, dk_new);
      T k_next[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) k_next[m] = k_half[m] + dl_2 * dk_new[m];
      const T kscale = fm::fabs(k_next[0]) + fm::fabs(k_next[1]) + fm::fabs(k_next[2]) +
                       fm::fabs(k_next[3]) + eps;
      err = (fm::fabs(k_pred[0] - k_next[0]) + fm::fabs(k_pred[1] - k_next[1]) +
             fm::fabs(k_pred[2] - k_next[2]) + fm::fabs(k_pred[3] - k_next[3])) /
            kscale;
#pragma unroll
      for (int m = 0; m < 4; ++m) k_pred[m] = k_next[m];
    }
    if constexpr (kD) metric_row0(keep, CA, g00, g01, g03);
    const T e_1 = -(k_pred[0] * g00 + k_pred[1] * g01 + k_pred[3] * g03);
    const T err_e = fm::fabs((e_1 - e_0_s) / (e_0_s + eps));
    const bool bad = (err_e > T(1.0e-4)) || (err > T(1.0e-3)) || !isfinite(err);
    const bool commit = act && (!bad || at_floor);
    if (commit) {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        x[m] = x_new[m];
        k[m] = k_pred[m];
        dk[m] = dk_new[m];
      }
    }
    const T e0sn = commit ? e_1 : e_0_s;
    const T err_r = jmax(err * CA.inv_e_tol, err_e * CA.inv_e_drift_tol);

    T dl_shrink_n;
    if constexpr (kRef) {  // halve a failed attempt, else double
      dl_shrink_n = (act && !commit) ? jmax(dl_shrink * T(0.5), CA.shrink_floor)
                                     : jmin(dl_shrink * T(2.0), CA.grow_cap);
    } else {  // error-proportional step control: fac = safety / sqrt(err), clamped
      T err_eff = isfinite(err_r) ? err_r : T(1.0e12);
      if (!act) err_eff = T(1.0e-12);  // idle lanes re-grow
      const T fac =
          jclip(CA.step_ctrl * fm::rsqrt(jmax(err_eff, T(1.0e-12))), T(0.25), T(2.0));
      dl_shrink_n = jclip(dl_shrink * fac, CA.shrink_floor, CA.grow_cap);
    }

    const T pend_rem = (pend_push && commit) ? pend_dl - seg : pend_dl;
    const bool arrived = moving && pend_push && commit && (pend_rem <= T(0.0));

    // stop criterion + roulette (harm_model.cpp:1589-1616)
    const bool checkable = (moving && commit && !arrived) || (moving && !act);
    const bool horizon = x[1] < CA.x1_min;
    const bool escaped = x[1] > T(4.605170185988092);  // ln R_MAX
    const bool small = w < CA.weight_min;
    bool win;
    T u_x1_drawn;  // kDraw: the optical-depth uniform, held to phase B
    if constexpr (kDraw) {
      const Words u = philox((uint64_t)i, S_HOT, step0 + (unsigned long long)j, 0, key0, key1);
      win = unif<T>(u.v[0]) <= T(1.0 / 1.0e4);
      u_x1_drawn = unif<T>(u.v[1]);
    } else {
      win = P.u_roul[i] <= T(1.0 / 1.0e4);
    }
    const T w_roul = win ? w * T(1.0e4) : T(0.0);
    const T w_a = (checkable && small && !horizon) ? w_roul : w;
    const bool killed_inside = checkable && small && !horizon && !escaped && !win;
    const bool stopped = checkable && (horizon || escaped || killed_inside);
    const bool record = checkable && escaped && !horizon;
    const bool pend_push_a = pend_push && !arrived, at_event_a = at_event || arrived;
    const bool alive_a = alive && !stopped;
    const bool grown = !pend_push && (dl_shrink > T(1.0));

    // bilinear cell (harm_model.cpp:1406-1434)
    const T fia = fm::floor((x[1] - CA.x_start1) * CA.inv_dx1 - T(0.5));
    const T fja = fm::floor((x[2] - CA.x_start2) * CA.inv_dx2 - T(0.5));
    const int ii = (int)fm::fmin(fm::fmax(fia, T(0.0)), T(CA.n1 - 2));
    const int jj = (int)fm::fmin(fm::fmax(fja, T(0.0)), T(CA.n2 - 2));
    const int z = ii * CA.n2 + jj;

    // ---- the corner row at z: derived (fluid.blend_derived) or raw (fluid.blend_raw) ----
    T row[W];
    if constexpr (kD) __syncwarp();  // every lane's connection read before the rows land on it
    fetch_row<W, kD ? 1 : G>(P.table, z, lane, stage + warp * 32 * WPITCH, row);

    // ---- phase B (engine.hot_phase_b) ----
    bool inter = moving && commit && !pend_push && !stopped;
    const T x1 = x[1], x2 = x[2];
    // the grid test and the fluid's scalars stay written out here: their
    // shared forms (physics.cuh in_grid, raw_scalars, derived_fluid), which the
    // other kernels use, move this kernel's instruction schedule
    const bool inside = (x1 >= CB.x_start1) && (x1 <= CB.x_stop1) && (x2 >= CB.x_start2) &&
                        (x2 <= CB.x_stop2);
    T pr[M];
    blend_row<M>(x1, x2, row, CB, pr);
    T n_e, te, b_mag, u_cov[4], b_cov[4];
    if constexpr (kRef) {
      n_e = inside ? pr[0] * CB.n_e_unit : T(0.0);
      te = pr[1] / pr[0] * CB.theta_e_unit;
      T g[7], gc[6];
      // from the connection's transcendentals at x_new, which equal those at
      // x on every lane whose push committed; phase B's values count on those
      // lanes alone (an uncommitted lane does not interact)
      metric_pair(x1, x2, CB, g, gc, keep);
      four_vectors(pr, g, gc, CB, u_cov, b_cov, &b_mag);
    } else {
      n_e = inside ? pr[0] : T(0.0);
      te = pr[1] / pr[0];
      b_mag = pr[2];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        u_cov[m] = pr[3 + m];
        b_cov[m] = pr[7 + m];
      }
    }

    // kinematics (radiation.kinematics_sin_c)
    T sin_th, nu;
    kinematics(k, u_cov, b_cov, b_mag, CB, sin_th, nu);

    const bool bound = n_e == T(0.0);
    const T nu_safe = fm::fabs(nu) + eps;
    const T e_g = T(HPL_D) * nu_safe * CB.inv_mecc;
    T sigma;
    // the first step waits for the staged surface; a later one finds its
    // phase complete and passes at once
    barrier_wait(hc_bar);
    if constexpr (kD) {
      if constexpr (G == 1)
        sigma = hotcross_mma(e_g, te, CB, reinterpret_cast<const T *>(smem),
                             reinterpret_cast<T *>(stage + warp * 32 * WPITCH), lane);
      else
        sigma = hotcross_group<G>(e_g, te, CB, hs, sub);
    } else if constexpr (kRef) {  // the plain order's columns over the group
      sigma = hotcross_cols<G>(e_g, te, CB, hs, sub, FULL, lane - sub, 1);
    } else {  // the row form's rows over the group
      sigma =
          hotcross_rows<G, hc_pitch<kRef, T, G>()>(e_g, te, CB, hs, sub, FULL, lane - sub, 1);
    }
    const T a_scf = nu_safe * sigma * n_e;
    const bool hc_thomson = e_g * te < T(1.0e-6), hc_cold = te < T(1.0e-4);
    const bool hc_hit = !hc_thomson && !hc_cold &&
                        ((e_g <= T(1.0e-12)) || (e_g >= T(1.0e6)) || (te <= T(1.0e-4)) ||
                         (te >= T(1.0e4))) &&
                        (n_e > T(0.0));
    const T a_abf = alpha_abs(nu_safe, n_e, te, b_mag, sin_th, CB);
    const T bf = bias_clamp(w_a, CB, [&] { return P.bias_scale[0] * te * te; });

    const bool dead_branch = bound || (nu < T(0.0));
    // vacuum -> matter entry rollback of grown steps
    bool entry_roll = false;
    if constexpr (!kRef) {
      entry_roll = inter && grown && !dead_branch && (alpha_scatti <= T(0.0)) &&
                   (alpha_absi <= T(0.0)) && (n_e > T(0.0));
      inter = inter && !entry_roll;
    }

    const T half = CB.half_dtk * seg;
    const T d_tau_scatt =
        dead_branch ? alpha_scatti * half : (alpha_scatti + a_scf) * half;
    const T d_tau_abs = dead_branch ? alpha_absi * half : (alpha_absi + a_abf) * half;
    const T bias = dead_branch ? T(0.0) : T(0.5) * (bi + bf);

    const T alpha_scatti_b = inter ? (dead_branch ? T(0.0) : a_scf) : alpha_scatti;
    const T alpha_absi_b = inter ? (dead_branch ? T(0.0) : a_abf) : alpha_absi;
    const T bi_b = inter ? (dead_branch ? T(0.0) : bf) : bi;

    T u_x1;
    if constexpr (kDraw)
      u_x1 = u_x1_drawn;
    else
      u_x1 = P.u_x1[i];
    const T x1r = -fm::log(u_x1 + T(1e-30));
    const T sec_w_new = w_a / jmax(bias, eps);
    const bool scatter = inter && (bias * d_tau_scatt > x1r) && (sec_w_new > CB.weight_min);
    const T frac = scatter ? x1r / (bias * d_tau_scatt + eps) : T(1.0);
    const T d_tau_abs_eff = d_tau_abs * frac;
    const T d_tau_scatt_eff = d_tau_scatt * frac;
    const bool absorbed = inter && (d_tau_abs_eff > T(100.0));
    const T d_tau = d_tau_abs_eff + d_tau_scatt_eff;
    const T decay =
        (d_tau < T(1.0e-3))
            ? T(1.0) - d_tau * CB.inv_24 * (T(24.0) - d_tau * (T(12.0) - d_tau * (T(4.0) - d_tau)))
            : fm::exp(-jmin(d_tau, T(200.0)));
    const bool live = inter && !absorbed;
    const bool roll = scatter && !absorbed;
    const bool roll_any = roll || entry_roll;

    const int32_t n_step_n = s.n_step + (moving ? 1 : 0);
    const bool over = moving && (n_step_n > CB.stall_steps);

    // the scatter or entry rollback restores the pre-step state the lane holds
    T xo[4], ko[4], dko[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      xo[m] = roll_any ? s.x[m] : x[m];
      ko[m] = roll_any ? s.k[m] : k[m];
      dko[m] = roll_any ? s.dk[m] : dk[m];
    }
    const T e0so = roll_any ? s.e_0_s : e0sn;
    const T sec_w_b = roll ? sec_w_new : s.sec_w;
    const bool alive_b = alive_a && !absorbed && !over;
    const T w_b = live ? w_a * decay : w_a;
    const bool hc_clamp = hc_hit && inter;

    // ---- the epilogue: dl_shrink clamp, detached-event capture (engine._capture_events) ----
    T dl_shrink_o = dl_shrink_n, w_o = w_b;
    T alpha_scatti_o = alpha_scatti_b, alpha_absi_o = alpha_absi_b, bi_o = bi_b;
    bool at_event_o = at_event_a, alive_o = alive_b, occupied_o = s.occupied;
    if constexpr (!kRef) {
      const bool tau_over = inter && (jmax(d_tau_scatt, d_tau_abs) > CB.tau_cap);
      if (tau_over || entry_roll) dl_shrink_o = jmin(dl_shrink_n, T(1.0));
      const bool ev_pending = s.ev_pending;
      const bool pdie = arrived && ((ko[0] > T(1.0e5)) || (ko[0] < T(0.0)) || isnan(ko[0]) ||
                                    isnan(ko[1]) || isnan(ko[3]));
      const bool capt = arrived && !ev_pending && !pdie;
      const bool neg = nu < T(0.0);
      at_event_o = at_event_a && !capt && !pdie;
      alive_o = alive_b && !pdie;
      occupied_o = occupied_o && !(pdie && !ev_pending);
      w_o = pdie ? T(0.0) : w_b;
      if (capt) {
        alpha_scatti_o = neg ? T(0.0) : a_scf;
        alpha_absi_o = neg ? T(0.0) : a_abf;
        bi_o = bf;
      }
      const T took[9] = {xo[0], xo[1], xo[2], xo[3], ko[0], ko[1], ko[2], ko[3], sec_w_b};
#pragma unroll
      for (int m = 0; m < 9; ++m) s.ev[m] = capt ? took[m] : s.ev[m];
      s.ev_pending = ev_pending || capt;
    }
    // the lane's post-step state (the pre-step fields read above)
    s.tau_abs = live ? s.tau_abs + d_tau_abs_eff : s.tau_abs;
    s.tau_scatt = live ? s.tau_scatt + d_tau_scatt_eff : s.tau_scatt;
    s.interacting =
        inter ? ((alpha_scatti_b > T(0.0)) || (alpha_absi_b > T(0.0)) || (n_e > T(0.0)))
              : s.interacting;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      s.x[m] = xo[m];
      s.k[m] = ko[m];
      s.dk[m] = dko[m];
    }
    s.e_0_s = e0so;
    s.dl_shrink = dl_shrink_o;
    s.pend_dl = roll ? seg * frac : pend_rem;
    s.pend_push = pend_push_a || roll;
    s.at_event = at_event_o;
    s.alive = alive_o;
    s.w = w_o;
    s.record_pending = s.record_pending || record;
    s.alpha_scatti = alpha_scatti_o;
    s.alpha_absi = alpha_absi_o;
    s.bi = bi_o;
    s.sec_w = sec_w_b;
    s.n_step = n_step_n;
    s.occupied = occupied_o;

    // ---- the census (engine._util_counters and n_hc_clamp): the warp's
    // ballots of the step, summed over the steps ----
    c_occ += __popc(__ballot_sync(FULL, valid && occupied_o));
    c_mov += __popc(__ballot_sync(FULL, valid && moving));
    c_com += __popc(__ballot_sync(FULL, valid && commit));
    c_par += __popc(__ballot_sync(FULL, valid && at_event_o));
    c_hc += __popc(__ballot_sync(FULL, valid && hc_clamp));
  }

  // the lane, once, by the first thread of its group
  if (valid) store_lane<kRef>(P, i, s);
  // the block's sums in shared memory, one 64-bit atomic per counter and block
  __syncthreads();
  if (lane == 0) {
    atomicAdd(&census[0], c_occ);
    atomicAdd(&census[1], c_mov);
    atomicAdd(&census[2], c_com);
    atomicAdd(&census[3], c_par);
    atomicAdd(&census[4], c_hc);
  }
  __syncthreads();
  if (threadIdx.x < 5) {
    const unsigned c = census[threadIdx.x];
    unsigned long long *dst = threadIdx.x == 0   ? P.ls_occupied
                              : threadIdx.x == 1 ? P.ls_moving
                              : threadIdx.x == 2 ? P.ls_committed
                              : threadIdx.x == 3 ? P.ls_parked
                                                 : P.n_hc_clamp;
    if (c) atomicAdd(dst, (unsigned long long)c);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    atomicAdd(P.ls_iters, (unsigned long long)steps);
    atomicAdd(P.ls_slots, (unsigned long long)steps * n);
  }
}


// The instance a launch of n lanes runs: its threads a lane (G) and its
// block.  Float: up to F32_GROUP_MAX_N lanes (the cascade's 512 and 4,096,
// the gate's 1,024) F32_GROUP threads a lane, up to F32_MID_MAX_N
// F32_MID_GROUP, each in F32_GROUP_THREADS-thread blocks, the launch
// spread over the SMs; beyond, the pool's width, one thread a lane in
// 256-thread blocks at most 128 registers, 65,536 lanes in one wave.
// Double: up to F64_GROUP_MAX_N lanes (the cascade's 512, the gate's 1,024)
// F64_GROUP threads a lane in 128-thread blocks; up to F64_NARROW_MAX_N one
// thread a lane in 64-thread blocks (four an SM, the launch spread over the
// SMs); beyond, as float.  The groups, blocks and crossovers were measured
// (PERF.md: tools/sweep_hot_shape.py, every group of 1, 2, 4 and 8 in
// blocks of 32 to 256 threads at 512 to 65,536 lanes).
constexpr int F32_GROUP = 8, F32_GROUP_MAX_N = 4096, F32_MID_GROUP = 2, F32_MID_MAX_N = 16384,
              F32_GROUP_THREADS = 128;
constexpr int F64_GROUP = 8, F64_GROUP_MAX_N = 2048, F64_NARROW_MAX_N = 32768;
struct Shape {
  int group, threads;
};
template <typename T>
Shape hot_shape(int n) {
  if (sizeof(T) == 8 && n <= F64_GROUP_MAX_N) return {F64_GROUP, 128};
  if (sizeof(T) == 8 && n <= F64_NARROW_MAX_N) return {1, 64};
  if (sizeof(T) == 4 && n <= F32_GROUP_MAX_N) return {F32_GROUP, F32_GROUP_THREADS};
  if (sizeof(T) == 4 && n <= F32_MID_MAX_N) return {F32_MID_GROUP, F32_GROUP_THREADS};
  return {1, 256};
}

// Asks once for the instance's dynamic shared memory (above 48 KB).
template <bool kRef, typename T, int G, int THREADS, bool kDraw>
cudaError_t prepare() {
  static cudaError_t rc = cudaFuncSetAttribute(
      hot_step_kernel<kRef, T, G, THREADS, kDraw>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<kRef, T, G, THREADS>());
  return rc;
}

// One launch of the instance with G threads a lane in blocks of THREADS: a
// drawing instance reads its run after the HotScal scalars (the first
// step's index in the block, then the steps), an explicit one runs one
// step.
template <bool kRef, typename T, int G, int THREADS, bool kDraw>
int launch_hot_g(void **ptrs, const double *scal, int n, void *stream) {
  HotPtrs<T> P;
  memset(&P, 0, sizeof(HotPtrs<T>));
  memcpy(&P, ptrs, (kRef ? HOT_REF_NPTRS : HOT_NPTRS) * sizeof(void *));
  AConst<T> CA;
  BConst<T> CB;
  make_consts<T>(scal, CA, CB);
  const unsigned long long step0 = kDraw ? (unsigned long long)scal[HOT_NSCAL] : 0ull;
  const int steps = kDraw ? (int)scal[HOT_NSCAL + 1] : 1;
  if (steps < 1) return (int)cudaErrorInvalidValue;
  constexpr int lanes = THREADS / G;
  const cudaError_t rc = prepare<kRef, T, G, THREADS, kDraw>();
  if (rc != cudaSuccess) return (int)rc;
  if (n > 0) {
    hot_step_kernel<kRef, T, G, THREADS, kDraw><<<(n + lanes - 1) / lanes, THREADS,
                                                 smem_bytes<kRef, T, G, THREADS>(),
                                                 (cudaStream_t)stream>>>(P, CA, CB, n, step0,
                                                                         steps);
  }
  return (int)cudaGetLastError();
}

// The blocks an SM holds of an instance, or minus a CUDA error.
template <bool kRef, typename T, int G, int THREADS, bool kDraw>
int blocks_per_sm_g() {
  int blocks = 0;
  cudaError_t rc = prepare<kRef, T, G, THREADS, kDraw>();
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, hot_step_kernel<kRef, T, G, THREADS, kDraw>, THREADS,
        smem_bytes<kRef, T, G, THREADS>());
  return rc == cudaSuccess ? blocks : -(int)rc;
}

// A launch of n lanes and the blocks an SM of its instance (what = 0, 1).
template <bool kRef, typename T, bool kDraw>
int hot_step_at(int n, int what, void **ptrs = nullptr, const double *scal = nullptr,
                void *stream = nullptr) {
  const Shape s = hot_shape<T>(n);
  constexpr int TH = F32_GROUP_THREADS;
  if constexpr (sizeof(T) == 8) {
    if (s.group > 1)
      return what ? blocks_per_sm_g<kRef, T, F64_GROUP, 128, kDraw>()
                  : launch_hot_g<kRef, T, F64_GROUP, 128, kDraw>(ptrs, scal, n, stream);
    if (s.threads == 64)
      return what ? blocks_per_sm_g<kRef, T, 1, 64, kDraw>()
                  : launch_hot_g<kRef, T, 1, 64, kDraw>(ptrs, scal, n, stream);
  } else {
    if (s.group == F32_GROUP)
      return what ? blocks_per_sm_g<kRef, T, F32_GROUP, TH, kDraw>()
                  : launch_hot_g<kRef, T, F32_GROUP, TH, kDraw>(ptrs, scal, n, stream);
    if (s.group == F32_MID_GROUP)
      return what ? blocks_per_sm_g<kRef, T, F32_MID_GROUP, TH, kDraw>()
                  : launch_hot_g<kRef, T, F32_MID_GROUP, TH, kDraw>(ptrs, scal, n, stream);
  }
  return what ? blocks_per_sm_g<kRef, T, 1, 256, kDraw>()
              : launch_hot_g<kRef, T, 1, 256, kDraw>(ptrs, scal, n, stream);
}

template <bool kRef, typename T, bool kDraw>
int launch_hot(void **ptrs, const double *scal, int n, void *stream) {
  return hot_step_at<kRef, T, kDraw>(n, 0, ptrs, scal, stream);
}

}  // namespace

extern "C" {

// The entry points: <name>_nptrs, _nscal and _launch, and the shape of the
// instance each runs at n lanes (its threads a lane, its threads a block,
// its blocks an SM); <name>_draw draws its uniforms and runs several steps
// (two scalars more: the first step's index in the block, the steps).
#define HOT_ENTRY(name, kRef, T)                                                         \
  int name##_nptrs() { return kRef ? HOT_REF_NPTRS : HOT_NPTRS; }                        \
  int name##_nscal() { return HOT_NSCAL; }                                               \
  int name##_launch(void **ptrs, const double *scal, int n, void *stream) {             \
    return launch_hot<kRef, T, false>(ptrs, scal, n, stream);                            \
  }                                                                                      \
  int name##_group(int n) { return hot_shape<T>(n).group; }                              \
  int name##_threads(int n) { return hot_shape<T>(n).threads; }                          \
  int name##_blocks_per_sm(int n) { return hot_step_at<kRef, T, false>(n, 1); }          \
  int name##_draw_nptrs() { return kRef ? HOT_REF_NPTRS : HOT_NPTRS; }                   \
  int name##_draw_nscal() { return HOT_NSCAL + 2; }                                      \
  int name##_draw_launch(void **ptrs, const double *scal, int n, void *stream) {        \
    return launch_hot<kRef, T, true>(ptrs, scal, n, stream);                             \
  }                                                                                      \
  int name##_draw_group(int n) { return hot_shape<T>(n).group; }                         \
  int name##_draw_threads(int n) { return hot_shape<T>(n).threads; }                     \
  int name##_draw_blocks_per_sm(int n) { return hot_step_at<kRef, T, true>(n, 1); }

// tools/sweep_hot_shape.py includes this file with HOT_STEP_SWEEP defined and
// builds its own float instances, without these
#ifndef HOT_STEP_SWEEP
HOT_ENTRY(hot_step, false, float)
HOT_ENTRY(hot_step_ref, true, float)
HOT_ENTRY(hot_step_f64, false, double)
HOT_ENTRY(hot_step_ref_f64, true, double)
#endif

}  // extern "C"
