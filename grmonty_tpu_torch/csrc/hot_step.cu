// The hot step of the transport engine, one hand-written kernel for Hopper
// (sm_90a): hot_step_kernel<kRef>, one thread per photon lane, computing
// engine.hot_step_plain.
//
// It replaces the Pallas kernels grmonty_tpu/transport/hotstep_pallas.py:104
// `kernel_a` (body engine.hot_phase_a) and hotstep_pallas.py:152 `kernel_b`
// (body engine.hot_phase_b), and under reference semantics the corner-row
// gather between them (grmonty_tpu/ops/gather.py:63 `_gather_kernel`).  In
// one launch each thread runs, for its lane:
//   1. phase A: the step size, one implicit-midpoint Kerr push with the
//      closed-form 40-term connection and FP_ITERS fixed-point rounds, the
//      commit gate, the step control (kRef: the halve/double ladder; else
//      the error-proportional control and the grown-step optical-depth
//      cap), the pend/arrival bookkeeping, the stop test with Russian
//      roulette and the bilinear cell z;
//   2. the corner row at z: 44 derived floats from hot_tab, or (kRef) 32
//      raw floats from corner_rows;
//   3. phase B: the blend (raw rows through the metric pair), nu, the sin
//      pitch angle, the Chebyshev hotcross alpha_scatt, the Kirchhoff
//      alpha_abs with the Chebyshev K2, dtau, the biased scatter decision
//      with rollback, the weight decay, the step count and stall kill, and
//      (shipped) the vacuum-to-matter entry rollback of grown steps;
//   4. the epilogue: (shipped) the dl_shrink clamp and the detached-event
//      capture (engine._capture_events); the lane-slot census and the
//      hotcross clamp count as warp ballots, a block sum and one 64-bit
//      integer atomic per counter and block, exact in any order.
// It writes every pool field once; a lane that rolls back reads its
// pre-step state from the inputs again.
//
// What bounds it on an H100 80GB HBM3 at 700 W: the pool's 65,536 lanes
// are 2,048 warps, 15.5 an SM, one wave filling a quarter of the warp
// slots.  A lane moves about 370 B (shipped) or 270 B (reference), rows
// included: 7.3 and 5.3 us at 3.35 TB/s; it issues about 3,800 float32
// operations, each multiply and add on its own under -fmad=false, 7.4 us at
// the 33.5 T instructions/s of the float32 pipes.  It took 24.5 us
// (shipped) and 20.7 us (reference), bound by instruction issue and latency
// at that occupancy; in one run beside the three launches it replaces, 26.0
// and 22.3 us against their 32.6 and 37.3 us (PERF.md).
//
// What the design does about what held the three launches back:
//   1. The hotcross sum's 1,271 coefficients: the block stages the 41x31
//      surface in shared memory, each row padded to 32 floats, and a lane
//      reads a row as eight broadcast LDS.128: 328 loads a lane, not 1,271
//      LDS.  Constant-bank operands with both loops unrolled load nothing
//      but make 6,928 instructions a warp and took 52 us (shipped, against
//      26 us for this route in the same run); the rolled loop over constant
//      memory took 39 us, scalar LDS 29 us.
//   2. Occupancy: 112 (shipped) and 106 (reference) registers, no spills,
//      __launch_bounds__(256, 2): the whole pool is resident in one wave.
//   3. Three launches become one: no per-lane arrays between the phases and
//      no gathered (N, 32) rows.  The warp fetches its 32 rows together:
//      neighbouring lanes load one row's float4s into shared memory (at a
//      pitch of an odd number of float4s, so that a quarter warp's reads
//      hit distinct banks), then each lane reads its own; 1.2 us faster
//      than each lane loading its own row.
//   4. The epilogue's ~25 torch launches (clamp, capture, six census sums)
//      are part of the kernel.
//
// Numerics: the arithmetic mirrors the plain torch versions operation by
// operation (same association order, float32, constants folded in double
// first where the Python expression folds them).  PyTorch on the card
// divides a tensor by a Python scalar as a multiply by the scalar's float
// reciprocal, and a scalar by a tensor as the tensor's reciprocal times the
// scalar; the kernel uses the same two forms (the inv_* constants), so that
// phase A's rounding matches op for op.  The hotcross sum keeps the order
// of each variant (shipped: s_ix = sum_j c[ix, j] T_j(ty), then
// sum_ix T_ix(tx) s_ix; reference: u_j = sum_ix T_ix(tx) c[ix, j] as fused
// multiply-adds, then sum_j u_j T_j(ty)).  The build must not use
// --use_fast_math: the commit gate and the step controller test
// isfinite(err), which fast math folds to true, and flushing denormals
// would zero the fluid-frame frequency of the lowest-energy photons.
//
// Interface: plain C entry points for ctypes.  Each takes an array of
// device pointers in the order of HotPtrs (the Python wrapper in
// transport/hot_kernels.py lists the same order and checks the counts), an
// array of double scalars in the order of HotScal, the lane count and the
// CUDA stream, and returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

typedef unsigned char u8;

namespace {

constexpr double PI_D = 3.14159265358979323846;
constexpr double EPS_D = 1.0e-30;
constexpr double ME_D = 9.1093826e-28;
constexpr double CL_D = 2.99792458e10;
constexpr double HPL_D = 6.6260693e-27;
constexpr double EE_D = 4.80320680e-10;
constexpr double SIGMA_T_D = 0.665245873e-24;

__device__ __forceinline__ float jmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}
__device__ __forceinline__ float jclip(float x, float lo, float hi) {
  return jmin(jmax(x, lo), hi);
}

// ---------------------------------------------------------------------------
// phase A: the geodesic push
// ---------------------------------------------------------------------------

struct AScal {  // order = hot_kernels._A_SCAL
  double a, h_slope, r_0, x_start1, x_start2, x_stop2, dx1, dx2, n1, n2,
      x1_min, d_tau_k, fp_iters, weight_min, shrink_floor, grow_cap,
      grow_tau_cap, step_ctrl, inv_dx1, inv_dx2, inv_e_tol, inv_e_drift_tol;
};
constexpr int A_NSCAL = sizeof(AScal) / sizeof(double);

// Per-launch float constants, folded in double on the host side of the
// launch exactly as the Python expressions fold their float literals.
struct AConst {
  float a, a2, a3, a4, neg_a, neg_a2, neg_2a, r_0, two_pi, pi, half_1mh,
      one_mh, neg2pipi_1mh, x_start1, x_start2, x_stop2, dx1, dx2, x1_min,
      half_dtk, weight_min, shrink_floor, grow_cap, grow_tau_cap, step_ctrl,
      inv_dx1, inv_dx2, inv_e_tol, inv_e_drift_tol;
  int n1, n2, fp_iters;
};

__device__ __forceinline__ void connection(float x1, float x2, const AConst &C,
                                           float *c) {
  const float r1 = expf(x1);
  const float r2 = r1 * r1, r3 = r2 * r1, r4 = r3 * r1;
  const float sx = sinf(C.two_pi * x2);
  const float cx = cosf(C.two_pi * x2);
  const float th = C.pi * x2 + C.half_1mh * sx;
  const float dth = C.pi * (1.0f + C.one_mh * cx);
  const float d2th = C.neg2pipi_1mh * sx;
  const float dth2 = dth * dth;
  const float sth = sinf(th), cth = cosf(th);
  const float sth2 = sth * sth, sth4 = sth2 * sth2;
  const float cth2 = cth * cth, cth4 = cth2 * cth2;
  const float s2th = 2.0f * sth * cth;
  const float c2th = 2.0f * cth2 - 1.0f;
  const float r1sth2 = r1 * sth2;
  const float a = C.a, a2 = C.a2, a3 = C.a3, a4 = C.a4;
  const float a2sth2 = a2 * sth2, a2cth2 = a2 * cth2, a4cth4 = a4 * cth4;
  const float rho2 = r2 + a2cth2;
  const float rho22 = rho2 * rho2, rho23 = rho22 * rho2;
  const float ir2 = 1.0f / rho2;
  const float ir22 = ir2 * ir2, ir23 = ir22 * ir2;
  const float ir23_dth = ir23 / dth;
  const float fac1 = r2 - a2cth2;
  const float f1r3 = fac1 * ir23;
  const float fac2 = a2 + 2.0f * r2 + a2 * c2th;
  const float fac3 = a2 + r1 * (r1 - 2.0f);

  c[0] = 2.0f * r1 * f1r3;
  c[1] = r1 * (2.0f * r1 + rho2) * f1r3;
  c[2] = C.neg_a2 * r1 * s2th * dth * ir22;
  c[3] = C.neg_2a * r1sth2 * f1r3;
  c[4] = 2.0f * r2 * (r4 + r1 * fac1 - a4cth4) * ir23;
  c[5] = C.neg_a2 * r2 * s2th * dth * ir22;
  c[6] = a * r1 * (-r1 * (r3 + 2.0f * fac1) + a4cth4) * sth2 * ir23;
  c[7] = -2.0f * r2 * dth2 * ir2;
  c[8] = a3 * r1sth2 * s2th * dth * ir22;
  c[9] = 2.0f * r1sth2 * (-r1 * rho22 + a2sth2 * fac1) * ir23;

  c[10] = fac3 * fac1 / (r1 * rho23);
  c[11] = fac1 * (-2.0f * r1 + a2sth2) * ir23;
  c[12] = 0.0f;
  c[13] = C.neg_a * sth2 * fac3 * fac1 / (r1 * rho23);
  c[14] = (r4 * (r1 - 2.0f) * (1.0f + r1) +
           a2 * (a2 * r1 * (1.0f + 3.0f * r1) * cth4 + a4cth4 * cth2 +
                 r3 * sth2 + r1 * cth2 * (2.0f * r1 + 3.0f * r3 - a2sth2))) *
          ir23;
  c[15] = C.neg_a2 * dth * s2th / fac2;
  c[16] = a * sth2 *
          (a4 * r1 * cth4 + r2 * (2.0f * r1 + r3 - a2sth2) +
           a2cth2 * (2.0f * r1 * (r2 - 1.0f) + a2sth2)) *
          ir23;
  c[17] = -fac3 * dth2 * ir2;
  c[18] = 0.0f;
  c[19] = -fac3 * sth2 * (r1 * rho22 - a2 * fac1 * sth2) / (r1 * rho23);

  const float c200 = C.neg_a2 * r1 * s2th * ir23_dth;
  c[20] = c200;
  c[21] = r1 * c200;
  c[22] = 0.0f;
  c[23] = a * r1 * (a2 + r2) * s2th * ir23_dth;
  c[24] = r2 * c200;
  c[25] = r2 * ir2;
  c[26] = (a * r1 * cth * sth *
           (r3 * (2.0f + r1) +
            a2 * (2.0f * r1 * (1.0f + r1) * cth2 + a2 * cth4 + 2.0f * r1sth2))) *
          ir23_dth;
  c[27] = C.neg_a2 * cth * sth * dth * ir2 + d2th / dth;
  c[28] = 0.0f;
  c[29] = (-cth * sth *
           (rho23 + a2sth2 * rho2 * (r1 * (4.0f + r1) + a2cth2) +
            2.0f * r1 * a4 * sth4) *
           ir23_dth);

  const float c300 = a * f1r3;
  c[30] = c300;
  c[31] = r1 * c300;
  c[32] = C.neg_2a * r1 * cth * dth / (sth * rho22);
  c[33] = -a2sth2 * f1r3;
  c[34] = a * r2 * f1r3;
  c[35] = C.neg_2a * r1 * (a2 + 2.0f * r1 * (2.0f + r1) + a2 * c2th) * cth *
          dth / (sth * fac2 * fac2);
  c[36] = r1 * (r1 * rho22 - a2sth2 * fac1) * ir23;
  c[37] = C.neg_a * r1 * dth2 * ir2;
  c[38] = dth * (0.25f * fac2 * fac2 * cth / sth + a2 * r1 * s2th) * ir22;
  c[39] = (C.neg_a * r1sth2 * rho22 + a3 * sth4 * fac1) * ir23;
}

__device__ __forceinline__ void geodesic_rhs(const float *c, const float *k,
                                             float *dk) {
  const float q[10] = {k[0] * k[0],        2.0f * k[0] * k[1],
                       2.0f * k[0] * k[2], 2.0f * k[0] * k[3],
                       k[1] * k[1],        2.0f * k[1] * k[2],
                       2.0f * k[1] * k[3], k[2] * k[2],
                       2.0f * k[2] * k[3], k[3] * k[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s = c[10 * i] * q[0];
#pragma unroll
    for (int j = 1; j < 10; ++j) s = s + c[10 * i + j] * q[j];
    dk[i] = -s;
  }
}

__device__ __forceinline__ float step_size(float x1, float x2, float k1,
                                           float k2, float k3, float x2_stop) {
  const float eps = (float)EPS_D, se = 0.04f;
  const float dl1 = se * x1 / (fabsf(k1) + eps);
  const float dl2 = se * jmin(x2, x2_stop - x2) / (fabsf(k2) + eps);
  const float dl3 = (1.0f / (fabsf(k3) + eps)) * se;
  return 1.0f / (1.0f / (fabsf(dl1) + eps) + 1.0f / (fabsf(dl2) + eps) +
                 1.0f / (fabsf(dl3) + eps));
}

// ---------------------------------------------------------------------------
// phase B: the fluid and the opacities
// ---------------------------------------------------------------------------

constexpr int HC_NX = 41, HC_NY = 31, K2_N = 25, ROW_W = 44, NC = 11;
constexpr int RAW_W = 32, RAW_NC = 8;

struct BScal {  // order = hot_kernels._B_SCAL
  double x_start1, x_start2, x_stop1, x_stop2, dx1, dx2, n1, n2, b_unit,
      d_tau_k, weight_min, stall_steps, tau_cap, hc_xlo, hc_xhi,
      hc_ylo, hc_yhi, k2_lo, k2_hi, inv_dx1, inv_dx2, inv_b_unit, inv_hpl,
      inv_mecc, inv_hc_xdiff, inv_hc_ydiff, inv_k2_diff, inv_cl, inv_24,
      inv_2pimecl, inv_weight_min, inv_tp_over_te;
  double k2c[K2_N];
};
constexpr int B_NSCAL = sizeof(BScal) / sizeof(double);

struct BConst {
  float x_start1, x_start2, x_stop1, x_stop2, dx1, dx2, b_unit, half_dtk,
      weight_min, tau_cap, hc_xlo, hc_xhi, hc_xsum, hc_xdiff, hc_ylo, hc_yhi,
      hc_ysum, hc_ydiff, k2_lo, k2_hi, k2_sum, k2_diff, inv_dx1, inv_dx2,
      inv_b_unit, inv_hpl, inv_mecc, inv_hc_xdiff, inv_hc_ydiff, inv_k2_diff,
      inv_cl, inv_24, inv_2pimecl, inv_weight_min, inv_tp_over_te;
  float k2c[K2_N];
  int n1, n2, stall_steps;
  // raw rows only: the metric pair and the primitives' units
  float a, a2, neg_a, r_0, two_pi, pi, half_1mh, one_mh, n_e_unit, theta_e_unit;
};

__device__ __forceinline__ float hc_klein_nishina(float w) {
  const float series = 1.0f - 2.0f * w;
  const float ws = jmax(w, 1.0e-6f);
  const float full =
      0.75f * ((1.0f / (ws * ws)) * 2.0f +
               (1.0f / (2.0f * ws) - (1.0f + ws) / (ws * ws * ws)) *
                   log1pf(2.0f * ws) +
               (1.0f + ws) / ((1.0f + 2.0f * ws) * (1.0f + 2.0f * ws)));
  return (w < 1.0e-3f) ? series : full;
}

__device__ __forceinline__ float k2_eval(float te, const BConst &C) {
  const float l_t = jclip(logf(jmax(te, 0.3f)), C.k2_lo, C.k2_hi);
  const float t = (2.0f * l_t - C.k2_sum) * C.inv_k2_diff;
  const float t2 = 2.0f * t;
  float b1 = 0.0f, b2 = 0.0f;
#pragma unroll
  for (int k = K2_N - 1; k > 0; --k) {
    const float nb = C.k2c[k] + t2 * b1 - b2;
    b2 = b1;
    b1 = nb;
  }
  const float interp = expf(C.k2c[0] + t * b1 - b2);
  const float out = (te > 100.0f) ? 2.0f * te * te : interp;
  return (te < 0.3f) ? 0.0f : out;
}

__device__ __forceinline__ float b_nu(float nu, float te, const BConst &C) {
  const float x = (float)HPL_D * nu /
                  ((float)(ME_D * CL_D * CL_D) * te + (float)EPS_D);
  const float pref = ((float)(2.0 * HPL_D) * nu) * (nu * C.inv_cl) * (nu * C.inv_cl);
  const float series =
      pref / (x * C.inv_24 * (24.0f + x * (12.0f + x * (4.0f + x))) +
              (float)EPS_D);
  const float full = pref / (expf(jmin(x, 80.0f)) - 1.0f + (float)EPS_D);
  return (x < 1.0e-3f) ? series : full;
}

__device__ __forceinline__ float synch(float nu, float n_e, float te, float b,
                                       float sin_th, float k2, const BConst &C) {
  const float nu_c = (float)EE_D * b * C.inv_2pimecl;
  const float nu_s = (float)(2.0 / 9.0) * nu_c * te * te * sin_th;
  const float x = nu / (nu_s + (float)EPS_D);
  const float xp = expf(logf(jmax(x, 1e-37f)) * (float)(1.0 / 3.0));
  const float xx = sqrtf(x) + (float)1.88774862536 * sqrtf(xp);
  const float f = xx * xx;
  const float val =
      (float)(1.4142135623730951 * PI_D * EE_D * EE_D / (3.0 * CL_D)) * n_e *
      nu_s / (k2 + (float)EPS_D) * f * expf(-xp);
  const bool bad = (te < 0.3f) || (nu > 1.0e12f * nu_s) || (k2 <= 0.0f);
  return bad ? 0.0f : val;
}

// The covariant and contravariant MKS metric at (x1, x2) (geometry.gcov_c,
// gcon_c): g = (g00, g01, g03, g11, g13, g22, g33), gc = (gc00, gc01, gc11,
// gc13, gc22, gc33).
__device__ __forceinline__ void metric_pair(float x1, float x2, const BConst &C,
                                            float *g, float *gc) {
  const float eps = (float)EPS_D;
  const float r = expf(x1) + C.r_0;
  const float th = C.pi * x2 + C.half_1mh * sinf(C.two_pi * x2);
  const float sth = fabsf(sinf(th)) + eps;
  const float cth = cosf(th);
  const float s2 = sth * sth;
  const float rho2 = r * r + C.a2 * cth * cth;
  const float tworr = 2.0f * r / rho2;
  const float rfac = r - C.r_0;
  const float hfac = C.pi * (1.0f + C.one_mh * cosf(C.two_pi * x2));
  g[0] = -1.0f + tworr;
  g[1] = tworr * rfac;
  g[2] = C.neg_a * s2 * tworr;
  g[3] = (1.0f + tworr) * rfac * rfac;
  g[4] = C.neg_a * s2 * (1.0f + tworr) * rfac;
  g[5] = rho2 * hfac * hfac;
  g[6] = s2 * (rho2 + C.a2 * s2 * (1.0f + tworr));
  const float irho2 = 1.0f / (r * r + C.a2 * cth * cth);
  gc[0] = -1.0f - 2.0f * r * irho2;
  gc[1] = 2.0f * irho2;
  gc[2] = irho2 * (r * (r - 2.0f) + C.a2) / (r * r);
  gc[3] = C.a * irho2 / r;
  gc[4] = irho2 / (hfac * hfac);
  gc[5] = irho2 / (sth * sth);
}

// v_mu = g_{mu nu} v^nu (geometry.lower_c)
__device__ __forceinline__ void lower(const float *g, const float *v, float *out) {
  out[0] = g[0] * v[0] + g[1] * v[1] + g[2] * v[3];
  out[1] = g[1] * v[0] + g[3] * v[1] + g[4] * v[3];
  out[2] = g[5] * v[2];
  out[3] = g[2] * v[0] + g[4] * v[1] + g[6] * v[3];
}

// u_mu, b_mu and |B| from the blended primitives (fluid._four_vectors_c)
__device__ __forceinline__ void four_vectors(const float *pr, const float *g,
                                             const float *gc, const BConst &C,
                                             float *u_cov, float *b_cov,
                                             float *b_mag) {
  const float v1 = pr[2], v2 = pr[3], v3 = pr[4];
  const float b1 = pr[5], b2 = pr[6], b3 = pr[7];
  const float v_dot_v = g[3] * v1 * v1 + g[5] * v2 * v2 + g[6] * v3 * v3 +
                        2.0f * g[4] * v1 * v3;
  const float v_fac = sqrtf(-1.0f / gc[0] * (1.0f + fabsf(v_dot_v)));
  const float u0 = -v_fac * gc[0];
  const float u1 = v1 - v_fac * gc[1];
  const float u_con[4] = {u0, u1, v2, v3};
  lower(g, u_con, u_cov);
  const float u_dot_bp = u_cov[1] * b1 + u_cov[2] * b2 + u_cov[3] * b3;
  const float b_con[4] = {u_dot_bp, (b1 + u1 * u_dot_bp) / u0,
                          (b2 + v2 * u_dot_bp) / u0, (b3 + v3 * u_dot_bp) / u0};
  lower(g, b_con, b_cov);
  const float bsq = b_con[0] * b_cov[0] + b_con[1] * b_cov[1] +
                    b_con[2] * b_cov[2] + b_con[3] * b_cov[3];
  *b_mag = sqrtf(fabsf(bsq)) * C.b_unit;
}

// ---------------------------------------------------------------------------
// the fused hot step
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int HC_PITCH = 32;  // a staged coefficient row: 31 floats and a pad
constexpr int HC_F4 = HC_NX * HC_PITCH / 4;  // float4s of the staged surface

// T_ix(tx) by the recurrence, ix = 0, 1, 2, ... in turn.
__device__ __forceinline__ float cheb_next(int ix, float tx, float &tm1, float &tm2) {
  if (ix == 0) return 1.0f;
  if (ix == 1) return tx;
  const float t = 2.0f * tx * tm1 - tm2;
  tm2 = tm1;
  tm1 = t;
  return t;
}

// sigma_hot(w, theta_e) [cm^2] from the Chebyshev surface
// (cheb.hotcross_eval), its rows staged in shared memory at hs (HC_PITCH
// floats a row), each read as eight broadcast float4 loads.  kPlainOrder =
// false (the derived variant, as the shipped profile was measured): s_ix =
// sum_j c[ix, j] T_j(ty), then sum_ix T_ix(tx) s_ix.  kPlainOrder = true
// (the raw variant): the order of the plain version, u_j = sum_ix T_ix(tx)
// c[ix, j] as one fused multiply-add chain in ix order (each row's dot
// product of the float32 matrix product), then sum_j u_j T_j(ty), T_j
// built after the sum so that it holds no registers across it.
template <bool kPlainOrder>
__device__ __forceinline__ float hotcross(float w, float te, const BConst &C,
                                          const float4 *hs) {
  const float l_w = jclip(log10f(jmax(w, 1e-30f)), C.hc_xlo, C.hc_xhi);
  const float l_t = jclip(log10f(jmax(te, 1e-30f)), C.hc_ylo, C.hc_yhi);
  const float tx = (2.0f * l_w - C.hc_xsum) * C.inv_hc_xdiff;
  const float ty = (2.0f * l_t - C.hc_ysum) * C.inv_hc_ydiff;
  float acc = 0.0f, tm2 = 1.0f, tm1 = tx;
  float u[HC_NY], by[HC_NY];
  if constexpr (kPlainOrder) {
#pragma unroll
    for (int j = 0; j < HC_NY; ++j) u[j] = 0.0f;
  } else {
    by[0] = 1.0f;
    by[1] = ty;
#pragma unroll
    for (int j = 2; j < HC_NY; ++j) by[j] = 2.0f * ty * by[j - 1] - by[j - 2];
  }
#pragma unroll 1
  for (int ix = 0; ix < HC_NX; ++ix) {
    const float t = cheb_next(ix, tx, tm1, tm2);
    float c[HC_PITCH];
#pragma unroll
    for (int q = 0; q < HC_PITCH / 4; ++q) {
      const float4 v = hs[ix * (HC_PITCH / 4) + q];
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
    if constexpr (kPlainOrder) {
#pragma unroll
      for (int j = 0; j < HC_NY; ++j) u[j] = __fmaf_rn(t, c[j], u[j]);
    } else {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < HC_NY; ++j) s += c[j] * by[j];
      acc += t * s;
    }
  }
  if constexpr (kPlainOrder) {
    float bm2 = 1.0f, bm1 = ty;
#pragma unroll
    for (int j = 0; j < HC_NY; ++j) acc += u[j] * cheb_next(j, ty, bm1, bm2);
  }
  const float interp = expf(acc * (float)2.302585092994046);
  const float cold = hc_klein_nishina(w) * (float)SIGMA_T_D;
  const float out = (te < 1.0e-4f) ? cold : interp;
  return (w * te < 1.0e-6f) ? (float)SIGMA_T_D : out;
}

// A lane's corner row, the W floats at table[z * W], into row[], fetched by
// the warp: its 32 rows are staged in shared memory (`stage`, 32 rows at a
// pitch of an odd number of float4s), neighbouring lanes loading one row's
// float4s, then each lane reads its own.
template <int W>
__device__ __forceinline__ void fetch_row(const float *table, int z, int lane,
                                          float4 *stage, float *row) {
  constexpr int NQ = W / 4, PITCH = NQ | 1;
  const float4 *tab = reinterpret_cast<const float4 *>(table);
#pragma unroll
  for (int it = 0; it < NQ; ++it) {
    const int idx = it * 32 + lane;
    const int r = idx / NQ, q = idx - r * NQ;
    const int zr = __shfl_sync(FULL, z, r);
    stage[r * PITCH + q] = __ldg(tab + (size_t)zr * NQ + q);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 v = stage[lane * PITCH + q];
    row[4 * q] = v.x;
    row[4 * q + 1] = v.y;
    row[4 * q + 2] = v.z;
    row[4 * q + 3] = v.w;
  }
}

struct HotPtrs {  // order = hot_kernels._HOT_PTRS
  // the pre-step pool
  const float *x0, *x1, *x2, *x3, *k0, *k1, *k2, *k3, *d0, *d1, *d2, *d3;
  const float *e_0_s, *dl_shrink, *pend_dl;
  const u8 *pend_push, *at_event, *alive;
  const float *w;
  const u8 *record_pending;
  const float *alpha_scatti, *alpha_absi, *bi, *tau_abs, *tau_scatt;
  const u8 *interacting;
  const float *sec_w;
  const int32_t *n_step;
  const u8 *occupied;
  // the step's uniforms, the bias scale (one float), the corner table and
  // the (41, 31) hotcross surface
  const float *u_roul, *u_x1, *bias_scale, *table, *hc;
  // the census counters (int64 scalars), added to in place
  unsigned long long *ls_iters, *ls_slots, *ls_occupied, *ls_moving, *ls_committed,
      *ls_parked, *n_hc_clamp;
  // the post-step pool
  float *ox0, *ox1, *ox2, *ox3, *ok0, *ok1, *ok2, *ok3, *od0, *od1, *od2, *od3;
  float *oe_0_s, *odl_shrink, *opend_dl;
  u8 *opend_push, *oat_event, *oalive;
  float *ow;
  u8 *orecord_pending;
  float *oalpha_scatti, *oalpha_absi, *obi, *otau_abs, *otau_scatt;
  u8 *ointeracting;
  float *osec_w;
  int32_t *on_step;
  // the shipped profile only: the detached-event registers in and out, and
  // occupied out (reference semantics pass the pointers before ev_x0)
  const float *ev_x0, *ev_x1, *ev_x2, *ev_x3, *ev_k0, *ev_k1, *ev_k2, *ev_k3, *ev_w;
  const u8 *ev_pending;
  float *oev_x0, *oev_x1, *oev_x2, *oev_x3, *oev_k0, *oev_k1, *oev_k2, *oev_k3, *oev_w;
  u8 *oev_pending, *ooccupied;
};
constexpr int HOT_NPTRS = sizeof(HotPtrs) / sizeof(void *);
constexpr int HOT_REF_NPTRS = offsetof(HotPtrs, ev_x0) / sizeof(void *);

struct HotScal {  // order = hot_kernels._HOT_SCAL
  AScal a;
  BScal b;
  double n_e_unit, theta_e_unit;
};
constexpr int HOT_NSCAL = sizeof(HotScal) / sizeof(double);

// kRef = false: the shipped profile (kernel A's step control and optical
// depth cap, the derived 44-wide row from hot_tab, the dl_shrink clamp and
// the detached-event capture); kRef = true: reference semantics (the
// ladder, the raw 32-wide row from corner_rows through the metric pair, no
// clamp, no capture).  Lanes at or past n compute lane n - 1 and store
// nothing, so that every lane of a warp reaches its shuffles and ballots.
template <bool kRef>
__host__ __device__ constexpr int smem_bytes() {  // the staged surface, the warps' row stages
  return 16 * (HC_F4 + WARPS * 32 * (((kRef ? RAW_W : ROW_W) / 4) | 1));
}

template <bool kRef>
__global__ void __launch_bounds__(THREADS, 2)
    hot_step_kernel(const HotPtrs P, const AConst CA, const BConst CB, int n) {
  constexpr int W = kRef ? RAW_W : ROW_W, M = kRef ? RAW_NC : NC;
  constexpr int PITCH = (W / 4) | 1;
  extern __shared__ float4 smem[];  // smem_bytes<kRef>()
  __shared__ unsigned census[5];
  const float4 *hs = smem;
  float4 *stage = smem + HC_F4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = blockIdx.x * THREADS + threadIdx.x;
  const bool valid = i0 < n;
  const int i = valid ? i0 : n - 1;
  const float eps = (float)EPS_D;
  if (threadIdx.x < 5) census[threadIdx.x] = 0u;
  for (int t = threadIdx.x; t < HC_NX * HC_PITCH; t += THREADS) {
    const int ix = t / HC_PITCH, j = t - ix * HC_PITCH;
    reinterpret_cast<float *>(smem)[t] = j < HC_NY ? __ldg(P.hc + ix * HC_NY + j) : 0.0f;
  }
  __syncthreads();

  // ---- phase A (engine.hot_phase_a) ----
  float x[4] = {P.x0[i], P.x1[i], P.x2[i], P.x3[i]};
  float k[4] = {P.k0[i], P.k1[i], P.k2[i], P.k3[i]};
  float dk[4] = {P.d0[i], P.d1[i], P.d2[i], P.d3[i]};
  const float e_0_s = P.e_0_s[i], dl_shrink = P.dl_shrink[i];
  const float pend_dl = P.pend_dl[i], w = P.w[i];
  const bool pend_push = P.pend_push[i], at_event = P.at_event[i];
  const bool alive = P.alive[i], record_pending = P.record_pending[i];
  const float alpha_scatti = P.alpha_scatti[i], alpha_absi = P.alpha_absi[i];
  const float bi = P.bi[i];

  const bool moving = alive && !at_event;
  const float dl_full =
      pend_push ? pend_dl : step_size(x[1], x[2], k[1], k[2], k[3], CA.x_stop2);
  float seg = dl_full * dl_shrink;
  if (pend_push) seg = jmin(seg, dl_full);
  if (!kRef && !pend_push) {  // cap the biased scattering depth a grown step carries
    const float seg_tau =
        (1.0f / (CA.half_dtk * alpha_scatti * bi + eps)) * CA.grow_tau_cap;
    seg = jmin(seg, jmax(seg_tau, dl_full));
  }
  const bool at_floor = dl_shrink <= CA.shrink_floor;
  const bool act = moving && !(x[1] < CA.x_start1);

  // one implicit-midpoint attempt (harm_model.cpp:1217-1289)
  const float dl_2 = 0.5f * seg;
  float k_half[4], k_pred[4], x_new[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    k_half[m] = k[m] + dk[m] * dl_2;
    k_pred[m] = k_half[m] + dk[m] * dl_2;
    x_new[m] = x[m] + k_half[m] * seg;
  }
  float conn[40];
  connection(x_new[1], x_new[2], CA, conn);
  // metric row 0 at x_new
  const float r = expf(x_new[1]) + CA.r_0;
  const float th = CA.pi * x_new[2] + CA.half_1mh * sinf(CA.two_pi * x_new[2]);
  const float sth = fabsf(sinf(th)) + eps;
  const float cth = cosf(th);
  const float rho2 = r * r + CA.a2 * cth * cth;
  const float tworr = 2.0f * r / rho2;
  const float g00 = -1.0f + tworr;
  const float g01 = tworr * (r - CA.r_0);
  const float g03 = CA.neg_a * sth * sth * tworr;

  float err = 0.0f;
  float dk_new[4] = {dk[0], dk[1], dk[2], dk[3]};
  for (int it = 0; it < CA.fp_iters; ++it) {
    geodesic_rhs(conn, k_pred, dk_new);
    float k_next[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) k_next[m] = k_half[m] + dl_2 * dk_new[m];
    const float kscale = fabsf(k_next[0]) + fabsf(k_next[1]) +
                         fabsf(k_next[2]) + fabsf(k_next[3]) + eps;
    err = (fabsf(k_pred[0] - k_next[0]) + fabsf(k_pred[1] - k_next[1]) +
           fabsf(k_pred[2] - k_next[2]) + fabsf(k_pred[3] - k_next[3])) /
          kscale;
#pragma unroll
    for (int m = 0; m < 4; ++m) k_pred[m] = k_next[m];
  }
  const float e_1 = -(k_pred[0] * g00 + k_pred[1] * g01 + k_pred[3] * g03);
  const float err_e = fabsf((e_1 - e_0_s) / (e_0_s + eps));
  const bool bad = (err_e > 1.0e-4f) || (err > 1.0e-3f) || !isfinite(err);
  const bool commit = act && (!bad || at_floor);
  if (commit) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      x[m] = x_new[m];
      k[m] = k_pred[m];
      dk[m] = dk_new[m];
    }
  }
  const float e0sn = commit ? e_1 : e_0_s;
  const float err_r = jmax(err * CA.inv_e_tol, err_e * CA.inv_e_drift_tol);

  float dl_shrink_n;
  if constexpr (kRef) {  // halve a failed attempt, else double
    dl_shrink_n = (act && !commit) ? jmax(dl_shrink * 0.5f, CA.shrink_floor)
                                   : jmin(dl_shrink * 2.0f, CA.grow_cap);
  } else {  // error-proportional step control: fac = safety / sqrt(err), clamped
    float err_eff = isfinite(err_r) ? err_r : 1.0e12f;
    if (!act) err_eff = 1.0e-12f;  // idle lanes re-grow
    const float fac =
        jclip(CA.step_ctrl * rsqrtf(jmax(err_eff, 1.0e-12f)), 0.25f, 2.0f);
    dl_shrink_n = jclip(dl_shrink * fac, CA.shrink_floor, CA.grow_cap);
  }

  const float pend_rem = (pend_push && commit) ? pend_dl - seg : pend_dl;
  const bool arrived = moving && pend_push && commit && (pend_rem <= 0.0f);

  // stop criterion + roulette (harm_model.cpp:1589-1616)
  const bool checkable = (moving && commit && !arrived) || (moving && !act);
  const bool horizon = x[1] < CA.x1_min;
  const bool escaped = x[1] > (float)4.605170185988092;  // ln R_MAX
  const bool small = w < CA.weight_min;
  const bool win = P.u_roul[i] <= (float)(1.0 / 1.0e4);
  const float w_roul = win ? w * 1.0e4f : 0.0f;
  const float w_a = (checkable && small && !horizon) ? w_roul : w;
  const bool killed_inside = checkable && small && !horizon && !escaped && !win;
  const bool stopped = checkable && (horizon || escaped || killed_inside);
  const bool record = checkable && escaped && !horizon;
  const bool pend_push_a = pend_push && !arrived, at_event_a = at_event || arrived;
  const bool alive_a = alive && !stopped;
  const bool grown = !pend_push && (dl_shrink > 1.0f);

  // bilinear cell (harm_model.cpp:1406-1434)
  const float fia = floorf((x[1] - CA.x_start1) * CA.inv_dx1 - 0.5f);
  const float fja = floorf((x[2] - CA.x_start2) * CA.inv_dx2 - 0.5f);
  const int ii = (int)fminf(fmaxf(fia, 0.0f), (float)(CA.n1 - 2));
  const int jj = (int)fminf(fmaxf(fja, 0.0f), (float)(CA.n2 - 2));
  const int z = ii * CA.n2 + jj;

  // ---- the corner row at z: derived (fluid.blend_derived) or raw (fluid.blend_raw) ----
  float row[W];
  fetch_row<W>(P.table, z, lane, stage + warp * 32 * PITCH, row);

  // ---- phase B (engine.hot_phase_b) ----
  bool inter = moving && commit && !pend_push && !stopped;
  const float x1 = x[1], x2 = x[2];
  const bool inside = (x1 >= CB.x_start1) && (x1 <= CB.x_stop1) &&
                      (x2 >= CB.x_start2) && (x2 <= CB.x_stop2);
  const float fi = floorf((x1 - CB.x_start1) * CB.inv_dx1 - 0.5f);
  const float fj = floorf((x2 - CB.x_start2) * CB.inv_dx2 - 0.5f);
  const float ci = fminf(fmaxf(fi, 0.0f), (float)(CB.n1 - 2));
  const float cj = fminf(fmaxf(fj, 0.0f), (float)(CB.n2 - 2));
  float del_i = (x1 - ((ci + 0.5f) * CB.dx1 + CB.x_start1)) * CB.inv_dx1;
  float del_j = (x2 - ((cj + 0.5f) * CB.dx2 + CB.x_start2)) * CB.inv_dx2;
  del_i = (fi < 0.0f) ? 0.0f : ((fi > (float)(CB.n1 - 2)) ? 1.0f : del_i);
  del_j = (fj < 0.0f) ? 0.0f : ((fj > (float)(CB.n2 - 2)) ? 1.0f : del_j);
  const float c00 = (1.0f - del_i) * (1.0f - del_j);
  const float c01 = (1.0f - del_i) * del_j;
  const float c10 = del_i * (1.0f - del_j);
  const float c11 = del_i * del_j;
  float pr[M];
#pragma unroll
  for (int m = 0; m < M; ++m)
    pr[m] = row[m] * c00 + row[M + m] * c01 + row[2 * M + m] * c10 +
            row[3 * M + m] * c11;
  float n_e, te, b_mag, u_cov[4], b_cov[4];
  if constexpr (kRef) {
    n_e = inside ? pr[0] * CB.n_e_unit : 0.0f;
    te = pr[1] / pr[0] * CB.theta_e_unit;
    float g[7], gc[6];
    metric_pair(x1, x2, CB, g, gc);
    four_vectors(pr, g, gc, CB, u_cov, b_cov, &b_mag);
  } else {
    n_e = inside ? pr[0] : 0.0f;
    te = pr[1] / pr[0];
    b_mag = pr[2];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      u_cov[m] = pr[3 + m];
      b_cov[m] = pr[7 + m];
    }
  }

  // kinematics (radiation.kinematics_sin_c)
  const float k_u = k[0] * u_cov[0] + k[1] * u_cov[1] + k[2] * u_cov[2] + k[3] * u_cov[3];
  const float k_b = k[0] * b_cov[0] + k[1] * b_cov[1] + k[2] * b_cov[2] + k[3] * b_cov[3];
  const float mu =
      jclip(k_b / (fabsf(k_u) * b_mag * CB.inv_b_unit + eps), -1.0f, 1.0f);
  const float sin_th = (b_mag == 0.0f) ? 1.0f : sqrtf(1.0f - mu * mu);
  const float nu = -k_u * (float)ME_D * (float)CL_D * (float)CL_D * CB.inv_hpl;

  const bool bound = n_e == 0.0f;
  const float nu_safe = fabsf(nu) + eps;
  const float e_g = (float)HPL_D * nu_safe * CB.inv_mecc;
  const float a_scf = nu_safe * hotcross<kRef>(e_g, te, CB, hs) * n_e;
  const bool hc_thomson = e_g * te < 1.0e-6f, hc_cold = te < 1.0e-4f;
  const bool hc_hit = !hc_thomson && !hc_cold &&
                      ((e_g <= 1.0e-12f) || (e_g >= 1.0e6f) || (te <= 1.0e-4f) ||
                       (te >= 1.0e4f)) &&
                      (n_e > 0.0f);
  const float j = synch(nu_safe, n_e, te, b_mag, sin_th, k2_eval(te, CB), CB);
  const float a_abf = nu_safe * j / (b_nu(nu_safe, te, CB) + eps);
  const float cap = 0.5f * w_a * CB.inv_weight_min;
  const float bf =
      jmin(jmax(P.bias_scale[0] * te * te, 3.0f), cap) * CB.inv_tp_over_te;

  const bool dead_branch = bound || (nu < 0.0f);
  // vacuum -> matter entry rollback of grown steps
  bool entry_roll = false;
  if constexpr (!kRef) {
    entry_roll = inter && grown && !dead_branch && (alpha_scatti <= 0.0f) &&
                 (alpha_absi <= 0.0f) && (n_e > 0.0f);
    inter = inter && !entry_roll;
  }

  const float half = CB.half_dtk * seg;
  const float d_tau_scatt =
      dead_branch ? alpha_scatti * half : (alpha_scatti + a_scf) * half;
  const float d_tau_abs =
      dead_branch ? alpha_absi * half : (alpha_absi + a_abf) * half;
  const float bias = dead_branch ? 0.0f : 0.5f * (bi + bf);

  const float alpha_scatti_b = inter ? (dead_branch ? 0.0f : a_scf) : alpha_scatti;
  const float alpha_absi_b = inter ? (dead_branch ? 0.0f : a_abf) : alpha_absi;
  const float bi_b = inter ? (dead_branch ? 0.0f : bf) : bi;

  const float x1r = -logf(P.u_x1[i] + 1e-30f);
  const float sec_w_new = w_a / jmax(bias, eps);
  const bool scatter = inter && (bias * d_tau_scatt > x1r) && (sec_w_new > CB.weight_min);
  const float frac = scatter ? x1r / (bias * d_tau_scatt + eps) : 1.0f;
  const float d_tau_abs_eff = d_tau_abs * frac;
  const float d_tau_scatt_eff = d_tau_scatt * frac;
  const bool absorbed = inter && (d_tau_abs_eff > 100.0f);
  const float d_tau = d_tau_abs_eff + d_tau_scatt_eff;
  const float decay =
      (d_tau < 1.0e-3f)
          ? 1.0f - d_tau * CB.inv_24 *
                       (24.0f - d_tau * (12.0f - d_tau * (4.0f - d_tau)))
          : expf(-jmin(d_tau, 200.0f));
  const bool live = inter && !absorbed;
  const bool roll = scatter && !absorbed;
  const bool roll_any = roll || entry_roll;

  const int32_t n_step_n = P.n_step[i] + (moving ? 1 : 0);
  const bool over = moving && (n_step_n > CB.stall_steps);

  // the scatter or entry rollback restores the pre-step state, read again
  float xo[4], ko[4], dko[4], e0so;
  if (roll_any) {
    xo[0] = P.x0[i]; xo[1] = P.x1[i]; xo[2] = P.x2[i]; xo[3] = P.x3[i];
    ko[0] = P.k0[i]; ko[1] = P.k1[i]; ko[2] = P.k2[i]; ko[3] = P.k3[i];
    dko[0] = P.d0[i]; dko[1] = P.d1[i]; dko[2] = P.d2[i]; dko[3] = P.d3[i];
    e0so = P.e_0_s[i];
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      xo[m] = x[m];
      ko[m] = k[m];
      dko[m] = dk[m];
    }
    e0so = e0sn;
  }
  const float sec_w_b = roll ? sec_w_new : P.sec_w[i];
  const bool alive_b = alive_a && !absorbed && !over;
  const float w_b = live ? w_a * decay : w_a;
  const bool hc_clamp = hc_hit && inter;

  // ---- the epilogue: dl_shrink clamp, detached-event capture (engine._capture_events) ----
  float dl_shrink_o = dl_shrink_n, w_o = w_b;
  float alpha_scatti_o = alpha_scatti_b, alpha_absi_o = alpha_absi_b, bi_o = bi_b;
  bool at_event_o = at_event_a, alive_o = alive_b, occupied_o = P.occupied[i];
  if constexpr (!kRef) {
    const bool tau_over = inter && (jmax(d_tau_scatt, d_tau_abs) > CB.tau_cap);
    if (tau_over || entry_roll) dl_shrink_o = jmin(dl_shrink_n, 1.0f);
    const bool ev_pending = P.ev_pending[i];
    const bool pdie = arrived && ((ko[0] > 1.0e5f) || (ko[0] < 0.0f) || isnan(ko[0]) ||
                                  isnan(ko[1]) || isnan(ko[3]));
    const bool capt = arrived && !ev_pending && !pdie;
    const bool neg = nu < 0.0f;
    at_event_o = at_event_a && !capt && !pdie;
    alive_o = alive_b && !pdie;
    occupied_o = occupied_o && !(pdie && !ev_pending);
    w_o = pdie ? 0.0f : w_b;
    if (capt) {
      alpha_scatti_o = neg ? 0.0f : a_scf;
      alpha_absi_o = neg ? 0.0f : a_abf;
      bi_o = bf;
    }
    if (valid) {
      P.oev_x0[i] = capt ? xo[0] : P.ev_x0[i];
      P.oev_x1[i] = capt ? xo[1] : P.ev_x1[i];
      P.oev_x2[i] = capt ? xo[2] : P.ev_x2[i];
      P.oev_x3[i] = capt ? xo[3] : P.ev_x3[i];
      P.oev_k0[i] = capt ? ko[0] : P.ev_k0[i];
      P.oev_k1[i] = capt ? ko[1] : P.ev_k1[i];
      P.oev_k2[i] = capt ? ko[2] : P.ev_k2[i];
      P.oev_k3[i] = capt ? ko[3] : P.ev_k3[i];
      P.oev_w[i] = capt ? sec_w_b : P.ev_w[i];
      P.oev_pending[i] = ev_pending || capt;
      P.ooccupied[i] = occupied_o;
    }
  }

  if (valid) {
    P.ox0[i] = xo[0]; P.ox1[i] = xo[1]; P.ox2[i] = xo[2]; P.ox3[i] = xo[3];
    P.ok0[i] = ko[0]; P.ok1[i] = ko[1]; P.ok2[i] = ko[2]; P.ok3[i] = ko[3];
    P.od0[i] = dko[0]; P.od1[i] = dko[1]; P.od2[i] = dko[2]; P.od3[i] = dko[3];
    P.oe_0_s[i] = e0so;
    P.odl_shrink[i] = dl_shrink_o;
    P.opend_dl[i] = roll ? seg * frac : pend_rem;
    P.opend_push[i] = pend_push_a || roll;
    P.oat_event[i] = at_event_o;
    P.oalive[i] = alive_o;
    P.ow[i] = w_o;
    P.orecord_pending[i] = record_pending || record;
    P.oalpha_scatti[i] = alpha_scatti_o;
    P.oalpha_absi[i] = alpha_absi_o;
    P.obi[i] = bi_o;
    const float tau_abs = P.tau_abs[i], tau_scatt = P.tau_scatt[i];
    P.otau_abs[i] = live ? tau_abs + d_tau_abs_eff : tau_abs;
    P.otau_scatt[i] = live ? tau_scatt + d_tau_scatt_eff : tau_scatt;
    P.ointeracting[i] =
        inter ? ((alpha_scatti_b > 0.0f) || (alpha_absi_b > 0.0f) || (n_e > 0.0f))
              : (bool)P.interacting[i];
    P.osec_w[i] = sec_w_b;
    P.on_step[i] = n_step_n;
  }

  // ---- the census (engine._util_counters and n_hc_clamp): warp ballots,
  // a block sum in shared memory, one 64-bit atomic per counter and block ----
  const unsigned c_occ = __popc(__ballot_sync(FULL, valid && occupied_o));
  const unsigned c_mov = __popc(__ballot_sync(FULL, valid && moving));
  const unsigned c_com = __popc(__ballot_sync(FULL, valid && commit));
  const unsigned c_par = __popc(__ballot_sync(FULL, valid && at_event_o));
  const unsigned c_hc = __popc(__ballot_sync(FULL, valid && hc_clamp));
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
    atomicAdd(P.ls_iters, 1ull);
    atomicAdd(P.ls_slots, (unsigned long long)n);
  }
}

AConst make_aconst(const AScal &S) {
  AConst C;
  C.a = (float)S.a;
  C.a2 = (float)(S.a * S.a);
  C.a3 = (float)(S.a * S.a * S.a);
  C.a4 = (float)(S.a * S.a * S.a * S.a);
  C.neg_a = (float)(-S.a);
  C.neg_a2 = (float)(-(S.a * S.a));
  C.neg_2a = (float)(-2.0 * S.a);
  C.r_0 = (float)S.r_0;
  C.two_pi = (float)(2.0 * PI_D);
  C.pi = (float)PI_D;
  C.half_1mh = (float)(0.5 * (1.0 - S.h_slope));
  C.one_mh = (float)(1.0 - S.h_slope);
  C.neg2pipi_1mh = (float)(-2.0 * PI_D * PI_D * (1.0 - S.h_slope));
  C.x_start1 = (float)S.x_start1;
  C.x_start2 = (float)S.x_start2;
  C.x_stop2 = (float)S.x_stop2;
  C.dx1 = (float)S.dx1;
  C.dx2 = (float)S.dx2;
  C.inv_dx1 = (float)S.inv_dx1;
  C.inv_dx2 = (float)S.inv_dx2;
  C.inv_e_tol = (float)S.inv_e_tol;
  C.inv_e_drift_tol = (float)S.inv_e_drift_tol;
  C.x1_min = (float)S.x1_min;
  C.half_dtk = (float)(0.5 * S.d_tau_k);
  C.weight_min = (float)S.weight_min;
  C.shrink_floor = (float)S.shrink_floor;
  C.grow_cap = (float)S.grow_cap;
  C.grow_tau_cap = (float)S.grow_tau_cap;
  C.step_ctrl = (float)S.step_ctrl;
  C.n1 = (int)S.n1;
  C.n2 = (int)S.n2;
  C.fp_iters = (int)S.fp_iters;
  return C;
}

BConst make_bconst(const BScal &S) {
  BConst C;
  C.x_start1 = (float)S.x_start1;
  C.x_start2 = (float)S.x_start2;
  C.x_stop1 = (float)S.x_stop1;
  C.x_stop2 = (float)S.x_stop2;
  C.dx1 = (float)S.dx1;
  C.dx2 = (float)S.dx2;
  C.b_unit = (float)S.b_unit;
  C.half_dtk = (float)(0.5 * S.d_tau_k);
  C.weight_min = (float)S.weight_min;
  C.tau_cap = (float)S.tau_cap;
  C.hc_xlo = (float)S.hc_xlo;
  C.hc_xhi = (float)S.hc_xhi;
  C.hc_xsum = (float)(S.hc_xhi + S.hc_xlo);
  C.hc_xdiff = (float)(S.hc_xhi - S.hc_xlo);
  C.hc_ylo = (float)S.hc_ylo;
  C.hc_yhi = (float)S.hc_yhi;
  C.hc_ysum = (float)(S.hc_yhi + S.hc_ylo);
  C.hc_ydiff = (float)(S.hc_yhi - S.hc_ylo);
  C.k2_lo = (float)S.k2_lo;
  C.k2_hi = (float)S.k2_hi;
  C.k2_sum = (float)(S.k2_hi + S.k2_lo);
  C.k2_diff = (float)(S.k2_hi - S.k2_lo);
  C.inv_dx1 = (float)S.inv_dx1;
  C.inv_dx2 = (float)S.inv_dx2;
  C.inv_b_unit = (float)S.inv_b_unit;
  C.inv_hpl = (float)S.inv_hpl;
  C.inv_mecc = (float)S.inv_mecc;
  C.inv_hc_xdiff = (float)S.inv_hc_xdiff;
  C.inv_hc_ydiff = (float)S.inv_hc_ydiff;
  C.inv_k2_diff = (float)S.inv_k2_diff;
  C.inv_cl = (float)S.inv_cl;
  C.inv_24 = (float)S.inv_24;
  C.inv_2pimecl = (float)S.inv_2pimecl;
  C.inv_weight_min = (float)S.inv_weight_min;
  C.inv_tp_over_te = (float)S.inv_tp_over_te;
  for (int q = 0; q < K2_N; ++q) C.k2c[q] = (float)S.k2c[q];
  C.n1 = (int)S.n1;
  C.n2 = (int)S.n2;
  C.stall_steps = (int)S.stall_steps;
  return C;
}

template <bool kRef>
int launch_hot(void **ptrs, const double *scal, int n, void *stream) {
  HotPtrs P;
  memset(&P, 0, sizeof(HotPtrs));
  memcpy(&P, ptrs, (kRef ? HOT_REF_NPTRS : HOT_NPTRS) * sizeof(void *));
  HotScal S;
  memcpy(&S, scal, sizeof(HotScal));
  const AConst CA = make_aconst(S.a);
  BConst CB = make_bconst(S.b);
  // the raw rows' metric pair and primitives' units (the derived rows read none)
  CB.a = CA.a;
  CB.a2 = CA.a2;
  CB.neg_a = CA.neg_a;
  CB.r_0 = CA.r_0;
  CB.two_pi = CA.two_pi;
  CB.pi = CA.pi;
  CB.half_1mh = CA.half_1mh;
  CB.one_mh = CA.one_mh;
  CB.n_e_unit = (float)S.n_e_unit;
  CB.theta_e_unit = (float)S.theta_e_unit;
  constexpr int smem = smem_bytes<kRef>();
  static bool sized = false;  // dynamic shared memory above 48 KB is asked for once
  if (!sized) {
    const cudaError_t rc = cudaFuncSetAttribute(
        hot_step_kernel<kRef>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != cudaSuccess) return (int)rc;
    sized = true;
  }
  if (n > 0) {
    hot_step_kernel<kRef><<<(n + THREADS - 1) / THREADS, THREADS, smem,
                            (cudaStream_t)stream>>>(P, CA, CB, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int hot_step_nptrs() { return HOT_NPTRS; }
int hot_step_nscal() { return HOT_NSCAL; }
int hot_step_ref_nptrs() { return HOT_REF_NPTRS; }
int hot_step_ref_nscal() { return HOT_NSCAL; }

int hot_step_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_hot<false>(ptrs, scal, n, stream);
}

int hot_step_ref_launch(void **ptrs, const double *scal, int n, void *stream) {
  return launch_hot<true>(ptrs, scal, n, stream);
}

}  // extern "C"
