"""The batched geodesic transport engine.

Port of ``grmonty_tpu/transport/engine.py`` for two sets of physics: the
shipped profile, and reference semantics (``EngineConfig.reference``).
Photons are an SoA pool of (N,) tensors stepped in lockstep:

* the **hot step** (:meth:`Engine.hot_step`) runs phase A (step size, one
  implicit-midpoint Kerr push, step control, stop test and roulette, cell
  index), the corner row at the new cell, phase B (fluid blend, opacities,
  scatter decision, weight decay), the detached-event capture and the
  lane-slot census — on CUDA tensors as one hand-written kernel
  (``hot_kernels.hot_step``), on CPU tensors as the plain
  :func:`hot_step_plain`.  The shipped profile blends the derived 44-wide
  corner rows, reference semantics the raw 32-wide rows;
* every ``refill_period`` iterations a **light phase** records escaped
  photons and refills free lanes; every ``m_period`` iterations the **full
  phase** also runs the deferred scattering events;
* :meth:`Engine.run` loops those blocks on the host, reading the exit
  condition once per ``m_period`` block (and logging its progress every
  ``PROGRESS_ITERS`` iterations of a long run).

RNG: one ``torch.Generator`` per engine; every draw site takes a whole
batch from it.  The hot phases take their uniforms as arguments, so the
kernels and the plain versions are comparable on identical inputs.
"""

import logging
import typing

import numpy as np
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.ops import fluid, geometry, radiation, scattering
from grmonty_tpu_torch.ops import hotcross as hc_mod

N_SPEC_CHAN = 16  # 13 reference channels + sum((w*e)^2), secondary count,
#   summed birth generation (see grmonty_tpu/transport/engine.py)
N_BINS = consts.N_TH_BINS * consts.N_E_BINS
DUMP_BIN = N_BINS  # overflow row for masked-out scatter-adds

# Packed photon rows of the backlog and the secondary ring (photon.hpp:41-52).
(ROW_W, ROW_E, ROW_L, ROW_NE0, ROW_THETAE0, ROW_B0, ROW_E0, ROW_NSCATT) = range(8, 16)
ROW_WIDTH = 16

SHRINK_FLOOR = float(2.0 ** (-consts.MAX_HALVING_DEPTH))
EV_HALVE = 16  # halve the event sampler's theta_e every this many defers
EV_FORCE = 32  # force-accept the event sampler's draw at this many defers
MAX_OUTER = 50_000_000  # safety cap on hot iterations per run()
PROGRESS_ITERS = 1 << 16  # a long run() logs its progress every this many iterations
# Photon weights are scaled into float32 range; the spectrum is unscaled
# at report time (driver.unscale_spectrum).
WEIGHT_SCALE = 1.0e-25
WEIGHT_MIN = consts.WEIGHT_MIN * WEIGHT_SCALE

log = logging.getLogger(__name__)

# The shipped profile's physics (grmonty_tpu/transport/profiles.py), fixed
# here: see ``EngineConfig`` in grmonty_tpu/transport/engine.py for each
# one's measured rationale.  Its scatter events are detached: a parent
# continues at once and its event waits in shadow registers for the full
# phase.  ``EngineConfig.reference`` replaces all of it but FP_ITERS.
FP_ITERS = 2  # implicit-midpoint fixed-point rounds (both semantics)
STEP_CTRL = 0.6  # safety of the error-proportional step control
GROW_TAU_CAP = 0.01  # optical-depth cap of a grown step
BIAS_EMA = 0.25  # EMA weight of the windowed scattering-bias feedback


class EngineConfig(typing.NamedTuple):
    """Widths, the knobs the final drain overrides
    (``driver.Simulation.tail_engine``), and the one switch of semantics;
    the defaults are the shipped profile's."""

    n_pool: int = 16384  # concurrently tracked photons
    m_period: int = 16  # hot iterations between full periodic phases
    sec_cap: int = 65536  # secondary ring capacity
    tail_exit: int = 0  # run() may end once at most this many lanes remain
    stall_steps: int = consts.MAX_N_STEP  # per-photon step cap
    ev_k: int = 0  # compacted width of the event phase (0 = n_pool/8)
    refill_k: int = 0  # compacted width of the refill (0 = ev_k)
    light_k: int = 0  # width of the light phases (0 = min(ev_k, refill_k))
    refill_period: int = 4  # light-phase cadence (0 = off); divides m_period
    # Upper clamp of the per-lane step factor.  Outside reference semantics
    # the grown-step optical-depth cap is always on; at grow_cap <= 1 no
    # step grows and it changes nothing.
    grow_cap: float = 8.0
    dtype: torch.dtype = torch.float64
    # Reference semantics wholesale, as the JAX ``profiles.bench_config(
    # ref_mode=True)``: the halve/double step ladder capped at grow_cap,
    # no optical-depth cap, scatter events parked at_event for the full
    # phase, the cumulative bias n_scatt_rec/(n_recorded+1), the raw
    # corner rows in the hot step and the fresh-lane init, and (in the
    # driver) rejection emission in plan order.
    reference: bool = False
    # The frozen-bias comparison mode, for validation only (the accuracy
    # gate, grmonty_tpu_torch.tools.validate_accuracy): when bias_fixed_tau
    # > 0 the scattering-bias normalization max_tau * (avg + 2) reads
    # bias_fixed_tau * (bias_fixed_avg + 2) instead of the live feedback
    # counters, as the native tracker's Consts.bias_fixed_tau does, so that
    # the two trackers' secondary populations are comparable.  Production
    # runs use the live feedback.
    bias_fixed_tau: float = 0.0
    bias_fixed_avg: float = 2.0
    # A diagnostic, off in production: carry each lane's birth state (x, k,
    # w at load: Pool.bx/bk/bw) and capture, at record time, the birth
    # state of the photon holding the max_tau_scatt ratchet (Counters.mt_*),
    # for the deep-tau replay harness (grmonty_tpu_torch.tools.
    # replay_deep_tau), which replays it through the native tracker's
    # nominal steps.  It draws no random number and changes no other field.
    trace_birth: bool = False


class EngineTables(typing.NamedTuple):
    """Per-dump device tables shared by every engine of a run."""

    hc_coeffs: torch.Tensor  # (41, 31) Chebyshev hotcross surface
    k2_coeffs: np.ndarray  # (25,) host Chebyshev K2 series
    corner_rows: torch.Tensor  # (Z, 32) raw bilinear corners (event phase;
    #   the hot step and the fresh-lane init under reference semantics)
    hot_tab: torch.Tensor  # (Z, 44) derived bilinear corners (shipped hot step)


class Pool(typing.NamedTuple):
    x: tuple  # 4 x (N,)
    k: tuple
    dkdlam: tuple
    w: torch.Tensor
    e: torch.Tensor
    l: torch.Tensor
    x1i: torch.Tensor
    x2i: torch.Tensor
    tau_abs: torch.Tensor
    tau_scatt: torch.Tensor
    n_e_0: torch.Tensor
    theta_e_0: torch.Tensor
    b_0: torch.Tensor
    e_0: torch.Tensor
    e_0_s: torch.Tensor
    alpha_scatti: torch.Tensor
    alpha_absi: torch.Tensor
    bi: torch.Tensor
    pend_dl: torch.Tensor  # remaining re-push length of a decided scatter
    dl_shrink: torch.Tensor  # per-lane adaptive step factor
    sec_w: torch.Tensor  # secondary weight frozen at decision time
    bx: tuple  # 4 x (N,) birth position (EngineConfig.trace_birth; else ())
    bk: tuple  # 4 x (N,) birth wave vector (trace_birth; else ())
    bw: torch.Tensor  # (N,) birth weight (trace_birth; else ())
    ev_x: tuple  # detached-event shadow registers: position,
    ev_k: tuple  # parent momentum,
    ev_w: torch.Tensor  # secondary weight,
    ev_pending: torch.Tensor  # and whether they hold an unconsumed event
    n_scatt: torch.Tensor  # int32
    nsc0: torch.Tensor  # int32 n_scatt at load (0 = primary)
    n_step: torch.Tensor  # int32
    ev_tries: torch.Tensor  # int32 phases this lane's event was deferred
    occupied: torch.Tensor  # bool: slot holds a photon
    alive: torch.Tensor  # still tracked
    interacting: torch.Tensor
    pend_push: torch.Tensor  # next hot iteration is the partial re-push
    at_event: torch.Tensor  # parked for the periodic scatter phase
    record_pending: torch.Tensor  # escaped; record at the next phase


class SecBuf(typing.NamedTuple):
    rows: torch.Tensor  # (S, 16) packed secondary photons
    count: torch.Tensor  # 0-d int64


class Counters(typing.NamedTuple):
    n_recorded: torch.Tensor  # all 0-d; int64 unless noted
    n_scatt_rec: torch.Tensor
    max_tau_scatt: torch.Tensor  # engine dtype
    n_created: torch.Tensor
    n_sec_drop: torch.Tensor
    n_retired: torch.Tensor
    n_steps_retired: torch.Tensor
    ls_iters: torch.Tensor  # lane-slot census of the hot iterations
    ls_slots: torch.Tensor
    ls_occupied: torch.Tensor
    ls_moving: torch.Tensor
    ls_committed: torch.Tensor
    ls_parked: torch.Tensor
    avg_ema: torch.Tensor  # engine dtype
    ema_scatt_mark: torch.Tensor
    ema_rec_mark: torch.Tensor
    n_stall: torch.Tensor  # lanes killed at the step cap
    w_stall: torch.Tensor  # engine dtype: their remaining weight
    n_ev_soft: torch.Tensor
    n_ev_forced: torch.Tensor
    n_hc_clamp: torch.Tensor
    # The birth state of the recorded photon holding the max_tau_scatt
    # ratchet (EngineConfig.trace_birth; zeros otherwise), engine dtype:
    mt_bx: torch.Tensor  # (4,) birth position
    mt_bk: torch.Tensor  # (4,) birth wave vector
    mt_bw: torch.Tensor  # birth weight
    mt_nsc0: torch.Tensor  # int64 birth generation


class State(typing.NamedTuple):
    pool: Pool
    spec: torch.Tensor  # (N_BINS + 1, N_SPEC_CHAN) engine dtype
    counters: Counters
    sec: SecBuf
    backlog_pos: torch.Tensor  # 0-d int64: next unconsumed primary
    it: int  # hot iterations run


def isnan4(v):
    return torch.isnan(v[0]) | torch.isnan(v[1]) | torch.isnan(v[2]) | torch.isnan(v[3])


def where4(m, a, b):
    return tuple(torch.where(m, ai, bi) for ai, bi in zip(a, b))


def empty_pool(n, dtype, device, trace_birth=False):
    def z():
        return torch.zeros(n, dtype=dtype, device=device)

    def zi():
        return torch.zeros(n, dtype=torch.int32, device=device)

    def zb():
        return torch.zeros(n, dtype=torch.bool, device=device)

    def z4():
        return (z(), z(), z(), z())

    return Pool(
        x=z4(), k=z4(), dkdlam=z4(), w=z(), e=z(), l=z(), x1i=z(), x2i=z(),
        tau_abs=z(), tau_scatt=z(), n_e_0=z(), theta_e_0=z(), b_0=z(), e_0=z(),
        e_0_s=z(), alpha_scatti=z(), alpha_absi=z(), bi=z(), pend_dl=z(),
        dl_shrink=torch.ones(n, dtype=dtype, device=device), sec_w=z(),
        bx=z4() if trace_birth else (), bk=z4() if trace_birth else (),
        bw=z() if trace_birth else (),
        ev_x=z4(), ev_k=z4(), ev_w=z(), ev_pending=zb(),
        n_scatt=zi(), nsc0=zi(), n_step=zi(), ev_tries=zi(),
        occupied=zb(), alive=zb(), interacting=zb(), pend_push=zb(),
        at_event=zb(), record_pending=zb(),
    )


def init_counters(max_tau_scatt_init, dtype, device):
    def zi():
        return torch.zeros((), dtype=torch.int64, device=device)

    def zf():
        return torch.zeros((), dtype=dtype, device=device)

    return Counters(
        n_recorded=zi(), n_scatt_rec=zi(),
        max_tau_scatt=torch.tensor(max_tau_scatt_init, dtype=dtype, device=device),
        n_created=zi(), n_sec_drop=zi(), n_retired=zi(), n_steps_retired=zi(),
        ls_iters=zi(), ls_slots=zi(), ls_occupied=zi(), ls_moving=zi(),
        ls_committed=zi(), ls_parked=zi(),
        avg_ema=zf(), ema_scatt_mark=zi(), ema_rec_mark=zi(),
        n_stall=zi(), w_stall=zf(), n_ev_soft=zi(), n_ev_forced=zi(), n_hc_clamp=zi(),
        mt_bx=torch.zeros(4, dtype=dtype, device=device),
        mt_bk=torch.zeros(4, dtype=dtype, device=device), mt_bw=zf(), mt_nsc0=zi(),
    )


def _util_counters(counters, occupied, moving, commit, parked):
    """Accumulate the per-iteration lane-slot census."""
    return counters._replace(
        ls_iters=counters.ls_iters + 1,
        ls_slots=counters.ls_slots + occupied.shape[0],
        ls_occupied=counters.ls_occupied + occupied.sum(),
        ls_moving=counters.ls_moving + moving.sum(),
        ls_committed=counters.ls_committed + commit.sum(),
        ls_parked=counters.ls_parked + parked.sum(),
    )


# ---------------------------------------------------------------------------
# the hot step, plain versions (the CUDA kernel of csrc/hot_step.cu computes
# hot_step_plain; hot_kernels.hot_step dispatches between them)
# ---------------------------------------------------------------------------

def push_attempt_c(x, k, dkdlam, e_0_s, seg_dl, active, at_floor, a, hs, r0):
    """ONE implicit-midpoint geodesic attempt (harm_model.cpp:1217-1289).

    Returns (x, k, dk, e0s, commit, err_ratio), ``err_ratio`` being the
    worst normalised error test (> 1 means the attempt failed)."""
    dl_2 = 0.5 * seg_dl
    k_half = tuple(kk + dd * dl_2 for kk, dd in zip(k, dkdlam))
    k_pred = tuple(kh + dd * dl_2 for kh, dd in zip(k_half, dkdlam))
    x_new = tuple(xx + kh * seg_dl for xx, kh in zip(x, k_half))

    conn = geometry.connection_c(x_new[1], x_new[2], a, hs)
    g00, g01, g03 = geometry.gcov_row0_c(x_new[1], x_new[2], a, hs, r0)

    err = torch.zeros_like(e_0_s)
    dk_new = dkdlam
    for _ in range(FP_ITERS):
        dk_new = geometry.geodesic_rhs_c(conn, *k_pred)
        k_next = tuple(kh + dl_2 * dd for kh, dd in zip(k_half, dk_new))
        kscale = sum(torch.abs(kn) for kn in k_next) + consts.EPS
        err = sum(torch.abs(kp - kn) for kp, kn in zip(k_pred, k_next)) / kscale
        k_pred = k_next
    k_new = k_pred

    e_1 = -(k_new[0] * g00 + k_new[1] * g01 + k_new[3] * g03)
    err_e = torch.abs((e_1 - e_0_s) / (e_0_s + consts.EPS))

    bad = (err_e > consts.E_DRIFT_TOL) | (err > consts.E_TOL) | ~torch.isfinite(err)
    commit = active & (~bad | at_floor)

    x = where4(commit, x_new, x)
    k = where4(commit, k_new, k)
    dk = where4(commit, dk_new, dkdlam)
    e0s = torch.where(commit, e_1, e_0_s)
    err_ratio = torch.maximum(err / consts.E_TOL, err_e / consts.E_DRIFT_TOL)
    return x, k, dk, e0s, commit, err_ratio


def hot_phase_a(x, k, dkdlam, e_0_s, dl_shrink, pend_dl, pend_push, at_event,
                alive, w, record_pending, u_roul, alpha_scatti, bi, mc, grow_cap,
                reference=False):
    """Phase A of the hot iteration (plain version of kernel A).

    step_size -> optical-depth cap of a grown step -> geodesic push attempt
    -> error-proportional step control -> partial re-push bookkeeping ->
    stop test with Russian roulette -> bilinear cell ``z``.  ``u_roul``:
    (N,) roulette uniforms.  ``reference``: no optical-depth cap, and the
    halve/double ladder for the step control (``alpha_scatti``/``bi`` are
    then not read).  Returns a dict of updated fields and the masks phase B
    needs."""
    moving = alive & ~at_event

    dl_full = torch.where(
        pend_push, pend_dl,
        geometry.step_size_c(x[1], x[2], k[1], k[2], k[3], mc.x_stop[2]))
    seg = dl_full * dl_shrink
    # a grown step must not overshoot a decided scatter event
    seg = torch.where(pend_push, torch.minimum(seg, dl_full), seg)
    if not reference:  # cap the biased scattering depth a GROWN step may carry
        seg_tau = GROW_TAU_CAP / (0.5 * mc.d_tau_k * alpha_scatti * bi + consts.EPS)
        seg = torch.where(pend_push, seg, torch.minimum(seg, torch.maximum(seg_tau, dl_full)))
    at_floor = dl_shrink <= SHRINK_FLOOR
    act = moving & ~(x[1] < mc.x_start[1])

    xn, kn, dkn, e0sn, commit, err_r = push_attempt_c(
        x, k, dkdlam, e_0_s, seg, act, at_floor, mc.a, mc.h_slope, mc.r_0)
    if reference:  # the ladder: halve a failed attempt, else double
        dl_shrink_n = torch.where(act & ~commit, torch.clamp(dl_shrink * 0.5, min=SHRINK_FLOOR),
                                  torch.clamp(dl_shrink * 2.0, max=grow_cap))
    else:  # error-proportional control: fac = safety / sqrt(err), clamped
        err_eff = torch.where(torch.isfinite(err_r), err_r, 1e12)
        err_eff = torch.where(act, err_eff, 1e-12)  # idle lanes re-grow
        fac = torch.clamp(STEP_CTRL * torch.rsqrt(torch.clamp(err_eff, min=1e-12)), 0.25, 2.0)
        dl_shrink_n = torch.clamp(dl_shrink * fac, SHRINK_FLOOR, grow_cap)

    pend_rem = torch.where(pend_push & commit, pend_dl - seg, pend_dl)
    arrived = moving & pend_push & commit & (pend_rem <= 0.0)

    # stop criterion + roulette (harm_model.cpp:1589-1616) at the new x
    checkable = (moving & commit & ~arrived) | (moving & ~act)
    horizon = xn[1] < mc.x1_min
    escaped = xn[1] > consts.X1_MAX
    small = w < WEIGHT_MIN
    win = u_roul <= (1.0 / consts.ROULETTE)
    w_roul = torch.where(win, w * consts.ROULETTE, 0.0)
    w_n = torch.where(checkable & small & ~horizon, w_roul, w)
    killed_inside = checkable & small & ~horizon & ~escaped & ~win
    stopped = checkable & (horizon | escaped | killed_inside)
    record = checkable & escaped & ~horizon

    ii, jj, _, _ = geometry.x_to_ij_c(xn[1], xn[2], mc.x_start, mc.dx, (mc.n1, mc.n2))
    return dict(
        x=xn, k=kn, dkdlam=dkn, e_0_s=e0sn, dl_shrink=dl_shrink_n,
        pend_dl=pend_rem, pend_push=pend_push & ~arrived, at_event=at_event | arrived,
        alive=alive & ~stopped, w=w_n, record_pending=record_pending | record,
        seg=seg, commit=commit, moving=moving, was_pend=pend_push,
        arrived=arrived, stopped=stopped, z=(ii * mc.n2 + jj).to(torch.int32),
        grown=~pend_push & (dl_shrink > 1.0),
    )


def hot_phase_b(rows, x, k, dkdlam, e_0_s, w, alpha_scatti, alpha_absi, bi,
                tau_abs, tau_scatt, interacting, pend_dl, pend_push, sec_w,
                n_step, alive, x_pre, k_pre, dk_pre, e0s_pre,
                seg, commit, moving, was_pend, stopped, u_x1, grown, bias_scale,
                mc, hc_coeffs, k2_coeffs, stall_steps, reference=False):
    """Phase B of the hot iteration (plain version of kernel B),
    harm_model.cpp:937-1056.

    ``rows``: (N, 44) gathered derived corner rows at the new position, or
    under ``reference`` (N, 32) raw corner rows, blended with the metric
    pair at the new position; ``x_pre``...: the pre-step state for the
    scatter rollback; ``u_x1``: (N,) optical-depth uniforms; ``grown``:
    phase A's grown-step mask (not read under ``reference``);
    ``bias_scale``: 0-d tensor 100/(bias_norm * max_tau_scatt * (avg + 2)).
    Under ``reference`` there is no entry rollback and no ``tau_over``, and
    the values the detached-event capture reads are not returned."""
    inter = moving & commit & ~was_pend & ~stopped

    if reference:
        g7 = geometry.gcov_c(x[1], x[2], mc.a, mc.h_slope, mc.r_0)
        gc6 = geometry.gcon_c(x[1], x[2], mc.a, mc.h_slope, mc.r_0)
        fl = fluid.blend_raw(x[1], x[2], rows, mc, g7, gc6)
    else:
        fl = fluid.blend_derived(x[1], x[2], rows, mc)
    n_e, theta_e, b_mag = fl.n_e, fl.theta_e, fl.b

    bound = n_e == 0.0
    sin_th, nu = radiation.kinematics_sin_c(k, fl.u_cov, fl.b_cov, b_mag, mc.b_unit)
    nu_safe = torch.abs(nu) + consts.EPS
    a_scf = radiation.alpha_inv_scatt_c(nu_safe, theta_e, n_e, hc_coeffs)
    e_gamma = consts.HPL * nu_safe / (consts.ME * consts.CL * consts.CL)
    hc_hit = hc_mod.clamp_hit(e_gamma, theta_e) & (n_e > 0.0)
    a_abf = radiation.alpha_inv_abs_sin_c(nu_safe, theta_e, n_e, b_mag, sin_th, k2_coeffs)
    cap = 0.5 * w / WEIGHT_MIN
    bf = torch.minimum(torch.clamp(bias_scale * theta_e * theta_e, min=consts.TP_OVER_TE),
                       cap) / consts.TP_OVER_TE

    dead_branch = bound | (nu < 0.0)

    # vacuum -> matter entry rollback of grown steps
    entry_roll = torch.zeros_like(inter)
    if not reference:
        entry_roll = (inter & grown & ~dead_branch & (alpha_scatti <= 0.0)
                      & (alpha_absi <= 0.0) & (n_e > 0.0))
        inter = inter & ~entry_roll

    half = 0.5 * mc.d_tau_k * seg
    d_tau_scatt = torch.where(dead_branch, alpha_scatti * half, (alpha_scatti + a_scf) * half)
    d_tau_abs = torch.where(dead_branch, alpha_absi * half, (alpha_absi + a_abf) * half)
    bias = torch.where(dead_branch, 0.0, 0.5 * (bi + bf))

    zero = torch.zeros_like(a_scf)
    alpha_scatti_n = torch.where(inter, torch.where(dead_branch, zero, a_scf), alpha_scatti)
    alpha_absi_n = torch.where(inter, torch.where(dead_branch, zero, a_abf), alpha_absi)
    bi_n = torch.where(inter, torch.where(dead_branch, zero, bf), bi)

    x1r = -torch.log(u_x1 + 1e-30)
    sec_w_new = w / torch.clamp(bias, min=consts.EPS)
    scatter = inter & (bias * d_tau_scatt > x1r) & (sec_w_new > WEIGHT_MIN)

    frac = torch.where(scatter, x1r / (bias * d_tau_scatt + consts.EPS), 1.0)
    d_tau_abs_eff = d_tau_abs * frac
    d_tau_scatt_eff = d_tau_scatt * frac

    absorbed = inter & (d_tau_abs_eff > 100.0)

    d_tau = d_tau_abs_eff + d_tau_scatt_eff
    decay_taylor = 1.0 - d_tau / 24.0 * (24.0 - d_tau * (12.0 - d_tau * (4.0 - d_tau)))
    decay = torch.where(d_tau < 1.0e-3, decay_taylor,
                        torch.exp(-torch.clamp(d_tau, max=200.0)))
    live = inter & ~absorbed
    w_n = torch.where(live, w * decay, w)

    roll = scatter & ~absorbed
    roll_any = roll | entry_roll  # both restore the pre-step state

    n_step_n = n_step + moving.to(torch.int32)
    over = moving & (n_step_n > stall_steps)

    out = dict(
        x=where4(roll_any, x_pre, x), k=where4(roll_any, k_pre, k),
        dkdlam=where4(roll_any, dk_pre, dkdlam),
        e_0_s=torch.where(roll_any, e0s_pre, e_0_s),
        pend_dl=torch.where(roll, seg * frac, pend_dl),
        sec_w=torch.where(roll, sec_w_new, sec_w),
        pend_push=pend_push | roll,
        w=w_n,
        tau_abs=torch.where(live, tau_abs + d_tau_abs_eff, tau_abs),
        tau_scatt=torch.where(live, tau_scatt + d_tau_scatt_eff, tau_scatt),
        alpha_scatti=alpha_scatti_n, alpha_absi=alpha_absi_n, bi=bi_n,
        interacting=(inter & ((alpha_scatti_n > 0.0) | (alpha_absi_n > 0.0) | (n_e > 0.0)))
        | (~inter & interacting),
        alive=alive & ~absorbed & ~over,
        n_step=n_step_n,
        hc_clamp=hc_hit & inter,
    )
    if not reference:
        out.update(tau_over=inter & (torch.maximum(d_tau_scatt, d_tau_abs) > GROW_TAU_CAP),
                   entry_roll=entry_roll, a_scf=a_scf, a_abf=a_abf, bf=bf, nu=nu, n_e=n_e)
    return out


def _capture_events(p, arrived, at_event, x, k, w, sec_w, alive,
                    alpha_scatti, alpha_absi, bi, a_scf, a_abf, bf, nu):
    """Detached-events capture at scatter arrival: a parent whose shadow
    registers are free stores its event and continues; a doomed parent
    (harm_model.cpp:1071-1081 k0 checks) dies with the event dropped.
    ``p`` is the pre-iteration pool.  Returns pool-field overrides."""
    k0, k1, _, k3 = k
    pdie = arrived & ((k0 > 1.0e5) | (k0 < 0.0) | torch.isnan(k0)
                      | torch.isnan(k1) | torch.isnan(k3))
    cap = arrived & ~p.ev_pending & ~pdie
    neg = nu < 0.0
    zero = torch.zeros_like(w)
    return dict(
        ev_x=where4(cap, x, p.ev_x),
        ev_k=where4(cap, k, p.ev_k),
        ev_w=torch.where(cap, sec_w, p.ev_w),
        ev_pending=p.ev_pending | cap,
        at_event=at_event & ~cap & ~pdie,
        alive=alive & ~pdie,
        occupied=p.occupied & ~(pdie & ~p.ev_pending),
        w=torch.where(pdie, zero, w),
        alpha_scatti=torch.where(cap, torch.where(neg, zero, a_scf), alpha_scatti),
        alpha_absi=torch.where(cap, torch.where(neg, zero, a_abf), alpha_absi),
        bi=torch.where(cap, bf, bi),
    )


def hot_step_plain(p: Pool, counters: Counters, u_roul, u_x1, bias_scale, mc,
                   tables: EngineTables, cfg: EngineConfig):
    """One hot iteration, the plain version of the fused kernel
    (``csrc/hot_step.cu`` ``hot_step_kernel``): phase A, the corner rows at
    its cells (derived, or raw under reference semantics), phase B, the
    ``dl_shrink`` clamp of a grown step that overshot or re-entered matter,
    the detached-event capture (not under reference semantics, where
    arrivals park at_event) and the lane-slot census.  ``p`` is the
    pre-step pool, ``bias_scale`` a 0-d tensor (``Engine._bias_scale``).
    Returns the post-step (pool, counters)."""
    ref = cfg.reference
    A = hot_phase_a(
        p.x, p.k, p.dkdlam, p.e_0_s, p.dl_shrink, p.pend_dl, p.pend_push, p.at_event,
        p.alive, p.w, p.record_pending, u_roul, p.alpha_scatti, p.bi, mc, cfg.grow_cap,
        reference=ref)
    table = tables.corner_rows if ref else tables.hot_tab
    B = hot_phase_b(
        table[A["z"].long()], A["x"], A["k"], A["dkdlam"], A["e_0_s"], A["w"],
        p.alpha_scatti, p.alpha_absi, p.bi, p.tau_abs, p.tau_scatt, p.interacting,
        A["pend_dl"], A["pend_push"], p.sec_w, p.n_step, A["alive"], p.x, p.k, p.dkdlam,
        p.e_0_s, A["seg"], A["commit"], A["moving"], A["was_pend"], A["stopped"], u_x1,
        None if ref else A["grown"], bias_scale, mc, tables.hc_coeffs, tables.k2_coeffs,
        cfg.stall_steps, reference=ref)
    dl_shrink_n = A["dl_shrink"]
    if not ref:
        dl_shrink_n = torch.where(B["tau_over"] | B["entry_roll"],
                                  torch.clamp(dl_shrink_n, max=1.0), dl_shrink_n)
    q = p._replace(
        x=B["x"], k=B["k"], dkdlam=B["dkdlam"], e_0_s=B["e_0_s"],
        dl_shrink=dl_shrink_n, pend_dl=B["pend_dl"], pend_push=B["pend_push"],
        at_event=A["at_event"], w=B["w"], alive=B["alive"],
        record_pending=A["record_pending"], tau_abs=B["tau_abs"],
        tau_scatt=B["tau_scatt"], alpha_scatti=B["alpha_scatti"],
        alpha_absi=B["alpha_absi"], bi=B["bi"], interacting=B["interacting"],
        sec_w=B["sec_w"], n_step=B["n_step"])
    if not ref:
        q = q._replace(**_capture_events(
            p, A["arrived"], A["at_event"], B["x"], B["k"], B["w"], B["sec_w"],
            B["alive"], B["alpha_scatti"], B["alpha_absi"], B["bi"], B["a_scf"],
            B["a_abf"], B["bf"], B["nu"]))
    counters = _util_counters(counters, q.occupied, A["moving"], A["commit"], q.at_event)
    counters = counters._replace(n_hc_clamp=counters.n_hc_clamp + B["hc_clamp"].sum())
    return q, counters


# ---------------------------------------------------------------------------
# compaction helpers
# ---------------------------------------------------------------------------

def compact_idx(mask, k):
    """First-k lane indices where mask, ascending, k-padded: returns
    (valid, gi, sidx) — validity, gather indices clamped for reads, and
    scatter indices equal to n for the padding (see :func:`put`)."""
    n = mask.shape[0]
    lane = torch.arange(n, device=mask.device)
    idx = torch.sort(torch.where(mask, lane, n)).values[:k]
    valid = idx < n
    return valid, torch.clamp(idx, max=n - 1), torch.where(valid, idx, n)


def put(dst, sidx, val):
    """dst[sidx] = val with the rows at sidx == len(dst) dropped."""
    buf = torch.cat([dst, dst[:1]])
    buf[sidx] = val
    return buf[:-1]


def take_cols(gi, arrs):
    """[(N,) tensors] gathered at gi."""
    return [a[gi] for a in arrs]


def put_cols(sidx, updates):
    """[(dst (N,), val (K,))] -> new dsts with dst[sidx[j]] = val[j]."""
    return [put(d, sidx, v) for d, v in updates]


class Engine:
    """The transport engine of one dump (the counterpart of the JAX
    ``make_engine`` closure).  ``gen``: the run's ``torch.Generator``, on
    ``device``."""

    def __init__(self, mc, cfg: EngineConfig, tables: EngineTables, device, gen):
        self.mc, self.cfg, self.tables = mc, cfg, tables
        self.device, self.gen = device, gen
        self.dt = cfg.dtype
        n = cfg.n_pool
        self.ev_k = min(n, cfg.ev_k) if cfg.ev_k else min(n, max(256, n // 8))
        self.rf_k = min(n, cfg.refill_k) if cfg.refill_k else self.ev_k
        self.light_k = min(n, cfg.light_k if cfg.light_k else min(self.ev_k, self.rf_k))
        self.phases = {"full": 0, "light": 0}  # calls since fresh_state, on the host

    # -- state ------------------------------------------------------------
    def fresh_state(self) -> State:
        c, dt, dev = self.cfg, self.dt, self.device
        self.phases = {"full": 0, "light": 0}
        return State(
            pool=empty_pool(c.n_pool, dt, dev, trace_birth=c.trace_birth),
            spec=torch.zeros((N_BINS + 1, N_SPEC_CHAN), dtype=dt, device=dev),
            counters=init_counters(self.mc.max_tau_scatt0, dt, dev),
            sec=SecBuf(rows=torch.zeros((c.sec_cap, ROW_WIDTH), dtype=dt, device=dev),
                       count=torch.zeros((), dtype=torch.int64, device=dev)),
            backlog_pos=torch.zeros((), dtype=torch.int64, device=dev),
            it=0,
        )

    def _uniform(self, n):
        return torch.rand(n, generator=self.gen, dtype=self.dt, device=self.device)

    # -- physics helpers ----------------------------------------------------
    def _bias_denom(self, counters):
        """max_tau * (avg + 2): the average scatter count per record is the
        cumulative ratio under reference semantics, else the windowed mean
        (BIAS_EMA); under the frozen-bias mode the constants
        bias_fixed_tau * (bias_fixed_avg + 2), a float64 0-d tensor, so that
        the bias and its scale round once into the engine dtype, as the JAX
        engine's Python constant does."""
        if self.cfg.bias_fixed_tau > 0.0:
            return torch.tensor(self.cfg.bias_fixed_tau * (self.cfg.bias_fixed_avg + 2.0),
                                dtype=torch.float64, device=self.device)
        if self.cfg.reference:
            avg = counters.n_scatt_rec.to(self.dt) / (counters.n_recorded.to(self.dt) + 1.0)
        else:
            avg = counters.avg_ema
        return counters.max_tau_scatt * (avg + 2.0)

    def bias_func(self, theta_e, w, counters):
        """Scattering bias (harm_model.cpp:1391-1404) from the counters."""
        cap = 0.5 * w / WEIGHT_MIN
        bias = 100.0 * theta_e * theta_e / (self.mc.bias_norm * self._bias_denom(counters))
        bias = torch.clamp(bias, min=consts.TP_OVER_TE)
        return torch.minimum(bias, cap) / consts.TP_OVER_TE

    def _bias_scale(self, counters):
        return (100.0 / (self.mc.bias_norm * self._bias_denom(counters))).to(self.dt)

    def eval_alphas(self, k, fl):
        """(sin theta, nu, alpha_scatt, alpha_abs) from component tuples."""
        sin_th, nu = radiation.kinematics_sin_c(k, fl.u_cov, fl.b_cov, fl.b, self.mc.b_unit)
        nu_safe = torch.abs(nu) + consts.EPS
        a_sc = radiation.alpha_inv_scatt_c(nu_safe, fl.theta_e, fl.n_e, self.tables.hc_coeffs)
        a_ab = radiation.alpha_inv_abs_sin_c(nu_safe, fl.theta_e, fl.n_e, fl.b, sin_th,
                                             self.tables.k2_coeffs)
        return sin_th, nu, a_sc, a_ab

    def eval_fluid_xy(self, x1, x2):
        """(g7, fluid state) at arbitrary positions from the raw corner
        table, gathered by ``hot_kernels.row_gather``."""
        from grmonty_tpu_torch.transport import hot_kernels

        mc = self.mc
        g7 = geometry.gcov_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
        return g7, fluid.get_fluid_params_c(x1, x2, self.tables.corner_rows, mc, g7=g7,
                                            gather_fn=hot_kernels.row_gather)

    def eval_fluid_hot(self, x1, x2):
        """Fluid state from the hot step's table: the derived rows, or the
        raw rows under reference semantics."""
        mc = self.mc
        if self.cfg.reference:
            return self.eval_fluid_xy(x1, x2)[1]
        ii, jj, _, _ = geometry.x_to_ij_c(x1, x2, mc.x_start, mc.dx, (mc.n1, mc.n2))
        return fluid.blend_derived(x1, x2, self.tables.hot_tab[ii * mc.n2 + jj], mc)

    # -- the hot iteration ----------------------------------------------------
    def hot_step(self, state: State, u_roul=None, u_x1=None) -> State:
        """One hot iteration (``hot_kernels.hot_step``: one fused kernel on
        the card, :func:`hot_step_plain` on the CPU).  ``u_roul``/``u_x1``:
        the roulette and optical-depth uniforms, drawn from the run's
        generator when None."""
        from grmonty_tpu_torch.transport import hot_kernels

        n = self.cfg.n_pool
        if u_roul is None:
            u_roul = self._uniform(n)
        if u_x1 is None:
            u_x1 = self._uniform(n)
        p, counters = hot_kernels.hot_step(
            state.pool, state.counters, u_roul, u_x1, self._bias_scale(state.counters),
            self.mc, self.tables, self.cfg)
        return state._replace(pool=p, counters=counters, it=state.it + 1)

    # -- periodic phase -------------------------------------------------------
    def spectrum_add(self, spec, counters, p: Pool, width=None):
        """Record up to ``width`` escaped lanes (harm_model.cpp:1291-1335);
        NaN-poisoned pending lanes are freed unrecorded."""
        mc, dt = self.mc, self.dt
        bad = p.record_pending & (torch.isnan(p.w) | torch.isnan(p.e))
        # a lane holding an unconsumed event records after it is consumed
        rec = p.record_pending & ~bad & ~p.ev_pending
        valid, gi, sidx = compact_idx(rec, self.ev_k if width is None else width)

        (x2g, x3g, w, e, nsc, nsc0_g, x1ig, x2ig, tabs_g, tsc_g, ne0_g,
         te0_g, b0_g, e0_g, occ_g, rp_g) = take_cols(
            gi, [p.x[2], p.x[3], p.w, p.e, p.n_scatt, p.nsc0, p.x1i, p.x2i,
                 p.tau_abs, p.tau_scatt, p.n_e_0, p.theta_e_0, p.b_0,
                 p.e_0, p.occupied, p.record_pending])

        dx2 = (mc.x_stop[2] - mc.x_start[2]) / (2.0 * consts.N_TH_BINS)
        mid = 0.5 * (mc.x_start[2] + mc.x_stop[2])
        ix2 = torch.where(x2g < mid, torch.floor(x2g / dx2),
                          torch.floor((mc.x_stop[2] - x2g) / dx2)).to(torch.int64)
        l_e = torch.log(torch.clamp(e, min=1e-30))
        i_e = torch.floor((l_e - consts.spectrum.L_E_0) / consts.spectrum.D_L_E
                          + 2.5).to(torch.int64) - 2
        in_bins = ((ix2 >= 0) & (ix2 < consts.N_TH_BINS) & (i_e >= 0)
                   & (i_e < consts.N_E_BINS))
        ok = valid & in_bins

        idx = torch.where(ok, ix2 * consts.N_E_BINS + i_e, DUMP_BIN)
        we = w * e
        vals = torch.stack([
            w, we, torch.ones_like(w), nsc.to(dt), w * x1ig, w * x2ig * x2ig,
            w * x3g * x3g, w * tabs_g, w * tsc_g, w * ne0_g, w * te0_g, w * b0_g,
            w * e0_g, we * we, (nsc0_g > 0).to(dt), nsc0_g.to(dt)], dim=-1)
        vals = torch.where(ok[:, None], vals, 0.0)
        spec = spec.index_add(0, idx, vals)

        if self.cfg.trace_birth:
            # when this batch advances the ratchet, capture the advancing
            # photon's birth state (against the pre-update ratchet; invalid
            # lanes read -1, as in the JAX engine)
            bcols = take_cols(gi, [*p.bx, *p.bk, p.bw])
            tvals = torch.where(valid, tsc_g, -1.0)
            am = torch.argmax(tvals)
            better = tvals[am] > counters.max_tau_scatt

            def sel(new, cur):
                return torch.where(better, new, cur)

            counters = counters._replace(
                mt_bx=sel(torch.stack([c[am] for c in bcols[0:4]]), counters.mt_bx),
                mt_bk=sel(torch.stack([c[am] for c in bcols[4:8]]), counters.mt_bk),
                mt_bw=sel(bcols[8][am], counters.mt_bw),
                mt_nsc0=sel(nsc0_g[am].to(torch.int64), counters.mt_nsc0))

        counters = counters._replace(
            n_recorded=counters.n_recorded + ok.sum(),
            n_scatt_rec=counters.n_scatt_rec + torch.where(ok, nsc, 0).sum(),
            # over every record-criterion lane, in-bin or not (:1297-1299)
            max_tau_scatt=torch.maximum(
                counters.max_tau_scatt,
                torch.amax(torch.where(valid, tsc_g, 0.0))),
        )
        occ_n, rp_n = put_cols(sidx, [(p.occupied, occ_g & ~valid),
                                      (p.record_pending, rp_g & ~valid)])
        p = p._replace(occupied=occ_n & ~bad, record_pending=rp_n & ~bad,
                       ev_pending=p.ev_pending & ~bad)
        return spec, counters, p

    def process_scatters(self, p: Pool, sec: SecBuf, counters):
        """Run deferred scatter events (compacted) and pack the secondaries
        into the ring.  Sampler lanes that did not accept within their round
        caps stay pending and retry next phase; the sampler theta_e halves
        every ``EV_HALVE`` defers and the draw is forced at ``EV_FORCE``."""
        mc, dt = self.mc, self.dt
        valid, gi, sidx = compact_idx(p.ev_pending | p.at_event, self.ev_k)
        # never sample more events than the ring has room for, unless the
        # ring is full and no lane is free (then overflow drops and counts)
        sec_cap = sec.rows.shape[0]
        room = torch.clamp(sec_cap - sec.count, min=0)
        rank_e = torch.arange(self.ev_k, device=self.device)
        wedged = (room == 0) & ~torch.any(~p.occupied)
        valid = valid & ((rank_e < room) | wedged)

        cols = take_cols(gi, [*p.x, *p.k, p.sec_w, p.w, p.ev_tries,
                              p.n_e_0, p.theta_e_0, p.e_0, p.n_scatt,
                              p.alive, p.occupied, p.at_event,
                              p.alpha_scatti, p.alpha_absi, p.bi,
                              p.ev_pending, *p.ev_x, *p.ev_k, p.ev_w])
        (x0g, x1g, x2g, x3g, k0g, k1g, k2g, k3g, secw_g, wg, tries_g,
         ne0_g, te0_g, e0_g, nsc_g, alive_g, occ_g, atev_g,
         asc_g, aab_g, bi_g, evp_g) = cols[:22]
        evx, evk, evw_g = cols[22:26], cols[26:30], cols[30]

        # a lane whose shadow registers hold an event runs that event
        reg_g = evp_g & valid
        xg = where4(reg_g, evx, (x0g, x1g, x2g, x3g))
        kg = where4(reg_g, evk, (k0g, k1g, k2g, k3g))
        secw_g = torch.where(reg_g, evw_g, secw_g)
        force_g = valid & (tries_g >= EV_FORCE)

        g7, fl = self.eval_fluid_xy(xg[1], xg[2])
        fl_s = fl._replace(theta_e=fl.theta_e * torch.exp2(
            -(tries_g // EV_HALVE).to(dt)))
        res = scattering.scatter_event_c(self.gen, kg, fl_s, g7, mc.b_unit,
                                         active=valid, force=force_g)

        defer_g = valid & ~(res.sampled | res.parent_die)
        valid = valid & ~defer_g
        parent_die = valid & res.parent_die & ~reg_g
        make = valid & res.made & (fl.n_e > 0.0) & ~res.parent_die

        # post-event opacity refresh of surviving parents (:1026-1039)
        _, nu, a_scf, a_abf = self.eval_alphas(kg, fl)
        neg = nu < 0.0
        surv = valid & ~res.parent_die & ~reg_g
        zero = torch.zeros_like(wg)
        news = put_cols(sidx, [
            (p.alpha_scatti, torch.where(surv, torch.where(neg, zero, a_scf), asc_g)),
            (p.alpha_absi, torch.where(surv, torch.where(neg, zero, a_abf), aab_g)),
            (p.bi, torch.where(surv, self.bias_func(fl.theta_e, wg, counters), bi_g)),
            (p.w, torch.where(parent_die, zero, wg)),
            (p.ev_tries, torch.where(defer_g, tries_g + 1,
                                     torch.where(valid, 0, tries_g)).to(torch.int32)),
            (p.alive, alive_g & ~parent_die),
            (p.occupied, occ_g & ~parent_die),
            (p.at_event, atev_g & ~(valid & ~reg_g)),
            (p.ev_pending, evp_g & ~(valid & reg_g)),
        ])
        p = p._replace(**dict(zip(
            ("alpha_scatti", "alpha_absi", "bi", "w", "ev_tries", "alive",
             "occupied", "at_event", "ev_pending"), news)))

        # pack secondaries at count + prefix rank
        rank = torch.cumsum(make.to(torch.int64), 0) - 1
        pos = sec.count + rank
        fits = make & (pos < sec_cap)
        slot = torch.where(fits, pos, sec_cap)
        new_rows = torch.stack([
            *xg, *res.k_sec, secw_g, res.e_sec, res.l_sec, ne0_g, te0_g, fl.b,
            e0_g, (nsc_g + 1).to(dt)], dim=-1)
        sec = SecBuf(rows=put(sec.rows, slot, new_rows), count=sec.count + fits.sum())
        counters = counters._replace(
            n_sec_drop=counters.n_sec_drop + (make & ~fits).sum(),
            n_ev_soft=counters.n_ev_soft + (valid & (tries_g >= EV_HALVE)).sum(),
            n_ev_forced=counters.n_ev_forced + (valid & force_g).sum(),
        )
        return p, sec, counters

    def refill(self, p: Pool, sec: SecBuf, backlog_rows, backlog_pos, counters,
               n_valid, width=None, use_sec=True):
        """Fill free slots: secondaries (LIFO) first, then backlog primaries.
        Returns (pool, sec, backlog_pos, counters, fresh) where ``fresh`` =
        (valid, sidx) is the compacted set of loaded lanes for init_fresh."""
        n, dt = self.cfg.n_pool, self.dt
        t_total = backlog_rows.shape[0]
        k_w = self.rf_k if width is None else width
        valid_g, gi_g, sidx_g = compact_idx(~p.occupied, k_w)
        rank_g = torch.arange(k_w, device=self.device)
        n_sec = sec.count if use_sec else torch.zeros_like(sec.count)
        from_sec_g = valid_g & (rank_g < n_sec)
        sec_idx_g = torch.clamp(n_sec - 1 - rank_g, 0, sec.rows.shape[0] - 1)
        bl_idx_g = backlog_pos + torch.clamp(rank_g - n_sec, min=0)
        from_bl_g = valid_g & (rank_g >= n_sec) & (bl_idx_g < n_valid)
        bl_idx_g = torch.clamp(bl_idx_g, 0, t_total - 1)
        load_g = from_sec_g | from_bl_g

        rows_g = torch.where(from_sec_g[:, None], sec.rows[sec_idx_g],
                             backlog_rows[bl_idx_g])
        stag = torch.zeros((n + 1, ROW_WIDTH + 1), dtype=dt, device=self.device)
        stag[sidx_g] = torch.cat([rows_g, load_g[:, None].to(dt)], dim=1)
        rows = stag[:n].T.contiguous()
        load = rows[ROW_WIDTH] > 0.5

        x_new = tuple(rows[m] for m in range(0, 4))
        k_new = tuple(rows[m] for m in range(4, 8))
        w, e = rows[ROW_W], rows[ROW_E]
        # invalid photons are dropped on load (harm_model.cpp:895-900)
        ok = load & ~(isnan4(x_new) | isnan4(k_new) | (w == 0.0))

        zero = torch.zeros_like(w)
        nsc_row = rows[ROW_NSCATT].to(torch.int32)

        def pick(row, cur):
            return torch.where(load, row, cur)

        p = p._replace(
            x=where4(load, x_new, p.x), k=where4(load, k_new, p.k),
            w=pick(w, p.w), e=pick(e, p.e), l=pick(rows[ROW_L], p.l),
            n_e_0=pick(rows[ROW_NE0], p.n_e_0),
            theta_e_0=pick(rows[ROW_THETAE0], p.theta_e_0),
            b_0=pick(rows[ROW_B0], p.b_0), e_0=pick(rows[ROW_E0], p.e_0),
            e_0_s=pick(e, p.e_0_s), x1i=pick(x_new[1], p.x1i), x2i=pick(x_new[2], p.x2i),
            tau_abs=pick(zero, p.tau_abs), tau_scatt=pick(zero, p.tau_scatt),
            n_scatt=pick(nsc_row, p.n_scatt), nsc0=pick(nsc_row, p.nsc0),
            n_step=pick(torch.zeros_like(p.n_step), p.n_step),
            ev_tries=pick(torch.zeros_like(p.ev_tries), p.ev_tries),
            pend_dl=pick(zero, p.pend_dl), dl_shrink=pick(torch.ones_like(w), p.dl_shrink),
            sec_w=pick(zero, p.sec_w),
            occupied=p.occupied | ok, alive=p.alive | ok,
            pend_push=p.pend_push & ~load, at_event=p.at_event & ~load,
            record_pending=p.record_pending & ~load,
        )
        n_from_bl = from_bl_g.sum()
        sec = sec._replace(count=sec.count - from_sec_g.sum())
        counters = counters._replace(n_created=counters.n_created + n_from_bl)
        bad_g = torch.any(torch.isnan(rows_g[:, 0:8]), dim=1) | (rows_g[:, ROW_W] == 0.0)
        return p, sec, backlog_pos + n_from_bl, counters, (load_g & ~bad_g, sidx_g)

    def init_fresh(self, p: Pool, fresh, counters):
        """Track-start initialisation of freshly loaded lanes
        (harm_model.cpp:902-915): dk/dlambda, opacities and bias."""
        mc = self.mc
        valid, sidx = fresh
        gi = torch.clamp(sidx, max=self.cfg.n_pool - 1)
        (x0g, x1g, x2g, x3g, k0g, k1g, k2g, k3g, wg,
         dkc0, dkc1, dkc2, dkc3, asc_c, aab_c, bi_c, int_c) = take_cols(
            gi, [*p.x, *p.k, p.w, *p.dkdlam,
                 p.alpha_scatti, p.alpha_absi, p.bi, p.interacting])
        kg = (k0g, k1g, k2g, k3g)

        conn = geometry.connection_c(x1g, x2g, mc.a, mc.h_slope)
        dk0 = geometry.geodesic_rhs_c(conn, *kg)
        fl = self.eval_fluid_hot(x1g, x2g)
        _, _, a_sc, a_ab = self.eval_alphas(kg, fl)
        inside = fl.n_e > 0.0
        b0 = self.bias_func(fl.theta_e, wg, counters)
        zero = torch.zeros_like(wg)

        def keep(new, cur):
            return torch.where(valid, new, cur)

        news = put_cols(sidx, [
            (p.dkdlam[0], keep(dk0[0], dkc0)), (p.dkdlam[1], keep(dk0[1], dkc1)),
            (p.dkdlam[2], keep(dk0[2], dkc2)), (p.dkdlam[3], keep(dk0[3], dkc3)),
            (p.alpha_scatti, keep(torch.where(inside, a_sc, zero), asc_c)),
            (p.alpha_absi, keep(torch.where(inside, a_ab, zero), aab_c)),
            (p.bi, keep(torch.where(inside, b0, zero), bi_c)),
            (p.interacting, keep(inside, int_c)),
        ])
        p = p._replace(dkdlam=tuple(news[:4]), alpha_scatti=news[4],
                       alpha_absi=news[5], bi=news[6], interacting=news[7])
        if self.cfg.trace_birth:
            # the freshly loaded lanes' (x, k, w) are their birth state
            bcur = take_cols(gi, [*p.bx, *p.bk, p.bw])
            bnews = put_cols(sidx, [(dst, keep(new, cur)) for dst, new, cur in zip(
                [*p.bx, *p.bk, p.bw], [x0g, x1g, x2g, x3g, *kg, wg], bcur)])
            p = p._replace(bx=tuple(bnews[0:4]), bk=tuple(bnews[4:8]), bw=bnews[8])
        return p

    def _poison_sweep(self, p: Pool) -> Pool:
        """NaN insurance: poisoned lanes die unrecorded."""
        poison = p.occupied & (isnan4(p.x) | isnan4(p.k) | torch.isnan(p.w))
        return p._replace(
            alive=p.alive & ~poison, occupied=p.occupied & ~poison,
            record_pending=p.record_pending & ~poison, at_event=p.at_event & ~poison,
            ev_pending=p.ev_pending & ~poison)

    def _record_free_refill(self, p, spec, counters, sec, backlog_rows, backlog_pos,
                            n_valid, width=None, use_sec=True):
        """Record escaped lanes, free dead ones, reload from ring/backlog."""
        occ0, rec0 = p.occupied, p.record_pending
        spec, counters, p = self.spectrum_add(spec, counters, p, width=width)
        p = p._replace(occupied=p.occupied & (p.alive | p.record_pending | p.ev_pending))
        freed = occ0 & ~p.occupied
        # killed at the step cap, not recorded on the crossing step
        stalled = (freed & (p.n_step > self.cfg.stall_steps)
                   & ~(rec0 & ~p.record_pending))
        counters = counters._replace(
            n_retired=counters.n_retired + freed.sum(),
            n_steps_retired=counters.n_steps_retired
            + torch.where(freed, p.n_step, 0).sum(),
            n_stall=counters.n_stall + stalled.sum(),
            w_stall=counters.w_stall + torch.where(stalled, p.w, 0.0).sum(),
        )
        p, sec, backlog_pos, counters, fresh = self.refill(
            p, sec, backlog_rows, backlog_pos, counters, n_valid, width=width,
            use_sec=use_sec)
        p = self.init_fresh(p, fresh, counters)
        return p, spec, counters, sec, backlog_pos

    def periodic_phase(self, state: State, backlog_rows, n_valid=None) -> State:
        """The full phase: scatter events, record, free, refill, init."""
        if n_valid is None:
            n_valid = backlog_rows.shape[0]
        self.phases["full"] += 1
        p = self._poison_sweep(state.pool)
        p, sec, counters = self.process_scatters(p, state.sec, state.counters)
        p, spec, counters, sec, backlog_pos = self._record_free_refill(
            p, state.spec, counters, sec, backlog_rows, state.backlog_pos, n_valid)
        if not self.cfg.reference:
            # fold the since-last-phase marginal scatters/recorded into the EMA
            d_s = (counters.n_scatt_rec - counters.ema_scatt_mark).to(self.dt)
            d_r = (counters.n_recorded - counters.ema_rec_mark).to(self.dt)
            a = torch.where(d_r > 0.0, BIAS_EMA, 0.0).to(self.dt)
            counters = counters._replace(
                avg_ema=(1.0 - a) * counters.avg_ema + a * d_s / torch.clamp(d_r, min=1.0),
                ema_scatt_mark=counters.n_scatt_rec, ema_rec_mark=counters.n_recorded)
        return state._replace(pool=p, spec=spec, counters=counters, sec=sec,
                              backlog_pos=backlog_pos)

    def light_phase(self, state: State, backlog_rows, n_valid=None) -> State:
        """Record + free + refill only (no scatter events, no RNG)."""
        if n_valid is None:
            n_valid = backlog_rows.shape[0]
        self.phases["light"] += 1
        p = self._poison_sweep(state.pool)
        p, spec, counters, sec, backlog_pos = self._record_free_refill(
            p, state.spec, state.counters, state.sec, backlog_rows, state.backlog_pos,
            n_valid, width=self.light_k)
        return state._replace(pool=p, spec=spec, counters=counters, sec=sec,
                              backlog_pos=backlog_pos)

    def run(self, state: State, backlog_rows, tail_exit=None, n_valid=None) -> State:
        """Run full/light/hot blocks until the backlog and the ring are spent
        and at most ``tail_exit`` lanes remain occupied (the exit condition
        is read on the host once per m_period block), then flush the
        pending records."""
        cfg = self.cfg
        te = cfg.tail_exit if tail_exit is None else tail_exit
        nv = backlog_rows.shape[0] if n_valid is None else n_valid
        n_super = max(1, cfg.m_period)
        rp = cfg.refill_period if cfg.refill_period > 0 else n_super
        blocks = [rp] * (n_super // rp) + ([n_super % rp] if n_super % rp else [])
        it0, next_log = state.it, PROGRESS_ITERS
        while state.it - it0 < MAX_OUTER:
            occ, pos, sec = torch.stack([state.pool.occupied.sum(), state.backlog_pos,
                                         state.sec.count]).tolist()
            if not (occ > te or pos < nv or sec > 0):
                break
            if state.it - it0 >= next_log:
                log.info("engine run: %d hot iterations, %d lanes occupied, %d secondaries "
                         "queued", state.it - it0, occ, sec)
                next_log += PROGRESS_ITERS
            state = self.periodic_phase(state, backlog_rows, nv)
            for bi_, nb in enumerate(blocks):
                if bi_:
                    state = self.light_phase(state, backlog_rows, nv)
                for _ in range(nb):
                    state = self.hot_step(state)
        # final flush of pending records; a record_pending lane still holding
        # an unconsumed detached event records on a later phase
        spec, counters, p = state.spec, state.counters, state.pool
        while bool((p.record_pending & ~p.ev_pending).any()):
            spec, counters, p = self.spectrum_add(spec, counters, p)
        return state._replace(pool=p, spec=spec, counters=counters)
