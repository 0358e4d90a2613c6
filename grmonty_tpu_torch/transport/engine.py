"""The batched geodesic transport engine.

Port of ``grmonty_tpu/transport/engine.py`` for two sets of physics: the
shipped profile, and reference semantics (``EngineConfig.reference``).
Photons are an SoA pool of (N,) tensors stepped in lockstep:

* the **hot step** (:meth:`Engine.hot_step`) runs phase A (step size, one
  implicit-midpoint Kerr push, step control, stop test and roulette, cell
  index), the corner row at the new cell, phase B (fluid blend, opacities,
  scatter decision, weight decay), the detached-event capture and the
  lane-slot census — on CUDA tensors as one hand-written kernel
  (``hot_kernels.hot_step``; inside a block its drawing instance, which
  draws its own uniforms and runs each of the block's runs of hot steps
  as one launch in place, ``hot_kernels.hot_run``: the JAX engine's
  ``lax.fori_loop``), on CPU tensors as the plain :func:`hot_step_plain`
  (:func:`hot_run_plain` the run's).  The shipped profile blends
  the derived 44-wide corner rows, reference semantics the raw 32-wide
  rows;
* every ``refill_period`` iterations a **light phase** records escaped
  photons and refills free lanes; every ``m_period`` iterations the **full
  phase** also runs the deferred scattering events.  On CUDA tensors each
  compaction of the pool's lanes is one hand-written kernel
  (``hot_kernels.compact``, an order-preserving scan), the whole event
  phase between its compaction and the ring another, in place on the pool
  (``hot_kernels.event_phase``: the events' rows, fluid, opacities and
  bias, the event with its own Philox stream a lane under a key drawn from
  the generator, the outcome, the secondaries staged), the ring's pack a
  third (``hot_kernels.compact_rows``), each phase's poison sweep, record,
  frees, the full phase's EMA fold and the bias's terms a fourth
  (``hot_kernels.record_phase``: one launch a call; the full phase's sweep
  its own, before the event set), and each refill's slots' sources and
  row moves with the
  track start of the lanes they fill a fifth
  (``hot_kernels.refill_fresh``, after the compaction of the free lanes),
  in place on the pool, the spectrum and the counters; on CPU tensors the
  plain :func:`compact_idx` (a sort), :func:`event_phase_plain` (the plain
  event ``scattering.scatter_event_c`` drawing from the generator),
  :func:`pack_rows_plain`, :func:`record_phase_plain`,
  :func:`refill_sources_plain` and :func:`init_fresh_plain`;
* :meth:`Engine.run` runs those blocks until the JAX engine's
  ``lax.while_loop`` ``cond`` fails, the exit test computed on the device
  at the run's entry and after every block (``hot_kernels.exit_test``,
  plain :func:`exit_test_plain`, into an :class:`ExitWord`; the progress
  logged every ``PROGRESS_ITERS`` iterations of a long run from the words).
  A block (the while-loop's body: the full phase, the hot steps, each
  light phase and its hot steps) runs in place on a state the engine owns,
  with a static backlog buffer and a device ``n_valid`` and ``tail_exit``,
  so nothing in it reads the host.  On the card (``graphed``) a replay of
  one CUDA graph runs ``GRAPH_BODIES`` blocks, each under a conditional IF
  node (``hot_kernels.exit_guard``) whose condition the test before it
  sets (a replay's first block's from the word's ``go``, at the replay's
  head) and followed by the test, and the host issues the next replay before it waits on the
  last one's word (:func:`pipelined_loop`), so the card does not idle on
  the host's read; one replay a run comes after the exit and runs no
  block.  Elsewhere each block runs eagerly and the word is read after it
  (:func:`host_loop`).

RNG: one ``torch.Generator`` per engine; every draw site takes a whole
batch from it.  The hot phases take their uniforms as arguments, so the
kernels and the plain versions are comparable on identical inputs.  On the
card a block's hot steps draw nothing from the generator but one key: each
run of the drawing hot step (``hot_kernels.hot_run``, one launch) draws
each step's two uniforms a lane from the lane's Philox stream under that
key at the step's index in the block (``draws.hot_uniforms`` is the plain
version); on the CPU they are ``torch.rand`` batches, as the event phase's
draws are.  A graph replay advances the generator by all its blocks'
draws, those of a block that did not run included; a graphed run sets the
generator back to where its blocks' draws leave it
(:func:`rewound_offset`), as an eager run leaves it.
A block's phases and hot steps read the bias's terms (:class:`BiasTerms`:
the denominators and the scale) from tensors of the engine's own, which
each phase's record writes in place (:func:`bias_terms_plain` is their
plain version): no hot step changes what they are made from.
"""

import gc
import logging
import time
import typing

import numpy as np
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.ops import draws, fluid, geometry, radiation, scattering
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


def pool_tensors(p: Pool):
    """The pool's tensors in field order (a 4-vector field's components; a
    field that is off, the empty tuple, none)."""
    out = []
    for v in p:
        out.extend(v if isinstance(v, tuple) else (v,))
    return out


def state_tensors(state: State):
    """Every tensor of ``state`` in a fixed order: the pool's
    (:func:`pool_tensors`), the spectrum, the counters, the ring and
    ``backlog_pos``."""
    return pool_tensors(state.pool) + [state.spec, *state.counters, *state.sec,
                                       state.backlog_pos]


def _clone(v):
    if isinstance(v, tuple):
        return tuple(_clone(t) for t in v)
    return v.clone(memory_format=torch.contiguous_format)


def clone_pool(p: Pool) -> Pool:
    """``p`` with every tensor copied into a contiguous tensor of its own."""
    return Pool(*(_clone(v) for v in p))


def clone_state(state: State) -> State:
    """``state`` with every tensor copied into a contiguous tensor of its own."""
    return State(pool=clone_pool(state.pool), spec=_clone(state.spec),
                 counters=Counters(*(_clone(v) for v in state.counters)),
                 sec=SecBuf(*(_clone(v) for v in state.sec)),
                 backlog_pos=_clone(state.backlog_pos), it=state.it)


def assign_state(dst: State, src: State):
    """Copy every tensor of ``src`` into ``dst``'s, in place (shapes must
    match; a tensor that is its destination is not copied).  A source that
    is another field's destination is copied aside first, so that no field
    reads a value already overwritten."""
    assign_tensors(state_tensors(dst), state_tensors(src))


def assign_tensors(dst, src):
    """Copy each tensor of the list ``src`` into the one of ``dst`` at its
    place, as :func:`assign_state` does."""
    pairs = list(zip(dst, src, strict=True))
    for d, s in pairs:
        if d.shape != s.shape:
            raise ValueError(f"state field of shape {tuple(s.shape)} into {tuple(d.shape)}")
    held = {d.data_ptr() for d, _ in pairs}
    pairs = [(d, s.clone() if s.data_ptr() in held and s.data_ptr() != d.data_ptr() else s)
             for d, s in pairs]
    for d, s in pairs:
        if s is not d:
            d.copy_(s)


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


def hot_run_plain(p: Pool, counters: Counters, key, step0, steps, bias_scale, mc,
                  tables: EngineTables, cfg: EngineConfig):
    """``steps`` hot iterations in place, the plain version of a run of the
    drawing kernel (``hot_kernels.hot_run``; the JAX engine's
    ``lax.fori_loop`` over ``hot_step``): step j is :func:`hot_step_plain`
    on ``draws.hot_uniforms(key, step0 + j)``, its pool and census written
    back into ``p``'s and ``counters``' own tensors.  Returns (p,
    counters), the tensors it was given."""
    n, dt = p.w.shape[0], p.w.dtype
    held = pool_tensors(p) + list(counters)
    for j in range(steps):
        u_roul, u_x1 = draws.hot_uniforms(key, step0 + j, n, dt, device=p.w.device)
        q, c = hot_step_plain(p, counters, u_roul, u_x1, bias_scale, mc, tables, cfg)
        assign_tensors(held, pool_tensors(q) + list(c))
    return p, counters


# ---------------------------------------------------------------------------
# compaction helpers
# ---------------------------------------------------------------------------

def compact_idx(mask, k):
    """First-k lane indices where mask, ascending, k-padded: returns
    (valid, gi, sidx) — validity, gather indices clamped for reads, and
    scatter indices equal to n for the padding (see :func:`put`).  The
    plain version of ``csrc/compact.cu``'s mask mode (one sort, as the JAX
    engine's); the engine calls ``hot_kernels.compact``."""
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


# ---------------------------------------------------------------------------
# the track start and the event phase's fluid, plain versions (the CUDA
# kernels of csrc/fresh_init.cu and csrc/event_fluid.cu compute them;
# hot_kernels.refill_fresh and hot_kernels.event_fluid dispatch between them)
# ---------------------------------------------------------------------------

def eval_alphas(k, fl, mc, tables: EngineTables):
    """(sin theta, nu, alpha_scatt, alpha_abs) from component tuples."""
    sin_th, nu = radiation.kinematics_sin_c(k, fl.u_cov, fl.b_cov, fl.b, mc.b_unit)
    nu_safe = torch.abs(nu) + consts.EPS
    a_sc = radiation.alpha_inv_scatt_c(nu_safe, fl.theta_e, fl.n_e, tables.hc_coeffs)
    a_ab = radiation.alpha_inv_abs_sin_c(nu_safe, fl.theta_e, fl.n_e, fl.b, sin_th,
                                         tables.k2_coeffs)
    return sin_th, nu, a_sc, a_ab


def bias_func(theta_e, w, bias_den):
    """Scattering bias (harm_model.cpp:1391-1404); ``bias_den``: the 0-d
    tensor bias_norm * max_tau * (avg + 2) (:func:`bias_terms_plain`)."""
    cap = 0.5 * w / WEIGHT_MIN
    bias = 100.0 * theta_e * theta_e / bias_den
    bias = torch.clamp(bias, min=consts.TP_OVER_TE)
    return torch.minimum(bias, cap) / consts.TP_OVER_TE


class FreshLoad(typing.NamedTuple):
    """Where refill's slots load from (:func:`refill_sources_plain`): slot j
    fills lane ``sidx[j]`` (ascending, padded with the pool's width) where
    ``load[j]``, with row ``sec_rows[sec_idx[j]]`` where ``from_sec[j]``,
    else ``backlog_rows[bl_idx[j]]`` (the indices clamped into range)."""

    sidx: torch.Tensor  # (K,) int64
    load: torch.Tensor  # (K,) bool
    from_sec: torch.Tensor  # (K,) bool
    sec_idx: torch.Tensor  # (K,) int64
    bl_idx: torch.Tensor  # (K,) int64
    sec_rows: torch.Tensor  # (S, ROW_WIDTH): the secondary ring
    backlog_rows: torch.Tensor  # (T, ROW_WIDTH)


class RefillSlots(typing.NamedTuple):
    """What refill's slots fill from (:meth:`Engine.refill_slots`): the
    first K free lanes (``valid``, ``sidx``: the compaction of the free
    lanes), the secondary ring (last in, first out), then the backlog's
    rows from ``backlog_pos`` below ``n_valid`` (a 0-d int64 tensor or an
    int)."""

    valid: torch.Tensor  # (K,) bool
    sidx: torch.Tensor  # (K,) int64, padded with the pool's width
    sec: SecBuf
    backlog_rows: torch.Tensor  # (T, ROW_WIDTH)
    backlog_pos: torch.Tensor  # 0-d int64: the next unconsumed primary
    n_valid: typing.Any


def refill_sources_plain(slots: RefillSlots, counters):
    """Each slot's source (the plain version of the first part of
    ``csrc/fresh_init.cu``): the r-th valid slot takes the ring's row
    count - 1 - r while r is below the ring's count, else the backlog's row
    backlog_pos + r - count while that is below ``n_valid``.  Returns (sec,
    backlog_pos, counters, load): the ring's count and the backlog position
    past what the slots take, the created count, and the :class:`FreshLoad`
    that :func:`init_fresh_plain` loads and starts."""
    valid_g, sidx_g, sec = slots.valid, slots.sidx, slots.sec
    backlog_rows, backlog_pos, n_valid = slots.backlog_rows, slots.backlog_pos, slots.n_valid
    t_total = backlog_rows.shape[0]
    rank_g = torch.arange(valid_g.shape[0], device=valid_g.device)
    n_sec = sec.count
    from_sec_g = valid_g & (rank_g < n_sec)
    sec_idx_g = torch.clamp(n_sec - 1 - rank_g, 0, sec.rows.shape[0] - 1)
    bl_idx_g = backlog_pos + torch.clamp(rank_g - n_sec, min=0)
    from_bl_g = valid_g & (rank_g >= n_sec) & (bl_idx_g < n_valid)
    bl_idx_g = torch.clamp(bl_idx_g, 0, t_total - 1)
    load = FreshLoad(sidx_g, from_sec_g | from_bl_g, from_sec_g, sec_idx_g, bl_idx_g,
                     sec.rows, backlog_rows)
    n_from_bl = from_bl_g.sum()
    sec = sec._replace(count=sec.count - from_sec_g.sum())
    counters = counters._replace(n_created=counters.n_created + n_from_bl)
    return sec, backlog_pos + n_from_bl, counters, load


def refill_load_plain(p: Pool, load: FreshLoad):
    """Move refill's rows into their lanes (the load part of
    ``csrc/fresh_init.cu``): returns the pool and the fresh set (valid,
    sidx) that :func:`init_fresh_plain` starts, valid where the row was
    loaded and holds no NaN in x or k and a nonzero weight."""
    n, dt = p.w.shape[0], p.w.dtype
    sidx_g, load_g = load.sidx, load.load
    rows_g = torch.where(load.from_sec[:, None], load.sec_rows[load.sec_idx],
                         load.backlog_rows[load.bl_idx])
    stag = torch.zeros((n + 1, ROW_WIDTH + 1), dtype=dt, device=p.w.device)
    stag[sidx_g] = torch.cat([rows_g, load_g[:, None].to(dt)], dim=1)
    rows = stag[:n].T.contiguous()
    on = rows[ROW_WIDTH] > 0.5

    x_new = tuple(rows[m] for m in range(0, 4))
    k_new = tuple(rows[m] for m in range(4, 8))
    w, e = rows[ROW_W], rows[ROW_E]
    # invalid photons are dropped on load (harm_model.cpp:895-900)
    ok = on & ~(isnan4(x_new) | isnan4(k_new) | (w == 0.0))

    zero = torch.zeros_like(w)
    nsc_row = rows[ROW_NSCATT].to(torch.int32)

    def pick(row, cur):
        return torch.where(on, row, cur)

    p = p._replace(
        x=where4(on, x_new, p.x), k=where4(on, k_new, p.k),
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
        pend_push=p.pend_push & ~on, at_event=p.at_event & ~on,
        record_pending=p.record_pending & ~on,
    )
    bad_g = torch.any(torch.isnan(rows_g[:, 0:8]), dim=1) | (rows_g[:, ROW_W] == 0.0)
    return p, (load_g & ~bad_g, sidx_g)


def init_fresh_plain(p: Pool, fresh, bias_den, mc, tables: EngineTables, cfg: EngineConfig):
    """Track-start initialisation of freshly loaded lanes
    (harm_model.cpp:902-915): dk/dlambda, opacities and bias (the plain
    version of ``csrc/fresh_init.cu``).  ``fresh``: a :class:`FreshLoad`,
    whose rows :func:`refill_load_plain` moves into the pool first, or the
    compacted set (valid, sidx) of lanes already loaded; the fluid is the
    hot step's (the derived rows, or the raw rows under reference
    semantics); ``bias_den``: as :func:`bias_func` takes it.  Returns the
    pool with new dkdlam, alpha_scatti, alpha_absi, bi and interacting (and,
    under ``cfg.trace_birth``, bx, bk and bw) on the valid lanes."""
    if isinstance(fresh, FreshLoad):
        p, fresh = refill_load_plain(p, fresh)
    valid, sidx = fresh
    gi = torch.clamp(sidx, max=cfg.n_pool - 1)
    (x0g, x1g, x2g, x3g, k0g, k1g, k2g, k3g, wg,
     dkc0, dkc1, dkc2, dkc3, asc_c, aab_c, bi_c, int_c) = take_cols(
        gi, [*p.x, *p.k, p.w, *p.dkdlam,
             p.alpha_scatti, p.alpha_absi, p.bi, p.interacting])
    kg = (k0g, k1g, k2g, k3g)

    conn = geometry.connection_c(x1g, x2g, mc.a, mc.h_slope)
    dk0 = geometry.geodesic_rhs_c(conn, *kg)
    if cfg.reference:
        g7 = geometry.gcov_c(x1g, x2g, mc.a, mc.h_slope, mc.r_0)
        fl = fluid.get_fluid_params_c(x1g, x2g, tables.corner_rows, mc, g7=g7)
    else:
        ii, jj, _, _ = geometry.x_to_ij_c(x1g, x2g, mc.x_start, mc.dx, (mc.n1, mc.n2))
        fl = fluid.blend_derived(x1g, x2g, tables.hot_tab[ii * mc.n2 + jj], mc)
    _, _, a_sc, a_ab = eval_alphas(kg, fl, mc, tables)
    inside = fl.n_e > 0.0
    b0 = bias_func(fl.theta_e, wg, bias_den)
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
    if cfg.trace_birth:
        # the freshly loaded lanes' (x, k, w) are their birth state
        bcur = take_cols(gi, [*p.bx, *p.bk, p.bw])
        bnews = put_cols(sidx, [(dst, keep(new, cur)) for dst, new, cur in zip(
            [*p.bx, *p.bk, p.bw], [x0g, x1g, x2g, x3g, *kg, wg], bcur)])
        p = p._replace(bx=tuple(bnews[0:4]), bk=tuple(bnews[4:8]), bw=bnews[8])
    return p


class EventFluid(typing.NamedTuple):
    """What the event phase reads at its compacted lanes (:func:`event_fluid_plain`)."""

    g7: tuple  # the covariant metric at the event
    fl: fluid.FluidC  # the raw rows' fluid state
    theta_s: torch.Tensor  # the samplers' theta_e, halved every EV_HALVE defers
    a_sc: torch.Tensor  # the post-event alpha_scatt (0 where nu < 0)
    a_ab: torch.Tensor  # the post-event alpha_abs (0 where nu < 0)
    bias: torch.Tensor  # the post-event bias


def event_fluid_plain(rows, x1, x2, k, w, tries, bias_den, mc, tables: EngineTables):
    """The event phase's fluid, opacities and bias at its compacted lanes
    (the plain version of ``csrc/event_fluid.cu``): ``rows`` the raw corner
    rows at (x1, x2) (``fluid.cell_index_c``), ``k`` the event's wave vector,
    ``w`` the lane's weight, ``tries`` its defers (int32), ``bias_den`` as
    :func:`bias_func` takes it.  Returns an :class:`EventFluid`."""
    g7 = geometry.gcov_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
    gc6 = geometry.gcon_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
    fl = fluid.blend_raw(x1, x2, rows, mc, g7, gc6)
    theta_s = fl.theta_e * torch.exp2(-(tries // EV_HALVE).to(x1.dtype))
    # the post-event opacity refresh of surviving parents (:1026-1039)
    _, nu, a_scf, a_abf = eval_alphas(k, fl, mc, tables)
    neg = nu < 0.0
    zero = torch.zeros_like(w)
    return EventFluid(g7, fl, theta_s, torch.where(neg, zero, a_scf),
                      torch.where(neg, zero, a_abf), bias_func(fl.theta_e, w, bias_den))


class EventStage(typing.NamedTuple):
    """The event phase's secondaries before the ring's pack, one a slot of
    its compacted set (:func:`event_phase_plain`)."""

    rows: torch.Tensor  # (K, ROW_WIDTH) the secondary born at the slot's event
    make: torch.Tensor  # (K,) bool: whether the slot made one


def event_set(p: Pool, sec: SecBuf, k):
    """What the event phase runs on (:meth:`Engine.process_scatters`): the
    first ``k`` lanes holding an event (``hot_kernels.compact``: (valid, gi,
    sidx)), the ring's free rows ``room`` and whether it is ``wedged`` (0-d
    int64 and bool).  Never sample more events than the ring has room for,
    unless it is full and no lane is free (then overflow drops and counts)."""
    from grmonty_tpu_torch.transport import hot_kernels

    sel = hot_kernels.compact(p.ev_pending | p.at_event, k)
    room = torch.clamp(sec.rows.shape[0] - sec.count, min=0)
    return sel, room, (room == 0) & p.occupied.all()


def event_phase_plain(p: Pool, counters, sel, room, wedged, bias_den, mc,
                      tables: EngineTables, src):
    """The event phase between the compaction and the ring (the plain
    version of ``csrc/scatter_event.cu``'s event_phase_kernel).  ``sel``:
    the compacted set (valid, gi, sidx) of the lanes holding an event, of
    which the first ``room`` run (0-d int64: the ring's free rows) unless
    the ring is ``wedged`` (0-d bool: full, and no lane free; then overflow
    drops and counts); ``bias_den`` as :func:`bias_func` takes it; ``src``
    the events' draws (a ``torch.Generator``, or ``draws.PhiloxDraws``).
    Each runs its shadow registers' event where they hold one, else the
    parked one: the raw corner row at its cell, the fluid, opacities and
    bias (:func:`event_fluid_plain`), the scatter event
    (``scattering.scatter_event_c``); sampler lanes that did not accept
    within their round caps stay pending and retry next phase (the sampler
    theta_e halves every ``EV_HALVE`` defers and the draw is forced at
    ``EV_FORCE``), doomed parents die, surviving parents take the
    post-event opacities and bias.  Returns (pool, counters, stage): the
    counters with n_ev_soft and n_ev_forced added to, and the
    :class:`EventStage` of the secondaries' rows."""
    valid, gi, sidx = sel
    rank_e = torch.arange(valid.shape[0], device=valid.device)
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

    rows = tables.corner_rows[fluid.cell_index_c(xg[1], xg[2], mc)]
    ev = event_fluid_plain(rows, xg[1], xg[2], kg, wg, tries_g, bias_den, mc, tables)
    g7, fl = ev.g7, ev.fl
    res = scattering.scatter_event_c(src, kg, fl._replace(theta_e=ev.theta_s), g7, mc.b_unit,
                                     active=valid, force=force_g)

    defer_g = valid & ~(res.sampled | res.parent_die)
    valid = valid & ~defer_g
    parent_die = valid & res.parent_die & ~reg_g
    make = valid & res.made & (fl.n_e > 0.0) & ~res.parent_die

    # post-event opacity refresh of surviving parents (:1026-1039)
    surv = valid & ~res.parent_die & ~reg_g
    zero = torch.zeros_like(wg)
    news = put_cols(sidx, [
        (p.alpha_scatti, torch.where(surv, ev.a_sc, asc_g)),
        (p.alpha_absi, torch.where(surv, ev.a_ab, aab_g)),
        (p.bi, torch.where(surv, ev.bias, bi_g)),
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
    new_rows = torch.stack([
        *xg, *res.k_sec, secw_g, res.e_sec, res.l_sec, ne0_g, te0_g, fl.b,
        e0_g, (nsc_g + 1).to(wg.dtype)], dim=-1)
    counters = counters._replace(
        n_ev_soft=counters.n_ev_soft + (valid & (tries_g >= EV_HALVE)).sum(),
        n_ev_forced=counters.n_ev_forced + (valid & force_g).sum(),
    )
    return p, counters, EventStage(new_rows, make)


def pack_rows_plain(stage: EventStage, sec: SecBuf, counters):
    """Pack the staged secondaries that ``stage`` makes into the ring at
    count + their rank among them (the slots' order, which refill's LIFO
    reads back), as far as the ring holds them; the rest are dropped and
    counted in n_sec_drop (the plain version of ``csrc/compact.cu``'s rows
    mode).  Returns (sec, counters)."""
    sec_cap = sec.rows.shape[0]
    rank = torch.cumsum(stage.make.to(torch.int64), 0) - 1
    pos = sec.count + rank
    fits = stage.make & (pos < sec_cap)
    slot = torch.where(fits, pos, sec_cap)
    sec = SecBuf(rows=put(sec.rows, slot, stage.rows), count=sec.count + fits.sum())
    counters = counters._replace(n_sec_drop=counters.n_sec_drop + (stage.make & ~fits).sum())
    return sec, counters


# ---------------------------------------------------------------------------
# the phases' record, plain versions (the CUDA kernels of csrc/record.cu
# compute record_phase_plain; hot_kernels.record_phase dispatches)
# ---------------------------------------------------------------------------

def poison_sweep_plain(p: Pool) -> Pool:
    """NaN insurance: poisoned lanes (a NaN in x, k or w) die unrecorded."""
    poison = p.occupied & (isnan4(p.x) | isnan4(p.k) | torch.isnan(p.w))
    return p._replace(
        alive=p.alive & ~poison, occupied=p.occupied & ~poison,
        record_pending=p.record_pending & ~poison, at_event=p.at_event & ~poison,
        ev_pending=p.ev_pending & ~poison)


def spectrum_add_plain(spec, counters, p: Pool, width, mc, trace_birth=False):
    """Record up to ``width`` escaped lanes, the first in lane order
    (harm_model.cpp:1291-1335): their bins and 16 channels added into
    ``spec`` (out-of-bin lanes into ``DUMP_BIN`` with zeros), n_recorded,
    n_scatt_rec and the max_tau_scatt ratchet (over every recorded lane, in
    bin or not), under ``trace_birth`` the birth state of the lane that
    advances the ratchet; the recorded lanes freed, NaN-poisoned pending
    lanes freed unrecorded.  A lane holding an unconsumed event records
    after it is consumed.  Returns (spec, counters, pool)."""
    dt = spec.dtype
    bad = p.record_pending & (torch.isnan(p.w) | torch.isnan(p.e))
    rec = p.record_pending & ~bad & ~p.ev_pending
    valid, gi, sidx = compact_idx(rec, width)

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

    if trace_birth:
        # when this batch advances the ratchet, capture the advancing
        # photon's birth state (against the pre-update ratchet; invalid
        # lanes read -1, as in the JAX engine; the lane is selected on the
        # device, never read on the host)
        bcols = take_cols(gi, [*p.bx, *p.bk, p.bw])
        tvals = torch.where(valid, tsc_g, -1.0)
        am = torch.argmax(tvals).reshape(1)
        better = tvals.index_select(0, am)[0] > counters.max_tau_scatt
        birth = torch.stack(bcols).index_select(1, am)[:, 0]

        def sel(new, cur):
            return torch.where(better, new, cur)

        counters = counters._replace(
            mt_bx=sel(birth[0:4], counters.mt_bx), mt_bk=sel(birth[4:8], counters.mt_bk),
            mt_bw=sel(birth[8], counters.mt_bw),
            mt_nsc0=sel(nsc0_g.index_select(0, am)[0].to(torch.int64), counters.mt_nsc0))

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


def free_plain(p: Pool, counters, occ0, rec0, stall_steps):
    """Free the lanes that hold nothing to track, record or scatter, and
    count them (n_retired, n_steps_retired) and those killed at the step
    cap (n_stall, w_stall; not those that recorded on the crossing step);
    ``occ0``, ``rec0``: occupied and record_pending before the record.
    Returns (pool, counters)."""
    p = p._replace(occupied=p.occupied & (p.alive | p.record_pending | p.ev_pending))
    freed = occ0 & ~p.occupied
    stalled = freed & (p.n_step > stall_steps) & ~(rec0 & ~p.record_pending)
    counters = counters._replace(
        n_retired=counters.n_retired + freed.sum(),
        n_steps_retired=counters.n_steps_retired + torch.where(freed, p.n_step, 0).sum(),
        n_stall=counters.n_stall + stalled.sum(),
        w_stall=counters.w_stall + torch.where(stalled, p.w, 0.0).sum(),
    )
    return p, counters


def record_phase_plain(p: Pool, spec, counters, width, mc, cfg: EngineConfig, sweep=True,
                       record=True, free=True):
    """The phases' upkeep of the pool, in this order (the plain version of
    ``csrc/record.cu``): under ``sweep`` the poison sweep
    (:func:`poison_sweep_plain`), under ``record`` the record of up to
    ``width`` escaped lanes (:func:`spectrum_add_plain`), under ``free``
    the frees and their census (:func:`free_plain`, against the pool as the
    record found it).  Returns (pool, spec, counters)."""
    if sweep:
        p = poison_sweep_plain(p)
    occ0, rec0 = p.occupied, p.record_pending
    if record:
        spec, counters, p = spectrum_add_plain(spec, counters, p, width, mc, cfg.trace_birth)
    if free:
        p, counters = free_plain(p, counters, occ0, rec0, cfg.stall_steps)
    return p, spec, counters


class BiasTerms(typing.NamedTuple):
    """The bias's terms after a phase's record (0-d tensors): the
    denominators bias_norm * max_tau * (avg + 2) that refill's track start
    reads (after the record, before the full phase's EMA fold) and that
    the event phase reads (after the fold), and the hot steps' scale
    100 / ``event_den`` in the engine dtype."""

    refill_den: torch.Tensor
    event_den: torch.Tensor
    scale: torch.Tensor


def bias_terms_plain(counters, bias_norm, dt, reference, fold=False, fixed=None):
    """The bias's terms from ``counters`` (the plain version of the record
    kernel's last block, ``csrc/record.cu``; ``Engine._bias_den`` and
    ``_bias_scale`` read it): under ``fold`` first the full phase's EMA
    fold (grmonty_tpu/transport/engine.py:2462-2475: the since-last-phase
    marginal scatters over records into ``avg_ema`` at weight ``BIAS_EMA``,
    a window with no records leaving it; the marks copies of the counts,
    which the record adds to in place on the card), then the denominator
    bias_norm * max_tau * (avg + 2) (:1226-1250; avg the cumulative
    n_scatt_rec / (n_recorded + 1) under ``reference``, else ``avg_ema``)
    before and after the fold and the scale 100 / den in ``dt``
    (:1443-1445).  ``fixed``: the frozen-bias mode's float64 0-d
    max_tau * (avg + 2), which both denominators take in place of the
    counters' (float64), the scale rounded once into ``dt``.  Returns
    (counters, :class:`BiasTerms`)."""
    folded = counters
    if fold:
        d_s = (counters.n_scatt_rec - counters.ema_scatt_mark).to(dt)
        d_r = (counters.n_recorded - counters.ema_rec_mark).to(dt)
        a = torch.where(d_r > 0.0, BIAS_EMA, 0.0).to(dt)
        folded = counters._replace(
            avg_ema=(1.0 - a) * counters.avg_ema + a * d_s / torch.clamp(d_r, min=1.0),
            ema_scatt_mark=counters.n_scatt_rec.clone(),
            ema_rec_mark=counters.n_recorded.clone())
    if fixed is not None:
        den = bias_norm * fixed
        return folded, BiasTerms(den, den, (100.0 / den).to(dt))

    def den_of(c):
        if reference:
            avg = c.n_scatt_rec.to(dt) / (c.n_recorded.to(dt) + 1.0)
        else:
            avg = c.avg_ema
        return bias_norm * (c.max_tau_scatt * (avg + 2.0))

    den = den_of(folded)
    return folded, BiasTerms(den_of(counters) if fold else den, den, (100.0 / den).to(dt))


class ExitWord(typing.NamedTuple):
    """The exit test's word as the host reads it: the occupied lanes, the
    backlog position and the queued secondaries it found, the bodies the run
    has run or is about to (``go`` added), and ``go``: whether the next block
    runs."""

    occ: int
    pos: int
    sec: int
    bodies: int
    go: int


EXIT_WORD = len(ExitWord._fields)


def exit_test_plain(occupied, backlog_pos, sec_count, n_valid, tail_exit, word, go, n_super,
                    max_outer):
    """The plain version of ``hot_kernels.exit_test``, the JAX engine's
    while-loop ``cond`` (``grmonty_tpu/transport/engine.py``, ``run``) with
    the cap on this run's iterations: ``go`` = (sum(occupied) >
    ``tail_exit`` | ``backlog_pos`` < ``n_valid`` | ``sec_count`` > 0) &
    (``word[3]`` * ``n_super`` < ``max_outer``); ``word`` (int64
    (EXIT_WORD,)) becomes [occ, pos, sec, word[3] + go, go] and ``go`` (a
    bool scalar) go, both in place.  Returns (word, go)."""
    occ = occupied.sum()
    bodies = word[3]
    g = (((occ > tail_exit) | (backlog_pos < n_valid) | (sec_count > 0))
         & (bodies * n_super < max_outer))
    gi = g.to(torch.int64)
    word.copy_(torch.stack([occ.to(torch.int64), backlog_pos, sec_count, bodies + gi, gi]))
    go.copy_(g)
    return word, go


class RunLoop(typing.NamedTuple):
    """What a run's loop of blocks did: the last exit word read (its
    ``bodies`` the blocks the run ran), the graph replays issued and those
    of them that ran no block."""

    word: ExitWord
    replays: int
    skipped: int


class _Progress:
    """The progress log of a long run: at a word whose block runs, once
    every ``PROGRESS_ITERS`` hot iterations of the run, the iterations done
    before that block and the word's counts."""

    def __init__(self, n_super):
        self.n_super, self.next_log = n_super, PROGRESS_ITERS

    def __call__(self, word: ExitWord):
        done = (word.bodies - 1) * self.n_super
        if word.go and done >= self.next_log:
            log.info("engine run: %d hot iterations, %d lanes occupied, %d secondaries queued",
                     done, word.occ, word.sec)
            self.next_log += PROGRESS_ITERS
        return word


def host_loop(word: ExitWord, body, test, n_super) -> RunLoop:
    """The plain version of :func:`pipelined_loop`: while ``word`` says the
    next block runs, run it (``body()``) and take the exit test after it
    (``test()``, which returns its word read on the host).  ``word``: the
    test's word at the run's entry."""
    progress = _Progress(n_super)
    while progress(word).go:
        body()
        word = test()
    return RunLoop(word, 0, 0)


def pipelined_loop(entry, launch, read, n_super) -> RunLoop:
    """The loop of a graphed run, the host one replay ahead of the word it
    reads: ``launch()`` issues one replay (its blocks, each guarded by the
    exit word's ``go`` and followed by the exit test) and the copy of its
    last word to the host, and returns the copy's handle; ``read(handle)``
    waits for that copy alone and returns its :class:`ExitWord`; ``entry``:
    the handle of the word of the test at the run's entry.  Replay n + 1 is
    issued before replay n's word is read, so the card runs on while the
    host reads; the loop stops at the first word whose ``go`` is 0, and the
    one replay issued after it runs no block (the state is left as the
    word found it, so its every test finds the same)."""
    progress = _Progress(n_super)
    pending, replays, ran = entry, 0, 0
    while True:
        ahead = launch()
        replays += 1
        word = progress(read(pending))
        if not word.go:
            return RunLoop(word, replays, replays - ran)
        ran += 1
        pending = ahead


def rewound_offset(offset, base, step, k, replays, bodies):
    """The generator's offset after a graphed run, as an eager run of
    ``bodies`` blocks leaves it: each replay advanced it from ``base`` by
    the graph's whole increment, ``k`` blocks of ``step`` each, the blocks
    that did not run included (``offset`` must say so, or this raises);
    the blocks that ran drew at base + j * step, j = 0 ... bodies - 1."""
    if offset - base != replays * k * step:
        raise RuntimeError(f"the generator moved {offset - base} over {replays} replays of "
                           f"{k} blocks of {step}")
    return base + bodies * step


def run_credit(body, replay, bodies, replays):
    """What a graphed run adds to the launch and phase counts: ``body``
    ({name: n}, {phase: n}, a block's) once a block run, ``replay`` (a
    replay's own launches: its exit tests) once a replay."""
    launched = {k: v * bodies for k, v in body[0].items()}
    for k, v in replay[0].items():
        launched[k] = launched.get(k, 0) + v * replays
    phased = {k: v * bodies for k, v in body[1].items()}
    for k, v in replay[1].items():
        phased[k] = phased.get(k, 0) + v * replays
    return launched, phased


# The blocks one graph replay runs, each under its conditional node: 2
# halves the gaps between replays that 1 leaves, and every run of the
# reference window read shorter with 2 than with 1; 4 read no shorter
# (PERF.md §6).
GRAPH_BODIES = 2


class Engine:
    """The transport engine of one dump (the counterpart of the JAX
    ``make_engine`` closure).  ``gen``: the run's ``torch.Generator``, on
    ``device``.  ``graphed`` (a CUDA device only; the default there):
    :meth:`run` replays one CUDA graph of ``GRAPH_BODIES`` guarded blocks,
    captured at the first run (:meth:`capture`), until the exit word says
    stop; else it issues the block's operations one by one, which the phase
    clocks of ``profile_slice.py`` need."""

    def __init__(self, mc, cfg: EngineConfig, tables: EngineTables, device, gen,
                 graphed=None):
        from grmonty_tpu_torch.transport import hot_kernels

        self.mc, self.cfg, self.tables = mc, cfg, tables
        self.device, self.gen = torch.device(device), gen
        cuda = self.device.type == "cuda"
        self.graphed = cuda if graphed is None else bool(graphed)
        if self.graphed and not cuda:
            raise ValueError(f"graphed: a CUDA graph needs a CUDA device, not {self.device}")
        self.dt = cfg.dtype
        n = cfg.n_pool
        self.ev_k = min(n, cfg.ev_k) if cfg.ev_k else min(n, max(256, n // 8))
        self.rf_k = min(n, cfg.refill_k) if cfg.refill_k else self.ev_k
        self.light_k = min(n, cfg.light_k if cfg.light_k else min(self.ev_k, self.rf_k))
        self.phases = {"full": 0, "light": 0}  # calls since fresh_state, on the host
        self.flushes = 0  # Engine.run's closing records since fresh_state
        # The bias's terms (BiasTerms), each 0-d tensor made here, outside
        # any capture: under the live bias every record writes them in place
        # (hot_kernels.record_phase's ``bias``) and the phases read them;
        # under the frozen-bias mode they hold its constants, from the
        # float64 max_tau * (avg + 2) built once here (bias_terms_plain's
        # ``fixed``), and no record writes them.
        self._bias_fixed = (
            torch.tensor(cfg.bias_fixed_tau * (cfg.bias_fixed_avg + 2.0), dtype=torch.float64,
                         device=self.device) if cfg.bias_fixed_tau > 0.0 else None)
        if self._bias_fixed is None:
            self._bias = BiasTerms(*(torch.zeros((), dtype=self.dt, device=self.device)
                                     for _ in BiasTerms._fields))
        else:
            self._bias = bias_terms_plain(None, mc.bias_norm, self.dt, cfg.reference,
                                          fixed=self._bias_fixed)[1]
        self._bias_out = self._bias if self._bias_fixed is None else None
        # One block: the full phase, then per entry a light phase (but the
        # first) and that many hot steps.
        self.n_super = max(1, cfg.m_period)
        rp = cfg.refill_period if cfg.refill_period > 0 else self.n_super
        self.blocks = [rp] * (self.n_super // rp) + ([self.n_super % rp] if self.n_super % rp
                                                     else [])
        # What the block runs on, made at the first run: the engine's own
        # state, a backlog buffer of at least backlog_cap rows
        # (reserve_backlog), the valid rows' count on the device; the graph
        # and what one replay adds to the launch and phase counts.  The
        # kernels' tickets, made here, outside any capture: the ring's for
        # its pack (hot_kernels.rows_ticket), the record's with its tiles'
        # status words and counters (hot_kernels.record_ticket) and the
        # refill's (hot_kernels.fresh_ticket).
        self.backlog_cap = 1
        self._state = self._backlog = self._graph = self._credit = None
        self._body_stream = self._body_pool = None
        self._n_valid = torch.zeros((), dtype=torch.int64, device=self.device)
        self._rows_ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self._record_ticket = hot_kernels.record_ticket(self.device, n)
        self._fresh_ticket = torch.zeros(3, dtype=torch.int32, device=self.device)
        # The exit test's inputs and outputs (hot_kernels.exit_test): the
        # run's tail_exit on the device, the word (ExitWord) and go, the
        # predicate of a replay's first block's node; on the card the host
        # reads the word from two pinned slots, each with its event.
        self._tail_exit = torch.zeros((), dtype=torch.int64, device=self.device)
        self._exit_word = torch.zeros(EXIT_WORD, dtype=torch.int64, device=self.device)
        self._go = torch.zeros((), dtype=torch.bool, device=self.device)
        self._host_words = torch.zeros((2, EXIT_WORD), dtype=torch.int64, pin_memory=cuda)
        self._word_events = (torch.cuda.Event(), torch.cuda.Event()) if cuda else None
        # A replay's blocks (GRAPH_BODIES), and what one block advances the
        # generator by (measured at the capture).
        self.graph_bodies = GRAPH_BODIES
        self._gen_step = None
        self.runs = 0  # runs since fresh_state
        self.replays = 0  # graph replays since fresh_state
        self.bodies = 0  # blocks run since fresh_state
        self.skipped = 0  # graph replays that ran no block since fresh_state

    # -- state ------------------------------------------------------------
    def fresh_state(self) -> State:
        c, dt, dev = self.cfg, self.dt, self.device
        self.phases = {"full": 0, "light": 0}
        self.flushes = 0
        self.runs = self.replays = self.bodies = self.skipped = 0
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
    def _bias_terms(self, counters, fold=False):
        """(counters, :class:`BiasTerms`) from ``counters``
        (:func:`bias_terms_plain`): the average scatter count per record is
        the cumulative ratio under reference semantics, else the windowed
        mean (BIAS_EMA); under the frozen-bias mode the constants
        bias_fixed_tau * (bias_fixed_avg + 2), a float64 0-d tensor, so that
        the bias and its scale round once into the engine dtype, as the JAX
        engine's Python constant does."""
        return bias_terms_plain(counters, self.mc.bias_norm, self.dt, self.cfg.reference,
                                fold=fold, fixed=self._bias_fixed)

    def _bias_den(self, counters):
        """The bias's denominator bias_norm * max_tau * (avg + 2), a 0-d
        tensor (float64 under the frozen-bias mode)."""
        return self._bias_terms(counters)[1].event_den

    def bias_func(self, theta_e, w, counters):
        """Scattering bias (harm_model.cpp:1391-1404) from the counters."""
        return bias_func(theta_e, w, self._bias_den(counters))

    def _bias_scale(self, counters):
        """The hot step's bias scale 100 / (bias_norm * max_tau * (avg + 2)),
        a 0-d tensor of the engine dtype.  Its inputs (max_tau_scatt,
        n_scatt_rec, n_recorded, avg_ema) change in the phases' records
        alone (the EMA fold is the full phase's record's), each of which
        leaves it in the engine's bias terms, so a block reads it there
        after each phase."""
        return self._bias_terms(counters)[1].scale

    def eval_fluid_xy(self, x1, x2):
        """(g7, fluid state) at arbitrary positions from the raw corner
        table, gathered by ``hot_kernels.row_gather``."""
        from grmonty_tpu_torch.transport import hot_kernels

        mc = self.mc
        g7 = geometry.gcov_c(x1, x2, mc.a, mc.h_slope, mc.r_0)
        return g7, fluid.get_fluid_params_c(x1, x2, self.tables.corner_rows, mc, g7=g7,
                                            gather_fn=hot_kernels.row_gather)

    # -- the hot iteration ----------------------------------------------------
    def hot_step(self, state: State, u_roul=None, u_x1=None, bias_scale=None) -> State:
        """One hot iteration (``hot_kernels.hot_step``: one fused kernel on
        the card, :func:`hot_step_plain` on the CPU).  ``u_roul``/``u_x1``:
        the roulette and optical-depth uniforms, drawn from the run's
        generator when None; ``bias_scale``: the 0-d bias scale, computed
        from the counters (:meth:`_bias_scale`) when None.  (A block on the
        card runs its hot steps as runs that draw their own uniforms,
        :meth:`hot_run`.)"""
        from grmonty_tpu_torch.transport import hot_kernels

        if bias_scale is None:
            bias_scale = self._bias_scale(state.counters)
        n = self.cfg.n_pool
        if u_roul is None:
            u_roul = self._uniform(n)
        if u_x1 is None:
            u_x1 = self._uniform(n)
        p, counters = hot_kernels.hot_step(
            state.pool, state.counters, u_roul, u_x1, bias_scale, self.mc, self.tables,
            self.cfg)
        return state._replace(pool=p, counters=counters, it=state.it + 1)

    def hot_run(self, state: State, steps, bias_scale, key, step0) -> State:
        """``steps`` hot iterations as one run, in place on the state's pool
        and census (``hot_kernels.hot_run``: one launch of the drawing
        kernel on the card, :func:`hot_run_plain` on the CPU), the uniforms
        of step j drawn under the block's ``key`` at its iteration ``step0 +
        j``; ``bias_scale``: the 0-d bias scale."""
        from grmonty_tpu_torch.transport import hot_kernels

        p, counters = hot_kernels.hot_run(state.pool, state.counters, key, step0, steps,
                                          bias_scale, self.mc, self.tables, self.cfg)
        return state._replace(pool=p, counters=counters, it=state.it + steps)

    # -- periodic phase -------------------------------------------------------
    def spectrum_add(self, spec, counters, p: Pool, width=None):
        """Record up to ``width`` (``ev_k`` when None) escaped lanes
        (harm_model.cpp:1291-1335); NaN-poisoned pending lanes are freed
        unrecorded (:func:`spectrum_add_plain`; on the card the record part
        of ``hot_kernels.record_phase``, in place), and the bias's terms
        taken.  Returns (spec, counters, pool)."""
        from grmonty_tpu_torch.transport import hot_kernels

        p, spec, counters = hot_kernels.record_phase(
            p, spec, counters, self.ev_k if width is None else width, self.mc, self.cfg,
            self._record_ticket, sweep=False, record=True, free=False, bias=self._bias_out)
        return spec, counters, p

    def process_scatters(self, p: Pool, sec: SecBuf, counters, bias_den):
        """Run deferred scatter events (compacted) and pack the secondaries
        into the ring (:func:`event_phase_plain`, :func:`pack_rows_plain`),
        at the bias's denominator ``bias_den`` (the full phase passes the
        engine's bias terms' ``event_den``, which its sweep leaves).  On
        the card three launches: the compaction (``hot_kernels.compact``),
        the whole event phase in place on the pool
        (``hot_kernels.event_phase``) and the ring's pack
        (``hot_kernels.compact_rows``)."""
        from grmonty_tpu_torch.transport import hot_kernels

        sel, room, wedged = event_set(p, sec, self.ev_k)
        p, counters, stage = hot_kernels.event_phase(p, counters, sel, room, wedged, bias_den,
                                                     self.mc, self.tables, gen=self.gen)
        sec, counters = hot_kernels.compact_rows(stage, sec, counters, self._rows_ticket)
        return p, sec, counters

    def refill_slots(self, sec: SecBuf, occupied, backlog_rows, backlog_pos, n_valid,
                     width=None):
        """Refill's slots (:class:`RefillSlots`): the first ``width``
        (``rf_k`` when None) free lanes, one ``hot_kernels.compact`` of the
        occupied mask inverted, and where they fill from."""
        from grmonty_tpu_torch.transport import hot_kernels

        k_w = self.rf_k if width is None else width
        valid, _, sidx = hot_kernels.compact(occupied, k_w, invert=True)
        return RefillSlots(valid, sidx, sec, backlog_rows, backlog_pos, n_valid)

    def _record_free_refill(self, p, spec, counters, sec, backlog_rows, backlog_pos,
                            n_valid, width=None, sweep=False, fold=False):
        """Record escaped lanes, free dead ones (after the poison sweep under
        ``sweep``; then the EMA fold under ``fold``), take the bias's terms,
        reload from ring/backlog and start the loaded lanes: on the card
        ``hot_kernels.record_phase`` (the sweep, the record, the frees, the
        fold and the terms in place), the compaction of the free lanes and
        ``hot_kernels.refill_fresh`` (the slots' sources, the load and the
        track start in place), with the bias's denominator from after the
        record, before the fold."""
        from grmonty_tpu_torch.transport import hot_kernels

        p, spec, counters = hot_kernels.record_phase(
            p, spec, counters, self.ev_k if width is None else width, self.mc, self.cfg,
            self._record_ticket, sweep=sweep, record=True, free=True, fold=fold,
            bias=self._bias_out)
        slots = self.refill_slots(sec, p.occupied, backlog_rows, backlog_pos, n_valid,
                                  width=width)
        p, sec, backlog_pos, counters = hot_kernels.refill_fresh(
            p, slots, counters, self._bias.refill_den, self.mc, self.tables, self.cfg,
            self._fresh_ticket)
        return p, spec, counters, sec, backlog_pos

    def periodic_phase(self, state: State, backlog_rows, n_valid=None) -> State:
        """The full phase: the poison sweep (which takes the bias's terms as
        it finds the counters), scatter events, record, free, the bias's
        EMA fold (shipped) and terms, refill, init."""
        from grmonty_tpu_torch.transport import hot_kernels

        if n_valid is None:
            n_valid = backlog_rows.shape[0]
        self.phases["full"] += 1
        # the sweep alone: it comes before the event set
        p, spec, counters = hot_kernels.record_phase(
            state.pool, state.spec, state.counters, self.ev_k, self.mc, self.cfg,
            self._record_ticket, sweep=True, record=False, free=False, bias=self._bias_out)
        p, sec, counters = self.process_scatters(p, state.sec, counters, self._bias.event_den)
        p, spec, counters, sec, backlog_pos = self._record_free_refill(
            p, spec, counters, sec, backlog_rows, state.backlog_pos, n_valid,
            fold=not self.cfg.reference)
        return state._replace(pool=p, spec=spec, counters=counters, sec=sec,
                              backlog_pos=backlog_pos)

    def light_phase(self, state: State, backlog_rows, n_valid=None) -> State:
        """The poison sweep, record, free and refill only (no scatter
        events, no RNG)."""
        if n_valid is None:
            n_valid = backlog_rows.shape[0]
        self.phases["light"] += 1
        p, spec, counters, sec, backlog_pos = self._record_free_refill(
            state.pool, state.spec, state.counters, state.sec, backlog_rows, state.backlog_pos,
            n_valid, width=self.light_k, sweep=True)
        return state._replace(pool=p, spec=spec, counters=counters, sec=sec,
                              backlog_pos=backlog_pos)

    # -- the block and the run ---------------------------------------------------
    def reserve_backlog(self, rows):
        """Size the static backlog buffer for waves of up to ``rows`` rows (a
        run handed more raises); a buffer already made smaller is dropped
        with its graph, and both are made again at the next run."""
        self.backlog_cap = max(1, int(rows))
        if self._backlog is not None and self._backlog.shape[0] < self.backlog_cap:
            self._backlog = self._graph = self._body_stream = self._body_pool = None

    def _load(self, state: State, backlog_rows, n_valid, tail_exit=None):
        """Copy the caller's ``state`` and backlog into the block's own
        tensors (made at the first call), set the valid rows' count and the
        run's ``tail_exit`` (``cfg.tail_exit`` when None) on the device and
        the exit word's body count to 0.  The bias's terms need no copy: the
        block's first launch, the full phase's sweep, writes them from the
        counters it finds."""
        n = backlog_rows.shape[0]
        if self._backlog is None:
            self._backlog = torch.zeros((max(n, self.backlog_cap), ROW_WIDTH), dtype=self.dt,
                                        device=self.device)
        if n > self._backlog.shape[0]:
            raise ValueError(f"a backlog of {n} rows for a buffer of {self._backlog.shape[0]} "
                             "(Engine.reserve_backlog)")
        if not 0 <= n_valid <= n:
            raise ValueError(f"n_valid {n_valid} outside [0, {n}]")
        if self._state is None:
            self._state = clone_state(state)
        else:
            assign_state(self._state, state)
        self._backlog[:n].copy_(backlog_rows)
        self._n_valid.fill_(n_valid)
        self._tail_exit.fill_(self.cfg.tail_exit if tail_exit is None else tail_exit)
        self._exit_word.zero_()

    def _exit_test(self, handle=None):
        """The exit test on the engine's own state, in place on the exit
        word and ``go`` (``hot_kernels.exit_test``: one launch on the card,
        :func:`exit_test_plain` on the CPU), and on ``handle``'s condition
        where given (the next block's node in a capture); it reads nothing
        on the host."""
        from grmonty_tpu_torch.transport import hot_kernels

        st = self._state
        hot_kernels.exit_test(st.pool.occupied, st.backlog_pos, st.sec.count, self._n_valid,
                              self._tail_exit, self._exit_word, self._go, self.n_super,
                              MAX_OUTER, handle=handle)

    def _body(self):
        """One block on the engine's own state, in place: the full phase,
        then the hot steps, each light phase and its hot steps (the JAX
        engine's while-loop body).  The hot steps read the bias scale that
        the last phase's record left in the engine's bias terms.  On the card
        the block draws one key (``hot_kernels.draw_key``) and each run of
        hot steps (an entry of ``blocks``) is one launch in place
        (:meth:`hot_run`), whose steps draw their uniforms at their indices
        in the block; on the CPU each hot step draws them from the
        generator.  It reads nothing on the host and makes no tensor from
        host data, so that it can be captured.  What the phases and runs
        did not write in place is copied into the state at the end
        (``assign_state``)."""
        from grmonty_tpu_torch.transport import hot_kernels

        st = self._state
        state = self.periodic_phase(st, self._backlog, self._n_valid)
        scale = self._bias.scale
        key = (hot_kernels.draw_key(self.gen, self.device) if self.device.type == "cuda"
               else None)
        step = 0
        for bi_, nb in enumerate(self.blocks):
            if bi_:
                state = self.light_phase(state, self._backlog, self._n_valid)
            if key is None:
                for _ in range(nb):
                    state = self.hot_step(state, bias_scale=scale)
            else:
                state = self.hot_run(state, nb, scale, key, step)
            step += nb
        assign_state(st, state)

    def _counting(self, fn):
        """Run ``fn`` and return what it added to the kernels' launch counts
        and to the phase counts, ({name: n}, {phase: n}), leaving both as
        they were."""
        from grmonty_tpu_torch.transport import hot_kernels

        phases0 = dict(self.phases)
        try:
            launched = hot_kernels.launches_during(fn)
        finally:
            phased = {k: v - phases0[k] for k, v in self.phases.items() if v != phases0[k]}
            self.phases.update(phases0)
        return launched, phased

    def _guarded(self, guard, body=None, handles=None):
        """A replay's blocks: ``graph_bodies`` times the block
        (``body``, :meth:`_body` when None) under ``guard(self._go, body)``,
        then the exit test after it, whose word guards the next block;
        ``handles`` (the capture's, :meth:`_if_node`): the blocks'
        conditional handles, the test after block i setting block i + 1's."""
        for i in range(self.graph_bodies):
            guard(self._go, body or self._body)
            nxt = i + 1
            self._exit_test(handles[nxt] if handles and nxt < len(handles) else None)

    def _if_node(self):
        """The guard of the capture and the blocks' conditional handles
        (``hot_kernels.exit_handle``): each call of the guard captures the
        function it is given under a conditional IF node on the next handle
        (``hot_kernels.exit_guard``, the block's own stream and memory
        pool), which a replay runs only where that handle's condition is
        set: the first block's from its predicate at the replay's head, each
        other block's by the exit test before it."""
        from grmonty_tpu_torch.transport import hot_kernels

        handles = [hot_kernels.exit_handle(self.device) for _ in range(self.graph_bodies)]
        nodes = iter(enumerate(handles))

        def guard(pred, fn):
            i, handle = next(nodes)
            hot_kernels.exit_guard(handle, fn, self._body_stream, self._body_pool,
                                   go=pred if i == 0 else None)
        return guard, handles

    def capture(self, state: State, backlog_rows, n_valid=None):
        """Capture a replay into a CUDA graph at a graphed engine's first
        run (else do nothing): ``graph_bodies`` blocks, each under a
        conditional node on the exit word's ``go`` and followed by the exit
        test (:meth:`_guarded`; the nodes :meth:`_if_node`).  One
        eager block and exit test on a side
        stream first load every kernel and fill the wrappers' caches and
        measure what a block advances the generator by; then the capture
        records the replay with the run's generator registered.  The launch
        and phase counts, the generator and the engine's copy of ``state``
        are left as they were found; what one block adds to the counts, and
        what a replay adds besides its blocks (its exit tests), are kept and
        credited by the blocks and replays a run ran.  The garbage collector
        is off during the capture.  Returns the seconds it took.  A capture
        that fails, or a conditional node that the CUDA runtime refuses,
        raises: a graphed engine never falls back to the host loop."""
        if not self.graphed or self._graph is not None:
            return 0.0
        t0 = time.monotonic()
        graph = torch.cuda.CUDAGraph()
        # the capture's stream and the blocks' (torch hands out streams from
        # a pool, so two asks can give one stream: the blocks' must not be
        # the one capturing) and the blocks' memory pool, made outside the
        # capture and kept with the graph: the pool holds what they allocate
        capture_stream = torch.cuda.Stream(self.device)
        self._body_stream = torch.cuda.Stream(self.device)
        while self._body_stream.cuda_stream == capture_stream.cuda_stream:
            self._body_stream = torch.cuda.Stream(self.device)
        self._body_pool = torch.cuda.MemPool()
        nv = backlog_rows.shape[0] if n_valid is None else n_valid
        self._load(state, backlog_rows, nv)
        gen_state = self.gen.get_state()
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        offset0 = self.gen.get_offset()
        with torch.cuda.stream(side):
            self._counting(self._body)
            step = self.gen.get_offset() - offset0
            self._counting(self._exit_test)
        cur.wait_stream(side)
        graph.register_generator_state(self.gen)
        bodies = []

        def body():
            bodies.append(self._counting(self._body))

        # No collection inside the capture: another engine's graph left in a
        # reference cycle and collected there would be destroyed inside it,
        # which the driver refuses and which invalidates the capture.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: another thread's CUDA calls (a process group's
            # watchdog) stay legal while this thread captures
            with torch.cuda.graph(graph, stream=capture_stream,
                                  capture_error_mode="thread_local"):
                guard, handles = self._if_node()
                guards = self._counting(lambda: self._guarded(guard, body, handles))
        finally:
            if collecting:
                gc.enable()
        if len(bodies) != self.graph_bodies or any(b != bodies[0] for b in bodies):
            raise RuntimeError(f"capture: {len(bodies)} blocks of {self.graph_bodies} captured, "
                               f"counting {bodies}")
        self.gen.set_state(gen_state)
        self._load(state, backlog_rows, nv)
        torch.cuda.synchronize(self.device)
        self._graph, self._credit, self._gen_step = graph, (bodies[0], guards), step
        return time.monotonic() - t0

    def _replay(self):
        """One replay of the graph: its blocks run where their exit tests
        say (what it launched is credited by :meth:`_run_replays`)."""
        self._graph.replay()
        self.replays += 1

    def _word_handle(self, j):
        """Copy the exit word into the host's slot ``j % 2`` behind the
        work queued so far (pinned, without waiting on the card) and mark
        it with that slot's event; returns the handle for :meth:`_read`."""
        slot = self._host_words[j % 2]
        slot.copy_(self._exit_word, non_blocking=True)
        event = None
        if self._word_events is not None:
            event = self._word_events[j % 2]
            event.record()
        return slot, event

    @staticmethod
    def _read(handle):
        """Wait for a word's copy (:meth:`_word_handle`) and read it."""
        slot, event = handle
        if event is not None:
            event.synchronize()
        return ExitWord(*slot.tolist())

    def _gen_offset(self):
        return self.gen.get_offset()

    def _set_gen_offset(self, offset):
        self.gen.set_offset(offset)

    def _run_replays(self):
        """The blocks of a graphed run (:func:`pipelined_loop`): the entry
        test's word, then one replay ahead of each word read.  Credits the
        blocks' launches and phases by the blocks run and the exit tests by
        the replays (:func:`run_credit`), and rewinds the
        generator to where an eager run of as many blocks leaves it
        (:func:`rewound_offset`)."""
        from grmonty_tpu_torch.transport import hot_kernels

        base = self._gen_offset()
        issued = [0]

        def launch():
            self._replay()
            issued[0] += 1
            return self._word_handle(issued[0])

        out = pipelined_loop(self._word_handle(0), launch, self._read, self.n_super)
        self._set_gen_offset(rewound_offset(self._gen_offset(), base, self._gen_step,
                                            self.graph_bodies, out.replays, out.word.bodies))
        launched, phased = run_credit(*self._credit, out.word.bodies, out.replays)
        hot_kernels.credit(launched)
        for k, v in phased.items():
            self.phases[k] += v
        self.skipped += out.skipped
        return out

    def _test_and_read(self):
        """The exit test after an eager block, its word read on the host."""
        self._exit_test()
        return ExitWord(*self._exit_word.tolist())

    def run(self, state: State, backlog_rows, tail_exit=None, n_valid=None) -> State:
        """Run blocks until the backlog and the ring are spent and at most
        ``tail_exit`` lanes remain occupied, then flush the pending records.
        The block runs on the engine's copy of ``state`` and
        ``backlog_rows``'s first ``n_valid`` rows (all when None).  The exit
        test (:meth:`_exit_test`) runs on the device at the entry and after
        every block.  Graphed (captured here at the first run, unless
        :meth:`capture` ran first), each replay's blocks run under
        conditional nodes on its word, and the host reads each replay's word
        while the next replay runs (:func:`pipelined_loop`); else each
        block is issued op by op and the word read after it
        (:func:`host_loop`).  Returns a state of tensors of its own, which
        no later run overwrites."""
        nv = backlog_rows.shape[0] if n_valid is None else n_valid
        self.capture(state, backlog_rows, nv)
        self._load(state, backlog_rows, nv, tail_exit)
        self._exit_test()
        if self.graphed:
            out = self._run_replays()
        else:
            out = host_loop(ExitWord(*self._exit_word.tolist()), self._body,
                            self._test_and_read, self.n_super)
        self.runs += 1
        self.bodies += out.word.bodies
        state = clone_state(self._state)._replace(it=state.it + out.word.bodies * self.n_super)
        # final flush of pending records; a record_pending lane still holding
        # an unconsumed detached event records on a later phase
        spec, counters, p = state.spec, state.counters, state.pool
        while bool((p.record_pending & ~p.ev_pending).any()):
            self.flushes += 1
            spec, counters, p = self.spectrum_add(spec, counters, p)
        return state._replace(pool=p, spec=spec, counters=counters)
