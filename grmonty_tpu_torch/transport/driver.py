"""The simulation driver: dump -> tables -> emission -> transport -> spectrum.

Port of ``grmonty_tpu/transport/driver.py`` (``Simulation``).  Everything
runs on one explicit ``device``:

* the per-dump tables (zone geometry and fluid state, the emission weight
  and budget tables, the emission tetrads, the inverse-CDF frequency
  tables and the two bilinear corner tables) are built in torch on the
  device, float64;
* :meth:`Simulation.plan` rounds the per-zone budgets to counts and orders
  the photons by a strided permutation of the zone sweep (the shipped
  profile) or in plan order, the zone sweep itself (reference semantics,
  ``EngineConfig.reference``);
* :meth:`Simulation.run` is the JAX driver's schedule: the **pilot**
  (:meth:`Simulation._run_pilot`: ``warmup`` photons at evenly spaced plan
  indices, tracked one at a time by the native scalar tracker, whose bias
  feedback counters are injected before the first wave); the **waves**
  (:func:`wave_list`: the first ``emit_chunk`` ramped in 1/8, 1/8, 1/4 and
  the rest, then whole chunks; each emitted on the device and run through
  the engine until its backlog is consumed, the pool staying full across
  the hand-off); the **tail cascade** (:meth:`Simulation._drain_tail`: the
  last photons drained in pools of ``n_pool``, 4,096 and 512 lanes, moved
  between them by :func:`tail_gather` / :func:`tail_merge`).  The spectrum
  accumulates on the host in float64 after every wave and stage;
* with a ``checkpoint_path`` the run saves a resume point after the pilot
  and after each wave and resumes from it (:meth:`Simulation.save_checkpoint`);
  the point carries the run's clocks (wall seconds, ``device_s``) and the
  engines' phase counts, so a resumed run reports the whole run's;
* :meth:`Simulation.run_native_cpu` tracks the whole plan with the native
  scalar tracker instead of the engine.

One ``torch.Generator`` on the device, seeded from ``seed``, serves the
whole run.  The engine's time is clocked by CUDA events on a CUDA device
(``device_s``) next to the wall clock.  On a CUDA device the kernels are
built (or loaded) when the ``Simulation`` is made, outside every device
window, and the seconds that took are reported as ``compile_s``.
"""

from __future__ import annotations

import logging
import math
import os
import time

import numpy as np
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.models import harm
from grmonty_tpu_torch.ops import emission, fluid
from grmonty_tpu_torch.ops import spectrum as spectrum_ops
from grmonty_tpu_torch.transport import engine as engine_mod
from grmonty_tpu_torch.transport import hot_kernels, oracle_native
from grmonty_tpu_torch.utils import tables as tables_mod

log = logging.getLogger(__name__)

# Spectrum accumulator channels carrying photon weight (all but nph, nscatt
# and the two secondary-count channels) and the one quadratic in it.
_W_CHANNELS = [0, 1, 4, 5, 6, 7, 8, 9, 10, 11, 12]
_W2_CHANNELS = [13]
# The tail cascade's pool widths below the full pool.
TAIL_WIDTHS = (4096, 512)


def unscale_spectrum(spec: np.ndarray, weight_scale: float) -> np.ndarray:
    """Undo the engine's weight scaling on the weighted channels."""
    if weight_scale == 1.0:
        return spec
    spec = spec.copy()
    spec[:, _W_CHANNELS] /= weight_scale
    spec[:, _W2_CHANNELS] /= weight_scale * weight_scale
    return spec


def build_host_tables(model, mc, photon_n, device):
    """The per-dump init products, float64 on ``device`` (the JAX
    driver's ``_build_host``).  Returns a dict of tensors."""
    f64 = torch.float64
    f_np, k2_np = tables_mod.jnu_tables()
    f_t = torch.as_tensor(f_np, dtype=f64, device=device)
    k2_t = torch.as_tensor(k2_np, dtype=f64, device=device)
    prims = torch.as_tensor(model.data.stacked(), dtype=f64, device=device)

    zone_x, g_cov, g_con, g_det = fluid.precompute_zone_geometry(mc, device, f64)
    fz = fluid.get_fluid_zone(prims, g_cov, g_con, mc)
    weights = emission.weight_table(fz, g_det, mc, photon_n, f_t, k2_t)
    nint_t, dndmax_t = emission.nint_table(weights, mc, f_t)
    nz, dn_max = emission.zone_budgets(fz, g_det, nint_t, dndmax_t, k2_t, photon_n)
    e_con, e_cov = emission.zone_tetrads(fz, g_cov, mc.b_unit)
    zone_map, lnr, cdf = emission.build_nu_cdf(fz.theta_e, fz.b, weights, f_t, nz)
    return dict(
        prims=prims, f_t=f_t, k2_t=k2_t, zone_x=zone_x, g_cov_z=g_cov, g_con_z=g_con,
        g_det_z=g_det, fluid_zone=fz, weights=weights, nz=nz, dn_max=dn_max,
        e_con_z=e_con, e_cov_z=e_cov, derived11=fluid.derived11(fz),
        nu_zone_map=zone_map, nu_lnrho=lnr, nu_cdf=cdf,
    )


def build_engine_tables(host, mc, dtype) -> engine_mod.EngineTables:
    """The engine's device tables: the Chebyshev hotcross surface, the K2
    series, the raw and the derived corner tables."""
    dev = host["prims"].device
    hc = tables_mod.fit_hotcross(tables_mod.hotcross_table())
    return engine_mod.EngineTables(
        hc_coeffs=torch.as_tensor(hc, dtype=dtype, device=dev),
        k2_coeffs=np.asarray(tables_mod.fit_k2()),
        corner_rows=fluid.make_corner_table(host["prims"], mc.n1, mc.n2).to(dtype),
        hot_tab=fluid.pack_corner_rows(host["derived11"], mc.n2).to(dtype).contiguous(),
    )


def warm_counters(counters, n_recorded, n_scatt_rec, max_tau_scatt, avg):
    """``counters`` with the pilot's bias feedback state injected:
    ``n_recorded``, ``n_scatt_rec``, ``max_tau_scatt``, ``avg_ema`` and the
    two EMA marks; the floats in the counters' dtype."""
    dt, dev = counters.max_tau_scatt.dtype, counters.max_tau_scatt.device

    def i64(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    return counters._replace(
        n_recorded=i64(n_recorded), n_scatt_rec=i64(n_scatt_rec),
        max_tau_scatt=torch.tensor(max_tau_scatt, dtype=dt, device=dev),
        avg_ema=torch.tensor(avg, dtype=dt, device=dev),
        ema_scatt_mark=i64(n_scatt_rec), ema_rec_mark=i64(n_recorded))


def wave_list(total, chunk, n_pool, wave_tail_exit):
    """The run's waves as (first plan photon, photons, exit occupancy).

    When the plan outgrows one chunk (``total > chunk >= 8``) the first
    chunk is ramped in 1/8, 1/8, 1/4 and the rest, so that the population
    exposed to the still-converging bias counters grows step by step (the
    JAX driver's first-wave ramp); whole chunks follow.  Every wave hands
    off with ``wave_tail_exit`` lanes occupied but the last, which drains
    to ``min(n_pool // 16, wave_tail_exit)`` before the tail cascade."""
    waves, cs = [], 0
    if total > chunk >= 8:
        for part in (chunk // 8, chunk // 8, chunk // 4):
            waves.append((cs, part))
            cs += part
        waves.append((cs, chunk - cs))
        cs = chunk
    waves += [(c0, min(chunk, total - c0)) for c0 in range(cs, total, chunk)]
    last = min(max(1, n_pool // 16), wave_tail_exit)
    return [(s, n, last if i + 1 == len(waves) else wave_tail_exit)
            for i, (s, n) in enumerate(waves)]


def _map_pool(fn, *pools):
    """``fn`` over every (N,) lane tensor of ``pools``, field by field (the
    4-vector fields component by component; a field that is off, the empty
    tuple, stays so); returns a ``Pool``."""
    out = {}
    for name in engine_mod.Pool._fields:
        vals = [getattr(p, name) for p in pools]
        if isinstance(vals[0], tuple):
            out[name] = tuple(fn(*comps) for comps in zip(*vals))
        else:
            out[name] = fn(*vals)
    return engine_mod.Pool(**out)


def tail_gather(pool, n_t):
    """The first ``n_t`` occupied lanes of ``pool`` -> (small pool of
    ``n_t`` lanes, the wide pool with those lanes emptied).  The small
    pool's padding lanes copy the last lane and are masked: not occupied,
    alive, pend_push, at_event, record_pending or ev_pending."""
    occ = pool.occupied
    valid, gi, _ = engine_mod.compact_idx(occ, n_t)
    take = occ & (torch.cumsum(occ.to(torch.int64), 0) <= n_t)
    small = _map_pool(lambda a: a[gi], pool)
    small = small._replace(**{name: getattr(small, name) & valid for name in (
        "occupied", "alive", "pend_push", "at_event", "record_pending", "ev_pending")})
    wide = pool._replace(occupied=occ & ~take, alive=pool.alive & ~take)
    return small, wide


def tail_merge(wide, small):
    """Scatter the occupied lanes of ``small`` into the first free lanes of
    ``wide``, in order; returns the merged wide pool."""
    n_t = small.occupied.shape[0]
    n_pool = wide.occupied.shape[0]
    _, _, free_idx = engine_mod.compact_idx(~wide.occupied, n_t)
    occ = small.occupied
    lrank = torch.cumsum(occ.to(torch.int64), 0) - 1
    dest = torch.where(occ, free_idx[torch.clamp(torch.where(occ, lrank, 0), max=n_t - 1)],
                       n_pool)
    return _map_pool(lambda aw, al: engine_mod.put(aw, dest, al), wide, small)


def _flat_state(state):
    """{name: tensor} of every tensor of an engine ``State``."""
    out = {}
    for name in engine_mod.Pool._fields:
        v = getattr(state.pool, name)
        if isinstance(v, tuple):
            out.update({f"pool.{name}.{i}": c for i, c in enumerate(v)})
        else:
            out[f"pool.{name}"] = v
    out["spec"] = state.spec
    out.update({f"counters.{name}": getattr(state.counters, name)
                for name in engine_mod.Counters._fields})
    out["sec.rows"], out["sec.count"] = state.sec.rows, state.sec.count
    out["backlog_pos"] = state.backlog_pos
    return out


def _unflat_state(dat, it, device):
    """The engine ``State`` of :func:`_flat_state`'s arrays, on ``device``."""
    def t(name):
        return torch.as_tensor(dat[name]).to(device)

    pool = {}
    for name in engine_mod.Pool._fields:
        if f"pool.{name}" in dat:
            pool[name] = t(f"pool.{name}")
        else:  # a tuple field: 4 components, or none when it is off
            pool[name] = tuple(t(f"pool.{name}.{i}") for i in range(4)
                               if f"pool.{name}.{i}" in dat)
    return engine_mod.State(
        pool=engine_mod.Pool(**pool), spec=t("spec"),
        counters=engine_mod.Counters(**{name: t(f"counters.{name}")
                                        for name in engine_mod.Counters._fields}),
        sec=engine_mod.SecBuf(rows=t("sec.rows"), count=t("sec.count")),
        backlog_pos=t("backlog_pos"), it=it)


class Simulation:
    """One HARM snapshot and photon budget -> spectrum, on ``device`` (the
    CUDA card unless the caller asks for the CPU)."""

    def __init__(self, dump_path: str, photon_n: int = 5_000_000,
                 mass_unit: float = 4.0e19, seed: int = consts.RNG_SEED,
                 config: engine_mod.EngineConfig | None = None,
                 device: torch.device | str = "cuda", emit_chunk: int = 1 << 20,
                 warmup: int = 1024,
                 wave_tail_exit: int | None = None,
                 tail_grow_cap: float | None = None,
                 tail_stall_steps: int | None = None):
        self.device = torch.device(device)
        # the seconds this Simulation spent building or loading the kernels:
        # 0.0 on the CPU and where the process already holds them
        self.compile_s = 0.0
        if self.device.type == "cuda" and not hot_kernels.built():
            t_build = time.monotonic()
            hot_kernels.build()
            self.compile_s = time.monotonic() - t_build
        self.photon_n = photon_n
        self.emit_chunk = emit_chunk
        self.warmup = warmup
        self.cfg = config or engine_mod.EngineConfig()
        self.tail_grow_cap = tail_grow_cap
        self.tail_stall_steps = tail_stall_steps
        self._wave_tail_exit = (max(1, self.cfg.n_pool // 16) if wave_tail_exit is None
                                else wave_tail_exit)
        self.seed = seed
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

        self.model = harm.read_dump(dump_path, mass_unit)
        self.mc = fluid.make_model_consts(self.model)
        log.info("Initializing tables")
        self.host = build_host_tables(self.model, self.mc, photon_n, self.device)
        self.tables = build_engine_tables(self.host, self.mc, self.cfg.dtype)
        self.engine = engine_mod.Engine(
            self.mc, self.cfg._replace(tail_exit=self._wave_tail_exit), self.tables,
            self.device, self.gen)
        self._zone_tabs = self._zone_tables(self.cfg.dtype)
        self._zone_tabs64 = None  # float64 zone tables of the pilot, made at first use
        self._sampler_tabs = emission.SamplerTables(
            zone_map=self.host["nu_zone_map"], lnrho=self.host["nu_lnrho"],
            cdf=self.host["nu_cdf"],
            theta_q=torch.as_tensor(tables_mod.theta_quantiles(), device=self.device))
        self._tail_engines = {}  # (pool, exit occupancy) -> cascade Engine
        self._stride = 0
        self._total = 0
        self.spec_acc = np.zeros((engine_mod.N_BINS + 1, engine_mod.N_SPEC_CHAN))
        self.device_s = None  # CUDA-event window of the engine runs (CUDA only)
        # the run's wall clock: its start in this process, and the seconds of
        # its earlier parts that a resumed checkpoint carries
        self._t_run, self._resumed_s = time.monotonic(), 0.0
        # The pilot's (n_recorded, n_scatt_rec), injected into the counters
        # and debited from the run's: its spectrum is dropped.
        self._warm_counts = None
        self.pilot = None  # what the pilot did (photons, counters, host seconds)
        self.tail_stages = []  # one record per cascade stage run

    def _zone_tables(self, dt):
        h = self.host
        fz = h["fluid_zone"]
        z = self.mc.n1 * self.mc.n2
        dead = (h["dn_max"] <= 0.0) | (fz.theta_e < consts.THETA_E_MIN)
        ln_dn_max = torch.where(h["dn_max"] > 0.0,
                                torch.log(torch.clamp(h["dn_max"], min=1e-300)), -math.inf)
        return emission.ZoneTables(
            x=h["zone_x"].reshape(z, 4).to(dt), theta_e=fz.theta_e.reshape(z).to(dt),
            n_e=fz.n_e.reshape(z).to(dt), b=fz.b.reshape(z).to(dt),
            dead=dead.reshape(z), ln_dn_max=ln_dn_max.reshape(z).to(dt),
            e_con=h["e_con_z"].reshape(z, 4, 4).to(dt),
            e_cov=h["e_cov_z"].reshape(z, 4, 4).to(dt), weights=h["weights"].to(dt))

    # ------------------------------------------------------------------
    def plan(self) -> emission.EmissionPlan:
        """Per-zone photon counts -> the flat photon -> zone map
        (harm_model.cpp:673-704), and the emission order."""
        counts = emission.zone_counts(self.gen, self.host["nz"]).cpu().numpy()
        plan = emission.plan_emission(counts)
        self._total = plan.total
        self._stride = 0 if self.cfg.reference else self._pick_stride(plan.total)
        z = self.mc.n1 * self.mc.n2
        cum = np.zeros(z + 1, np.int64)
        np.cumsum(counts.reshape(-1), out=cum[1:])
        self._cum = torch.as_tensor(cum, device=self.device)
        log.info("Emission plan: %d superphotons from %d zones (stride %d; 0: plan order)",
                 plan.total, int((counts > 0).sum()), self._stride)
        return plan

    @staticmethod
    def _pick_stride(total):
        """A stride coprime to ``total`` near the golden-ratio fraction."""
        s = max(1, int(total * 0.6180339887498949)) | 1
        while math.gcd(s, total) != 1:
            s += 2
        return s

    def _sample(self, t, dtype, ln_w_offset):
        """Packed (len(t), 16) rows of the plan photons ``t`` (plan indices
        on the device), sampled in ``dtype`` (the engine's, or float64) by
        the path's own sampler: inverse CDF, or rejection under reference
        semantics."""
        zflat = torch.clamp(torch.searchsorted(self._cum, t, right=True) - 1,
                            0, self._cum.shape[0] - 2)
        if dtype == self.cfg.dtype:
            zt = self._zone_tabs
        else:
            if self._zone_tabs64 is None:
                self._zone_tabs64 = self._zone_tables(torch.float64)
            zt = self._zone_tabs64
        if self.cfg.reference:
            return emission.sample_photons(self.gen, zflat, zt, self.host["f_t"].to(dtype),
                                           dtype, ln_w_offset=ln_w_offset)
        return emission.sample_photons_cdf(self.gen, zflat, zt, self._sampler_tabs, dtype,
                                           ln_w_offset=ln_w_offset)

    def emit_rows(self, start, count):
        """Packed (count, 16) backlog rows of plan photons
        [start, start + count) in emission order, sampled on the device
        with weights in engine units."""
        t = torch.arange(start, start + count, dtype=torch.int64, device=self.device)
        if self._stride:
            t = (t * self._stride) % self._total
        return self._sample(t, self.cfg.dtype, math.log(engine_mod.WEIGHT_SCALE))

    def _drain_spec(self, state):
        self.spec_acc += state.spec.double().cpu().numpy()
        return state._replace(spec=torch.zeros_like(state.spec))

    def _timed_run(self, eng, state, backlog, tail_exit=None, n_valid=None):
        """engine.run with its device window added to ``device_s``; returns
        (state, the window's seconds, None off the card)."""
        if self.device.type != "cuda":
            return eng.run(state, backlog, tail_exit=tail_exit, n_valid=n_valid), None
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state = eng.run(state, backlog, tail_exit=tail_exit, n_valid=n_valid)
        t1.record()
        t1.synchronize()
        secs = t0.elapsed_time(t1) / 1e3
        self.device_s = (self.device_s or 0.0) + secs
        return state, secs

    # -- the pilot ----------------------------------------------------------
    def _pilot_rows(self, warm):
        """(warm, 16) float64 rows of the plan photons at indices
        linspace(0, total - 1, warm) (plan order, not the emission
        stride), with raw weights."""
        idx = np.asarray(np.linspace(0, self._total - 1, warm), np.int64)
        return self._sample(torch.as_tensor(idx, device=self.device), torch.float64, 0.0)

    def _host_warm_counters(self, rows, counters):
        """Track the pilot's rows (raw weights) with the native scalar
        tracker (seed ``seed + 7``) and return ``counters`` with its bias
        feedback state injected: ``n_recorded``, ``n_scatt_rec``,
        ``max_tau_scatt``, ``avg_ema`` = n_scatt_rec / n_recorded and the
        two EMA marks; the floats in the engine dtype."""
        t_p = time.monotonic()
        tracker = oracle_native.NativeTracker(self.mc, self.model.data.stacked(),
                                              seed=self.seed + 7)
        tracker.run(oracle_native.photons_from_rows(rows), progress_every=0)
        avg = tracker.n_scatt_rec / max(tracker.n_recorded, 1)
        warmed = warm_counters(counters, tracker.n_recorded, tracker.n_scatt_rec,
                               tracker.max_tau_scatt, avg)
        self.pilot = dict(photons=int(rows.shape[0]), n_recorded=tracker.n_recorded,
                          n_scatt_rec=tracker.n_scatt_rec,
                          max_tau_scatt=tracker.max_tau_scatt, avg=avg,
                          host_s=time.monotonic() - t_p)
        log.info("pilot done (host tracker, %.1f s): rec=%d scatt=%d max_tau=%.3g",
                 self.pilot["host_s"], tracker.n_recorded, tracker.n_scatt_rec,
                 tracker.max_tau_scatt)
        return warmed

    def _run_pilot(self, state, warm):
        """The bias warm-up: ``warm`` photons spread over the plan, tracked
        by the native tracker, whose per-photon feedback converges the
        scattering-bias counters as the reference's sequential run does;
        they are injected before the first wave.  The pilot's spectrum is
        dropped and its counts are debited at the end of the run."""
        log.info("pilot: %d photons (bias warm-up)", warm)
        counters = self._host_warm_counters(self._pilot_rows(warm), state.counters)
        self._warm_counts = (int(counters.n_recorded), int(counters.n_scatt_rec))
        return state._replace(counters=counters)

    # -- the waves ----------------------------------------------------------
    def _run_wave(self, state, c, n_waves, start, count, tail_exit):
        """Emit plan photons [start, start + count) and run them through the
        wave engine until at most ``tail_exit`` lanes remain occupied."""
        backlog = self.emit_rows(start, count)
        state = state._replace(backlog_pos=torch.zeros_like(state.backlog_pos))
        state, _ = self._timed_run(self.engine, state, backlog, tail_exit=tail_exit)
        state = self._drain_spec(state)
        log.info("wave %d/%d: %d photons from %d, it=%d rec=%d", c + 1, n_waves, count,
                 start, state.it, int(state.counters.n_recorded))
        return state

    # -- the tail cascade ----------------------------------------------------
    def _tail_sizes(self):
        """The cascade's pool widths: the full pool, then 4,096 and 512,
        each no wider than the pool."""
        return sorted({s for s in (self.cfg.n_pool, *TAIL_WIDTHS) if s <= self.cfg.n_pool},
                      reverse=True)

    def _tail_engine(self, n_t, exit_occ):
        """The cascade stage's engine, one per (width, exit occupancy): no
        backlog, the full phase every 64 iterations and no light phases,
        the tail's step growth and step cap; the ring (``sec_cap``) as it is,
        so the queued secondaries pass from stage to stage."""
        key = (n_t, exit_occ)
        if key not in self._tail_engines:
            cfg = self.cfg._replace(
                n_pool=n_t, tail_exit=exit_occ, m_period=64, refill_period=0,
                grow_cap=(self.tail_grow_cap if self.tail_grow_cap is not None
                          else self.cfg.grow_cap),
                stall_steps=(self.tail_stall_steps if self.tail_stall_steps is not None
                             else self.cfg.stall_steps))
            self._tail_engines[key] = engine_mod.Engine(self.mc, cfg, self.tables,
                                                        self.device, self.gen)
        return self._tail_engines[key]

    def _drain_tail(self, state):
        """Finish the stragglers in a cascade of shrinking pools: each stage
        gathers the occupied lanes into its own pool, runs until at most the
        next stage's width remains (0 at the last) with the ring empty, and
        merges the leftovers back.  A handful of photons near the photon
        orbit run to the step cap; the narrow pools make each of their
        iterations cheap."""
        sizes = self._tail_sizes()
        empty = torch.zeros((1, engine_mod.ROW_WIDTH), dtype=self.cfg.dtype,
                            device=self.device)
        for si, n_t in enumerate(sizes):
            exit_occ = sizes[si + 1] if si + 1 < len(sizes) else 0
            eng = self._tail_engine(n_t, exit_occ)
            while True:
                occ_n, sec_n = torch.stack([state.pool.occupied.sum(),
                                            state.sec.count]).tolist()
                if occ_n <= exit_occ and sec_n == 0:
                    break
                small, wide = tail_gather(state.pool, n_t)
                tstate = engine_mod.State(
                    pool=small, spec=state.spec, counters=state.counters, sec=state.sec,
                    backlog_pos=torch.zeros_like(state.backlog_pos), it=0)
                tstate, secs = self._timed_run(eng, tstate, empty, n_valid=0)
                state = state._replace(pool=tail_merge(wide, tstate.pool), spec=tstate.spec,
                                       counters=tstate.counters, sec=tstate.sec)
                self.tail_stages.append(dict(pool=n_t, exit=exit_occ, stragglers=occ_n,
                                             secondaries=sec_n, iters=tstate.it,
                                             device_s=secs))
                log.info("tail drain [pool %d]: %d stragglers (+%d queued secondaries), "
                         "%d iterations", n_t, occ_n, sec_n, tstate.it)
        return self._drain_spec(state)

    # -- checkpoints ----------------------------------------------------------
    SETUP_FIELDS = ("photon_n", "n_pool", "emit_chunk", "reference", "trace_birth", "dtype")

    def _setup(self):
        """The run setup a checkpoint must match (``SETUP_FIELDS``; the
        engine dtype as its bits, 32 or 64)."""
        return (self.photon_n, self.cfg.n_pool, self.emit_chunk, int(self.cfg.reference),
                int(self.cfg.trace_birth), torch.finfo(self.cfg.dtype).bits)

    def _elapsed(self):
        """The run's wall seconds so far, its resumed parts included."""
        return self._resumed_s + (time.monotonic() - self._t_run)

    def save_checkpoint(self, path, waves_done, state):
        """Write a resume point atomically (a temporary file, then
        ``os.replace``): every tensor of the engine ``state`` (on the CPU),
        the host spectrum, the generator's state (one generator serves
        emission and engine, so it covers every draw so far), the run's
        clocks (wall seconds and ``device_s``, NaN off the card) and its
        engines' full and light phases, and the setup it belongs to, with
        the pilot's baseline."""
        payload = {k: v.detach().cpu().numpy() for k, v in _flat_state(state).items()}
        payload["spec_acc"] = self.spec_acc
        payload["gen_state"] = self.gen.get_state().numpy()
        payload["clocks"] = np.asarray(
            [self._elapsed(), math.nan if self.device_s is None else self.device_s], np.float64)
        engines = [self.engine, *self._tail_engines.values()]
        payload["phases"] = np.asarray([sum(e.phases[p] for e in engines)
                                        for p in ("full", "light")], np.int64)
        w_rec, w_scatt = self._warm_counts or (0, 0)
        payload["meta"] = np.asarray([waves_done, *self._setup(), w_rec, w_scatt, state.it],
                                     np.int64)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
        log.info("checkpoint: %d wave(s) done -> %s", waves_done, path)

    def checkpoint_setup(self, path):
        """The run setup (:meth:`_setup`'s fields) a checkpoint file holds."""
        with np.load(path, allow_pickle=False) as dat:
            return tuple(int(v) for v in dat["meta"][1:1 + len(self._setup())])

    def load_checkpoint(self, path):
        """Restore (waves_done, state) from :meth:`save_checkpoint`'s file,
        with the host spectrum, the generator, the pilot's baseline, the
        run's clocks and the phase counts (into the wave engine, the only
        one a resume point follows); raises ``ValueError`` for a file of
        another run setup."""
        n = len(self._setup())
        with np.load(path, allow_pickle=False) as dat:
            meta = [int(v) for v in dat["meta"]]
            setup = tuple(meta[1:1 + n])
            if setup != self._setup():
                raise ValueError(
                    f"checkpoint {path} was written by a different run setup: "
                    f"{'/'.join(self.SETUP_FIELDS)} {setup} != {self._setup()}")
            w_rec, w_scatt, it = meta[1 + n:4 + n]
            state = _unflat_state(dat, it, self.device)
            self.spec_acc = dat["spec_acc"].astype(np.float64)
            self.gen.set_state(torch.as_tensor(dat["gen_state"]))
            elapsed, device_s = (float(v) for v in dat["clocks"])
            full, light = (int(v) for v in dat["phases"])
        self._resumed_s = elapsed
        if self.device.type == "cuda":
            self.device_s = device_s if math.isfinite(device_s) else 0.0
        self.engine.phases = {"full": full, "light": light}
        self._warm_counts = (w_rec, w_scatt) if (w_rec or w_scatt) else None
        return meta[0], state

    # -- the run --------------------------------------------------------------
    def _waves(self, total):
        """The run's waves (first emission index, photons, exit occupancy):
        :func:`wave_list` over the whole plan."""
        return wave_list(total, self.emit_chunk, self.cfg.n_pool, self._wave_tail_exit)

    def run(self, checkpoint_path=None, checkpoint_every=1):
        """Emit and track the whole plan; returns (spectrum, stats).

        With ``checkpoint_path`` a resume point is written after the pilot
        and every ``checkpoint_every`` waves, and deleted when the run
        completes; if the file exists, the run resumes from it, skipping
        the pilot and the waves it holds; a resumed run's clocks and phase
        counts cover the whole run."""
        self._t_run, self._resumed_s = time.monotonic(), 0.0
        plan = self.plan()
        state = self.engine.fresh_state()
        for eng in self._tail_engines.values():
            eng.phases = {"full": 0, "light": 0}
        self.device_s = 0.0 if self.device.type == "cuda" else None
        self.spec_acc = np.zeros_like(self.spec_acc)
        self._warm_counts, self.pilot, self.tail_stages = None, None, []
        waves = self._waves(plan.total)
        resume = None
        if checkpoint_path and os.path.exists(checkpoint_path):
            resume, state = self.load_checkpoint(checkpoint_path)
            if resume > len(waves):
                raise ValueError(f"checkpoint {checkpoint_path} holds {resume} waves; "
                                 f"this run has {len(waves)}")
            log.info("Resuming from %s: %d wave(s) done", checkpoint_path, resume)
        warm = min(self.warmup, plan.total)
        if resume is None and warm > 0:
            state = self._run_pilot(state, warm)
            if checkpoint_path:
                self.save_checkpoint(checkpoint_path, 0, state)
        for c, (start, count, te) in enumerate(waves):
            if resume is not None and c < resume:
                continue
            state = self._run_wave(state, c, len(waves), start, count, te)
            if checkpoint_path and (c + 1) % checkpoint_every == 0:
                self.save_checkpoint(checkpoint_path, c + 1, state)
        util_waves = self._util(state.counters)  # the waves alone, before the cascade
        state = self._drain_tail(state)
        if checkpoint_path and os.path.exists(checkpoint_path):
            os.remove(checkpoint_path)
        elapsed = self._elapsed()

        engines = [self.engine, *self._tail_engines.values()]
        stats = {
            "n_created": plan.total,
            "full_phases": sum(e.phases["full"] for e in engines),
            "light_phases": sum(e.phases["light"] for e in engines),
            "waves": len(waves),
            "pilot": self.pilot,
            "tail_stages": self.tail_stages,
            "elapsed_s": elapsed,
            "compile_s": self.compile_s,
            "photon_rate": plan.total / max(elapsed, 1e-9),
            "device_s": self.device_s,
            "photon_rate_device": (plan.total / self.device_s if self.device_s else None),
        }
        stats.update(self._counter_stats(state.counters, self._warm_counts or (0, 0)))
        if util_waves:
            stats["util_waves"] = util_waves
        self.state = state
        self.spec = unscale_spectrum(self.spec_acc, engine_mod.WEIGHT_SCALE)
        return self.spec, stats

    def _counter_stats(self, c, debit):
        """The stats read from the counters ``c``, the pilot's counts
        ``debit`` = (n_recorded, n_scatt_rec) taken off, and the step-cap
        truncation share against the host spectrum."""
        w_rec, w_scatt = debit
        n_retired = int(c.n_retired)
        stats = {
            "n_tracked": n_retired,
            "n_recorded": max(0, int(c.n_recorded) - w_rec),
            "n_scatt_recorded": max(0, int(c.n_scatt_rec) - w_scatt),
            "max_tau_scatt": float(c.max_tau_scatt),
            "n_secondary_dropped": int(c.n_sec_drop),
            "n_stall_killed": int(c.n_stall),
            "n_hc_clamp": int(c.n_hc_clamp),
            "n_ev_soft": int(c.n_ev_soft),
            "n_ev_forced": int(c.n_ev_forced),
            "hot_iters": int(c.ls_iters),
            "steps_per_photon": float(c.n_steps_retired) / max(n_retired, 1),
        }
        util = self._util(c)
        if util:
            stats.update(util_occupied=util[0], util_moving=util[1],
                         util_committed=util[2], util_parked=util[3])
        w_spec = float(self.spec_acc[:, 0].sum())
        w_stall = float(c.w_stall)
        stats["w_stall_frac"] = w_stall / max(w_spec + w_stall, 1e-300)
        return stats

    @staticmethod
    def _util(c):
        """The lane-slot shares [occupied, moving, committed, parked] of the
        counters' census, or None before any hot iteration."""
        slots = float(c.ls_slots)
        if slots <= 0:
            return None
        return [float(v) / slots for v in (c.ls_occupied, c.ls_moving, c.ls_committed,
                                           c.ls_parked)]

    def run_native_cpu(self, progress_every=5000):
        """Emit on the Simulation's device and track the whole plan with the
        native scalar tracker (seed ``seed + 1``) on the host, chunk by
        chunk, the bias feedback carried across chunks (the reference's CPU
        build, harm_model.cpp:362-404).  Returns (spectrum, stats) as
        :meth:`run` does, the spectrum (N_TH_BINS, N_E_BINS, 16)."""
        t0 = time.monotonic()
        plan = self.plan()
        tracker = oracle_native.NativeTracker(self.mc, self.model.data.stacked(),
                                              seed=self.seed + 1)
        done = 0
        while done < plan.total:
            n = int(min(self.emit_chunk, plan.total - done))
            rows = self.emit_rows(done, n)
            tracker.run(oracle_native.photons_from_rows(rows, engine_mod.WEIGHT_SCALE),
                        progress_every=progress_every)
            done += n
            log.info("cpu backend: %d/%d emitted, %d recorded | %.0f ph/s", done, plan.total,
                     tracker.n_recorded, done / max(time.monotonic() - t0, 1e-9))
        elapsed = time.monotonic() - t0
        stats = {
            "n_created": int(plan.total),
            "n_recorded": int(tracker.n_recorded),
            "n_scatt_recorded": int(tracker.n_scatt_rec),
            "max_tau_scatt": float(tracker.max_tau_scatt),
            "elapsed_s": elapsed,
            "compile_s": 0.0,
            "photon_rate": plan.total / max(elapsed, 1e-9),
        }
        self.spec = tracker.spec
        return tracker.spec, stats

    def report(self, spectrum_path: str, spec=None):
        """Write the spectrum in the reference's text format."""
        spec = self.spec if spec is None else spec
        rows = spectrum_ops.write_spectrum(spectrum_path, np.asarray(spec), self.mc)
        log.info("Spectrum written to %s; luminosity %g", spectrum_path,
                 rows["luminosity"])
        return rows
