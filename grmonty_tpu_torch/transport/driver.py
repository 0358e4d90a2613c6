"""The simulation driver: dump -> tables -> emission -> transport -> spectrum.

Port of the main path of ``grmonty_tpu/transport/driver.py``
(``Simulation``).  Everything runs on one explicit ``device``:

* the per-dump tables (zone geometry and fluid state, the emission weight
  and budget tables, the emission tetrads, the inverse-CDF frequency
  tables and the two bilinear corner tables) are built in torch on the
  device, float64;
* :meth:`Simulation.plan` rounds the per-zone budgets to counts and orders
  the photons by a strided permutation of the zone sweep (the shipped
  profile) or in plan order, the zone sweep itself (reference semantics,
  ``EngineConfig.reference``);
* :meth:`Simulation.run` emits the plan in waves of ``emit_chunk`` rows on
  the device (inverse-CDF sampling, or rejection sampling under reference
  semantics), runs each wave through the engine until its backlog is
  consumed (the pool stays full across the hand-off), drains the last
  photons in the same pool with the tail overrides, and accumulates the
  spectrum on the host in float64 after every wave.

One ``torch.Generator`` on the device, seeded from ``seed``, serves the
whole run.  The engine's time is clocked by CUDA events on a CUDA device
(``device_s``) next to the wall clock.
"""

from __future__ import annotations

import logging
import math
import time

import numpy as np
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.models import harm
from grmonty_tpu_torch.ops import emission, fluid
from grmonty_tpu_torch.ops import spectrum as spectrum_ops
from grmonty_tpu_torch.transport import engine as engine_mod
from grmonty_tpu_torch.utils import tables as tables_mod

log = logging.getLogger(__name__)

# Spectrum accumulator channels carrying photon weight (all but nph, nscatt
# and the two secondary-count channels) and the one quadratic in it.
_W_CHANNELS = [0, 1, 4, 5, 6, 7, 8, 9, 10, 11, 12]
_W2_CHANNELS = [13]


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


class Simulation:
    """One HARM snapshot and photon budget -> spectrum, on ``device`` (the
    CUDA card unless the caller asks for the CPU)."""

    def __init__(self, dump_path: str, photon_n: int = 5_000_000,
                 mass_unit: float = 4.0e19, seed: int = consts.RNG_SEED,
                 config: engine_mod.EngineConfig | None = None,
                 device: torch.device | str = "cuda", emit_chunk: int = 1 << 20,
                 wave_tail_exit: int | None = None,
                 tail_grow_cap: float | None = None,
                 tail_stall_steps: int | None = None):
        self.device = torch.device(device)
        self.photon_n = photon_n
        self.emit_chunk = emit_chunk
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
        self._zone_tabs, self._sampler_tabs = self._emission_tables()
        self._stride = 0
        self._total = 0
        self.spec_acc = np.zeros((engine_mod.N_BINS + 1, engine_mod.N_SPEC_CHAN))
        self.device_s = None  # CUDA-event window of the engine runs (CUDA only)

    def _emission_tables(self):
        h, dt = self.host, self.cfg.dtype
        fz = h["fluid_zone"]
        z = self.mc.n1 * self.mc.n2
        dead = (h["dn_max"] <= 0.0) | (fz.theta_e < consts.THETA_E_MIN)
        ln_dn_max = torch.where(h["dn_max"] > 0.0,
                                torch.log(torch.clamp(h["dn_max"], min=1e-300)), -math.inf)
        zt = emission.ZoneTables(
            x=h["zone_x"].reshape(z, 4).to(dt), theta_e=fz.theta_e.reshape(z).to(dt),
            n_e=fz.n_e.reshape(z).to(dt), b=fz.b.reshape(z).to(dt),
            dead=dead.reshape(z), ln_dn_max=ln_dn_max.reshape(z).to(dt), e_con=h["e_con_z"].reshape(z, 4, 4).to(dt),
            e_cov=h["e_cov_z"].reshape(z, 4, 4).to(dt), weights=h["weights"].to(dt))
        tabs = emission.SamplerTables(
            zone_map=h["nu_zone_map"], lnrho=h["nu_lnrho"], cdf=h["nu_cdf"],
            theta_q=torch.as_tensor(tables_mod.theta_quantiles(), device=self.device))
        return zt, tabs

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

    def emit_rows(self, start, count):
        """Packed (count, 16) backlog rows of plan photons
        [start, start + count) in emission order, sampled on the device
        with weights in engine units."""
        t = torch.arange(start, start + count, dtype=torch.int64, device=self.device)
        if self._stride:
            t = (t * self._stride) % self._total
        zflat = torch.clamp(torch.searchsorted(self._cum, t, right=True) - 1,
                            0, self._cum.shape[0] - 2)
        ln_w_offset = math.log(engine_mod.WEIGHT_SCALE)
        if self.cfg.reference:
            return emission.sample_photons(self.gen, zflat, self._zone_tabs,
                                           self.host["f_t"].to(self.cfg.dtype),
                                           self.cfg.dtype, ln_w_offset=ln_w_offset)
        return emission.sample_photons_cdf(
            self.gen, zflat, self._zone_tabs, self._sampler_tabs, self.cfg.dtype,
            ln_w_offset=ln_w_offset)

    def _drain_spec(self, state):
        self.spec_acc += state.spec.double().cpu().numpy()
        return state._replace(spec=torch.zeros_like(state.spec))

    def _timed_run(self, eng, state, backlog, tail_exit=None):
        """engine.run with its device window added to ``device_s``."""
        if self.device.type != "cuda":
            return eng.run(state, backlog, tail_exit=tail_exit)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state = eng.run(state, backlog, tail_exit=tail_exit)
        t1.record()
        t1.synchronize()
        self.device_s = (self.device_s or 0.0) + t0.elapsed_time(t1) / 1e3
        return state

    def tail_engine(self):
        """The final drain's engine: the same pool, no backlog, the full
        phase every 64 iterations and no light phases, with the tail
        overrides of the step growth and the step cap."""
        cfg = self.cfg._replace(
            tail_exit=0, m_period=64, refill_period=0,
            grow_cap=(self.tail_grow_cap if self.tail_grow_cap is not None
                      else self.cfg.grow_cap),
            stall_steps=(self.tail_stall_steps if self.tail_stall_steps is not None
                         else self.cfg.stall_steps))
        return engine_mod.Engine(self.mc, cfg, self.tables, self.device, self.gen)

    def run(self):
        """Emit and track the whole plan; returns (spectrum, stats)."""
        t0 = time.monotonic()
        plan = self.plan()
        state = self.engine.fresh_state()
        if self.device.type == "cuda":
            self.device_s = 0.0
        chunk = self.emit_chunk
        waves = [(c0, min(chunk, plan.total - c0)) for c0 in range(0, plan.total, chunk)]
        for c, (start, count) in enumerate(waves):
            backlog = self.emit_rows(start, count)
            state = state._replace(backlog_pos=torch.zeros_like(state.backlog_pos))
            # the last wave drains to n_pool/16 before the tail engine
            te = (min(max(1, self.cfg.n_pool // 16), self._wave_tail_exit)
                  if c + 1 == len(waves) else self._wave_tail_exit)
            state = self._timed_run(self.engine, state, backlog, tail_exit=te)
            state = self._drain_spec(state)
            log.info("wave %d/%d: it=%d rec=%d", c + 1, len(waves), state.it,
                     int(state.counters.n_recorded))
        empty = torch.zeros((1, engine_mod.ROW_WIDTH), dtype=self.cfg.dtype,
                            device=self.device)
        tail = self.tail_engine()
        state = self._timed_run(tail, state, empty)
        state = self._drain_spec(state)
        elapsed = time.monotonic() - t0

        c = state.counters
        n_retired = int(c.n_retired)
        stats = {
            "n_created": plan.total,
            "n_tracked": n_retired,
            "n_recorded": int(c.n_recorded),
            "n_scatt_recorded": int(c.n_scatt_rec),
            "max_tau_scatt": float(c.max_tau_scatt),
            "n_secondary_dropped": int(c.n_sec_drop),
            "n_stall_killed": int(c.n_stall),
            "n_hc_clamp": int(c.n_hc_clamp),
            "n_ev_soft": int(c.n_ev_soft),
            "n_ev_forced": int(c.n_ev_forced),
            "hot_iters": int(c.ls_iters),
            "full_phases": self.engine.phases["full"] + tail.phases["full"],
            "light_phases": self.engine.phases["light"] + tail.phases["light"],
            "steps_per_photon": float(c.n_steps_retired) / max(n_retired, 1),
            "elapsed_s": elapsed,
            "photon_rate": plan.total / max(elapsed, 1e-9),
            "device_s": self.device_s,
            "photon_rate_device": (plan.total / self.device_s if self.device_s else None),
        }
        slots = float(c.ls_slots)
        if slots > 0:
            stats.update(util_occupied=float(c.ls_occupied) / slots,
                         util_moving=float(c.ls_moving) / slots,
                         util_committed=float(c.ls_committed) / slots,
                         util_parked=float(c.ls_parked) / slots)
        w_rec = float(self.spec_acc[:, 0].sum())
        w_stall = float(c.w_stall)
        stats["w_stall_frac"] = w_stall / max(w_rec + w_stall, 1e-300)
        self.state = state
        self.spec = unscale_spectrum(self.spec_acc, engine_mod.WEIGHT_SCALE)
        return self.spec, stats

    def report(self, spectrum_path: str, spec=None):
        """Write the spectrum in the reference's text format."""
        spec = self.spec if spec is None else spec
        rows = spectrum_ops.write_spectrum(spectrum_path, np.asarray(spec), self.mc)
        log.info("Spectrum written to %s; luminosity %g", spectrum_path,
                 rows["luminosity"])
        return rows
