"""The port's accuracy gate: its engine against a scalar tracker.

    python -m grmonty_tpu_torch.tools.validate_accuracy --bench-profile \\
        --photons 20000 --mass-unit 4e19 --freeze-bias 0.0025 --oracle-reps 5
    python -m grmonty_tpu_torch.tools.validate_accuracy --reference \\
        --photons 10000 --freeze-bias 0.0025 --oracle-reps 5
    python -m grmonty_tpu_torch.tools.validate_accuracy --device cpu --photons 200

Port of ``tools/validate_accuracy.py``.  On the n1 x n2 synthetic torus
(written into ``.cache/`` once) both trackers take one emitted sample, the
first ``--photons`` photons of the plan in emission order
(``Simulation.emit_rows``):

* the engine (on the card unless ``--device cpu``): the bias counters
  warmed by the pilot (the native tracker on the first 512 photons, seed +
  7, ``Simulation._host_warm_counters``), then the sample run at full
  width until at most 256 lanes remain, then the tail cascade
  (``Simulation._drain_tail``); the pilot's records are debited;
* the oracle: the native tracker (``transport/oracle_native.py``) on the
  same photons in float64 with unscaled weights, ``--oracle-reps`` times
  (seeds seed + 1 ... seed + R, run side by side in threads: the tracker
  holds no shared state); or with ``--oracle python`` the Python scalar
  tracker (``transport/cpu_reference.py``, the same physics through the
  port's torch ops, about 1e3 times slower: seconds per photon on the CPU),
  its replicates one after another.

:func:`compare` (pure numpy) turns the two spectra, the oracle's
replicates and the counters into the JAX tool's statistics under the JAX
tool's keys: the luminosity and recorded-fraction ratios, the grouped chi^2
of the energy spectrum and of its counts, the primary/secondary split with
its global kappa, the per-generation kappa^g model against the replicates'
median with MAD variance (``chi2_sec_gen_per_dof``), and the engine's
census.

Profile: with ``--bench-profile`` the shipped one as the JAX tool runs it,
``profiles.bench_config(pool=1024)`` in float32 with a 16,384-row ring and
the tail cascade of ``profiles.bench_sim_kwargs``; without it the same
profile in float64.  With ``--reference``, reference semantics in float64
(``profiles.reference_config(pool=1024)`` with the same ring and the tail
of ``profiles.reference_sim_kwargs``, which overrides nothing): the
counterpart of the JAX tool's default run, reference semantics in float64.
Every profile runs on the card (float64 through the kernels' float64
instantiations) or, with ``--device cpu``, on the CPU.

Hard gates, each exiting non-zero: ``chi2_sec_gen_per_dof < 5`` under
``--freeze-bias`` (both trackers' bias normalization pinned to
freeze_bias * (freeze_avg + 2); a live-bias count comparison measures how
two feedback trajectories diverge, and is only printed), and
``n_hc_clamp_engine == 0``.

``--oracle-npz`` caches the oracle's spectra with the regime they were
run in (``ORACLE_FIELDS``: the sample's photons, photon_n, seed, mass
unit, torus, semantics, dtype and device, and the oracle's frozen bias,
replicates and tracker).  A file is reused only on an exact match of every
field; any other file, one written before the fields were recorded among
them, stops the tool with the field named.

Left behind from the JAX tool: its TPU-era engine knobs (``--grow-cap``,
``--grow-rate``, ``--detached``, ``--derived-fluid``, ``--refill-period``,
``--bias-ema``, the ``GRMONTY_*`` overrides: the port's profile fixes
them).
"""

import argparse
import concurrent.futures
import json
import math
import os
import sys
import time

import numpy as np

from grmonty_tpu_torch import consts

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POOL = 1024
SEC_CAP = 16384
PILOT = 512  # photons of the bias warm-up
WAVE_EXIT = 256  # lanes left when the full-width run hands over to the cascade
GEN_GATE = 5.0  # chi2_sec_gen_per_dof under --freeze-bias


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--photons", type=int, default=2000,
                    help="photons both trackers take from the plan")
    ap.add_argument("--mass-unit", type=float, default=4e19)
    ap.add_argument("--photon-n", type=int, default=2000,
                    help="photon_n of the emission weight tables")
    ap.add_argument("--n1", type=int, default=64)
    ap.add_argument("--n2", type=int, default=32)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--engine-seed", type=int, default=None,
                    help="seed of the engine's tracking draws alone (default seed + 2): "
                         "the emission and the oracle stay, so an --oracle-npz stays valid")
    ap.add_argument("--json", default=None, help="write the result here")
    ap.add_argument("--group", type=int, default=10, help="energy bins per chi^2 group")
    ap.add_argument("--oracle-npz", default=None,
                    help="load the oracle's spectra from here if the file exists (it must "
                         "record this run's regime, ORACLE_FIELDS, exactly), else run the "
                         "oracle and save them here with the regime")
    ap.add_argument("--freeze-bias", type=float, default=0.0,
                    help="pin both trackers' bias normalization to this max_tau (with "
                         "--freeze-avg); enables the hard count gate")
    ap.add_argument("--freeze-avg", type=float, default=2.6)
    ap.add_argument("--oracle", choices=("native", "python"), default="native",
                    help="the oracle: the native C++ tracker (seconds) or the Python "
                         "scalar tracker (transport/cpu_reference.py, ~1e3x slower)")
    ap.add_argument("--oracle-reps", type=int, default=1,
                    help="oracle replicates (seeds seed+1..); at 3 or more the kappa^g "
                         "gate runs against their median with MAD variance")
    ap.add_argument("--save-spec", default=None,
                    help="also save both spectra (6, 200, 16) to this .npz")
    profile = ap.add_mutually_exclusive_group()
    profile.add_argument("--bench-profile", action="store_true",
                         help="the shipped profile in float32 (else float64)")
    profile.add_argument("--reference", action="store_true",
                         help="reference semantics in float64 (the JAX tool's default run)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def _grouped(a, ne_g, g):
    """Sums of ``g`` consecutive energy bins of an (NE,) array, ne_g groups."""
    return a[: ne_g * g].reshape(ne_g, g).sum(1)


def compare(spec_engine, spec_oracle, oracle_specs, engine, oracle, group=10):
    """The engine against the oracle, as the JAX tool's statistics.

    ``spec_engine``, ``spec_oracle``: unscaled spectra, (N_TH_BINS,
    N_E_BINS, 16) or the engine's (N_TH_BINS * N_E_BINS [+ 1], 16);
    ``spec_oracle`` is the replicates' mean.  ``oracle_specs``: the
    replicates (R, N_TH_BINS, N_E_BINS, 16), or None.  ``engine``: a dict
    of ``n_photons``, ``n_recorded`` (the pilot's debited),
    ``max_tau_scatt``, ``n_stall``, ``w_stall_frac``, ``n_hc_clamp``,
    ``n_ev_soft``, ``n_ev_forced``; ``oracle``: ``n_photons``,
    ``n_recorded`` (the replicates' rounded mean), ``max_tau_scatt`` (or
    None).  Returns a dict under the JAX tool's keys, each computed in the
    JAX tool's order of operations."""
    nb, ne = consts.N_TH_BINS, consts.N_E_BINS
    se = np.asarray(spec_engine, np.float64)
    se = se.reshape(-1, se.shape[-1])[: nb * ne].reshape(nb, ne, -1)
    so = np.asarray(spec_oracle, np.float64)
    so = so.reshape(-1, so.shape[-1])[: nb * ne].reshape(nb, ne, -1)
    so_reps = None if oracle_specs is None else np.asarray(oracle_specs, np.float64)
    n_eng, n_orc = engine["n_photons"], oracle["n_photons"]
    n_rec_e, n_rec_o = engine["n_recorded"], oracle["n_recorded"]
    max_tau_e, max_tau_o = engine["max_tau_scatt"], oracle["max_tau_scatt"]

    lum_e = se[:, :, 1].sum() / n_eng
    lum_o = so[:, :, 1].sum() / n_orc
    # the luminosity's Monte Carlo error from channel 13, sum((w e)^2)
    lum_sig_e = float(np.sqrt(se[:, :, 13].sum()) / max(se[:, :, 1].sum(), 1e-300))
    lum_sig_o = float(np.sqrt(so[:, :, 13].sum()) / max(so[:, :, 1].sum(), 1e-300))
    rec_e = n_rec_e / n_eng
    rec_o = n_rec_o / n_orc

    # chi^2 over groups of the theta-summed energy spectrum, with each
    # group's variance from its sum((w e)^2)
    g = group
    ne_g = ne // g
    e_e = _grouped(se[:, :, 1].sum(0), ne_g, g) / n_eng
    e_o = _grouped(so[:, :, 1].sum(0), ne_g, g) / n_orc
    n_e = _grouped(se[:, :, 2].sum(0), ne_g, g)
    n_o = _grouped(so[:, :, 2].sum(0), ne_g, g)
    use = (n_o >= 10) & (n_e >= 10)
    v_e = _grouped(se[:, :, 13].sum(0), ne_g, g) / n_eng**2
    v_o = _grouped(so[:, :, 13].sum(0), ne_g, g) / n_orc**2
    var = v_e + v_o
    chi2 = float((((e_e - e_o) ** 2)[use] / var[use]).sum())
    dof = int(use.sum())

    # the counts' shape: per-group fractions with Poisson variances
    f_e = n_e / max(n_e.sum(), 1)
    f_o = n_o / max(n_o.sum(), 1)
    var_f = n_e / max(n_e.sum(), 1) ** 2 + n_o / max(n_o.sum(), 1) ** 2
    chi2_counts = float((((f_e - f_o) ** 2)[use] / var_f[use]).sum())

    avg_scatt_e = float(se[:, :, 3].sum() / max(n_rec_e, 1))
    avg_scatt_o = float(so[:, :, 3].sum() / max(n_rec_o, 1))

    # primaries (channel 2 less the secondaries of channel 14) agree within
    # Poisson noise whatever the bias; secondaries scale with it, by one
    # global kappa, and generation g by kappa^g (channel 15: the summed
    # birth generation)
    decomp = None
    if se.shape[2] > 14 and so.shape[2] > 14:
        s_e = _grouped(se[:, :, 14].sum(0), ne_g, g)
        s_o = _grouped(so[:, :, 14].sum(0), ne_g, g)
        p_e, p_o = n_e - s_e, n_o - s_o
        use_p = (p_e + p_o) >= 10
        chi2_p = float((((p_e - p_o) ** 2)[use_p] / np.maximum(p_e + p_o, 1)[use_p]).sum())
        dof_p = int(use_p.sum())
        kappa = float(s_e.sum() / max(s_o.sum(), 1))
        use_s = (s_e + s_o) >= 10
        var_s = np.maximum(s_e + kappa * kappa * s_o, 1.0)
        chi2_s = float((((s_e - kappa * s_o) ** 2)[use_s] / var_s[use_s]).sum())
        dof_s = max(int(use_s.sum()) - 1, 1)  # kappa fitted from the data
        # the bias equilibrium's prediction: bias ~ 1 / (max_tau (avg + 2))
        kappa_pred = None
        if max_tau_o is not None and max_tau_o > 0:
            kappa_pred = (max_tau_o * (avg_scatt_o + 2.0)) / (
                float(max_tau_e) * (avg_scatt_e + 2.0))
        decomp = {
            "n_prim_engine": int(p_e.sum()), "n_prim_oracle": int(p_o.sum()),
            "n_sec_engine": int(s_e.sum()), "n_sec_oracle": int(s_o.sum()),
            "chi2_prim_per_dof": chi2_p / max(dof_p, 1), "dof_prim": dof_p,
            "kappa_fit": kappa, "kappa_pred_from_bias": kappa_pred,
            "chi2_sec_shape_per_dof": chi2_s / max(dof_s, 1),
            "dof_sec": dof_s,
        }
        if se.shape[2] > 15 and so.shape[2] > 15:
            g_e = _grouped(se[:, :, 15].sum(0), ne_g, g)
            g_o = _grouped(so[:, :, 15].sum(0), ne_g, g)
            gbar = g_o / np.maximum(s_o, 1.0)
            use_g = use_s & (s_e > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                log_r = np.log(np.maximum(s_e, 1e-300) / np.maximum(s_o, 1e-300))
            w_b = 1.0 / (1.0 / np.maximum(s_e, 1.0) + 1.0 / np.maximum(s_o, 1.0))
            # with 3 or more replicates: the per-band median and MAD sigma
            # (cascades cluster, and at frozen bias a rare replicate
            # explodes; the median is not dragged by it)
            s_o_t = s_o
            var_meas_note = "poisson"
            var_band = None
            if so_reps is not None and so_reps.shape[0] >= 3:
                r = so_reps.shape[0]
                sreps = so_reps[:, :, :, 14].sum(1)  # (R, NE)
                sb = sreps[:, : ne_g * g].reshape(r, ne_g, g).sum(2)
                s_o_t = np.median(sb, axis=0)
                mad = np.median(np.abs(sb - s_o_t), axis=0)
                var_band = np.square(1.4826 * mad)
                var_meas_note = f"replicate median/MAD (R={r})"
                greps = so_reps[:, :, :, 15].sum(1)
                gb_r = greps[:, : ne_g * g].reshape(r, ne_g, g).sum(2)
                with np.errstate(divide="ignore", invalid="ignore"):
                    gbar = np.median(gb_r / np.maximum(sb, 1.0), axis=0)
                with np.errstate(divide="ignore", invalid="ignore"):
                    log_r = np.log(np.maximum(s_e, 1e-300) / np.maximum(s_o_t, 1e-300))
                w_b = 1.0 / (1.0 / np.maximum(s_e, 1.0) + 1.0 / np.maximum(s_o_t, 1.0))
                use_g = use_s & (s_e > 0) & (s_o_t > 0)
            num = float((w_b * gbar * log_r)[use_g].sum())
            den = float((w_b * gbar * gbar)[use_g].sum())
            kappa_g = math.exp(num / max(den, 1e-300))
            pred = s_o_t * np.power(kappa_g, gbar)
            var_g = np.maximum(s_e + np.power(kappa_g, gbar) ** 2 * s_o_t, 1.0)
            if var_band is not None:
                var_g = np.maximum(var_band * (1.0 + kappa_g**2 / so_reps.shape[0]), var_g)
            chi2_gen = float((((s_e - pred) ** 2)[use_g] / var_g[use_g]).sum())
            dof_gen = max(int(use_g.sum()) - 1, 1)
            gbar_e = g_e / np.maximum(s_e, 1.0)
            decomp.update({
                "kappa_gen_fit": kappa_g,
                "gbar_oracle": [float(x) for x in gbar[use_g]],
                "gbar_engine": [float(x) for x in gbar_e[use_g]],
                "sec_counts_engine": [int(x) for x in s_e[use_g]],
                "sec_counts_oracle": [int(x) for x in s_o_t[use_g]],
                "chi2_sec_gen_per_dof": chi2_gen / dof_gen,
                "dof_sec_gen": dof_gen,
                "sec_gen_variance_model": var_meas_note,
            })

    groups = [
        {"g": int(i), "lum_ratio": float(e_e[i] / e_o[i]) if e_o[i] else None,
         "nph_engine": int(n_e[i]), "nph_oracle": int(n_o[i])}
        for i in range(ne_g) if (n_e[i] or n_o[i])
    ]
    return {
        "n_engine": int(n_eng),
        "n_oracle": int(n_orc),
        "lum_per_photon_engine": float(lum_e),
        "lum_per_photon_oracle": float(lum_o),
        "lum_ratio": float(lum_e / lum_o),
        "lum_ratio_rel_sigma": math.sqrt(lum_sig_e**2 + lum_sig_o**2),
        "recorded_frac_engine": float(rec_e),
        "recorded_frac_oracle": float(rec_o),
        "rec_ratio": float(rec_e / rec_o),
        "chi2": chi2,
        "dof": dof,
        "chi2_per_dof": chi2 / max(dof, 1),
        "chi2_counts_per_dof": chi2_counts / max(dof, 1),
        "avg_scatt_engine": avg_scatt_e,
        "avg_scatt_oracle": avg_scatt_o,
        "max_tau_scatt_engine": float(max_tau_e),
        "max_tau_scatt_oracle": max_tau_o,
        "origin_decomp": decomp,
        "n_stall_engine": int(engine["n_stall"]),
        "w_stall_frac_engine": float(engine["w_stall_frac"]),
        "n_hc_clamp_engine": int(engine["n_hc_clamp"]),
        "n_ev_soft_engine": int(engine["n_ev_soft"]),
        "n_ev_forced_engine": int(engine["n_ev_forced"]),
        "groups": groups,
    }


def gate_failures(out):
    """The hard gates that ``out`` (the tool's result) fails, as messages:
    the kappa^g count model under a frozen bias, and the hotcross clamp."""
    fails = []
    decomp = out["origin_decomp"] or {}
    gen = decomp.get("chi2_sec_gen_per_dof")
    if out["freeze_bias"] is not None and gen is not None and not gen < GEN_GATE:
        fails.append(f"secondary count shape fails the per-generation kappa^g model at "
                     f"frozen bias: chi2/dof {gen:.3g} >= {GEN_GATE} "
                     f"(kappa_gen {decomp['kappa_gen_fit']:.3f})")
    if out["n_hc_clamp_engine"] != 0:
        fails.append(f"hotcross clamp path reached {out['n_hc_clamp_engine']} times")
    return fails


def _config(args):
    """(EngineConfig, the driver's tail keyword arguments) of the run."""
    import torch

    from grmonty_tpu_torch.transport import profiles

    dtype = torch.float32 if args.bench_profile else torch.float64
    if args.reference:
        cfg = profiles.reference_config(pool=POOL, dtype=dtype)
        kw = profiles.reference_sim_kwargs(POOL)
    else:
        cfg = profiles.bench_config(pool=POOL, dtype=dtype)
        kw = profiles.bench_sim_kwargs(POOL)
    cfg = cfg._replace(sec_cap=SEC_CAP)
    tail = dict(tail_grow_cap=kw.get("tail_grow_cap"),
                tail_stall_steps=kw.get("tail_stall_steps"))
    if args.freeze_bias > 0.0:
        cfg = cfg._replace(bias_fixed_tau=args.freeze_bias, bias_fixed_avg=args.freeze_avg)
    return cfg, tail


def _torus(n1, n2):
    from grmonty_tpu_torch.models import torus

    cache = os.path.join(ROOT, ".cache")
    os.makedirs(cache, exist_ok=True)
    dump = os.path.join(cache, f"torus_{n1}x{n2}_dump")
    if not os.path.exists(dump):
        tmp = f"{dump}.{os.getpid()}.tmp"
        torus.write_torus_dump(tmp, n1=n1, n2=n2)
        os.replace(tmp, dump)
    return dump


def _device_record(device):
    """Where the engine ran: the platform, the card's name and, from
    nvidia-smi, its name and power limit (None where it cannot be read)."""
    import subprocess

    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "card": None}
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader", "-i", str(index)],
                              capture_output=True, text=True, timeout=60).stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        card = None
    return {"platform": device.type, "kind": torch.cuda.get_device_name(device), "card": card}


def run_engine(sim, rows, engine_seed):
    """The engine on the sample ``rows``: the pilot's warm counters, the
    run at full width to WAVE_EXIT lanes, the tail cascade.  Returns
    (unscaled spectrum, engine counters for :func:`compare`, seconds)."""
    import torch

    from grmonty_tpu_torch.transport import driver, engine

    t0 = time.time()
    state = sim.engine.fresh_state()
    sim.gen.manual_seed(engine_seed)
    warm = min(PILOT, rows.shape[0])
    pilot_rows = rows[:warm].to(torch.float64, copy=True)
    pilot_rows[:, engine.ROW_W] /= engine.WEIGHT_SCALE
    state = state._replace(counters=sim._host_warm_counters(pilot_rows, state.counters))
    warm_rec = int(state.counters.n_recorded)
    state, _ = sim._timed_run(sim.engine, state, rows,
                              tail_exit=min(WAVE_EXIT, sim.cfg.n_pool))
    state = sim._drain_tail(state)
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    c = state.counters
    w_stall = float(c.w_stall)
    counts = dict(
        n_photons=int(rows.shape[0]), n_recorded=int(c.n_recorded) - warm_rec,
        max_tau_scatt=float(c.max_tau_scatt), n_stall=int(c.n_stall),
        w_stall_frac=w_stall / max(float(sim.spec_acc[:, 0].sum()) + w_stall, 1e-300),
        n_hc_clamp=int(c.n_hc_clamp), n_ev_soft=int(c.n_ev_soft),
        n_ev_forced=int(c.n_ev_forced), hot_iters=int(c.ls_iters))
    spec = driver.unscale_spectrum(sim.spec_acc, engine.WEIGHT_SCALE)
    sim.state = state
    return spec, counts, time.time() - t0


# What the oracle's side of the gate depends on, recorded in an --oracle-npz
# file and matched exactly before the file is reused: the sample (its
# photons, the emission's photon_n, seed and mass unit, the torus, the
# semantics and dtype it is sampled in, and the device whose generator draws
# it) and the oracle's own runs (the frozen bias pair, 0 and 0 when live, the
# replicates and the tracker).
ORACLE_FIELDS = ("n_photons", "photon_n", "seed", "mass_unit", "freeze_bias", "freeze_avg",
                 "oracle_reps", "oracle", "n1", "n2", "reference", "dtype", "device")


def oracle_regime(args, n_photons):
    """{field: value} of ``ORACLE_FIELDS`` for a run of ``args`` on
    ``n_photons`` photons."""
    import torch

    frozen = args.freeze_bias > 0.0
    return dict(n_photons=int(n_photons), photon_n=int(args.photon_n), seed=int(args.seed),
                mass_unit=float(args.mass_unit),
                freeze_bias=float(args.freeze_bias) if frozen else 0.0,
                freeze_avg=float(args.freeze_avg) if frozen else 0.0,
                oracle_reps=max(1, int(args.oracle_reps)), oracle=args.oracle,
                n1=int(args.n1), n2=int(args.n2), reference=bool(args.reference),
                dtype="float32" if args.bench_profile else "float64",
                device=torch.device(args.device).type)


def save_oracle(path, regime, spec, specs, counts, seconds):
    """Write the oracle's mean spectrum, replicates, counters and seconds
    to ``path`` with its ``regime`` (:func:`oracle_regime`)."""
    np.savez(path, spec=spec, specs=specs, n_recorded=counts["n_recorded"],
             max_tau_scatt=counts["max_tau_scatt"], seconds=seconds, **regime)


def load_oracle(path, regime):
    """(mean spectrum, replicates, counters, seconds) from
    :func:`save_oracle`'s file at ``path``; raises ``SystemExit`` naming
    the first field of ``regime`` that the file does not record or records
    with another value."""
    with np.load(path, allow_pickle=False) as dat:
        for field, want in regime.items():
            if field not in dat.files:
                raise SystemExit(f"validate_accuracy: {path} records no {field} (written "
                                 "before the oracle's regime was recorded); remove it to "
                                 "run the oracle again")
            got = dat[field].item()
            if got != want:
                raise SystemExit(f"validate_accuracy: {path} was run with {field} = {got!r}, "
                                 f"this run has {field} = {want!r}")
        counts = dict(n_photons=regime["n_photons"], n_recorded=int(dat["n_recorded"]),
                      max_tau_scatt=float(dat["max_tau_scatt"]))
        return dat["spec"], dat["specs"], counts, float(dat["seconds"])


def run_oracle(sim, rows, seed, reps, bias_fixed, oracle="native"):
    """The oracle on the sample (float64, unscaled weights), once per
    replicate (seeds seed + 1 ... seed + reps): the native tracker's
    replicates in threads, the Python tracker's (``oracle="python"``) one
    after another.  Returns (mean spectrum, the replicates, counters,
    seconds)."""
    from grmonty_tpu_torch.transport import cpu_reference, engine, oracle_native

    t0 = time.time()
    photons = oracle_native.photons_from_rows(rows, engine.WEIGHT_SCALE)
    prims = sim.model.data.stacked()

    def one(r):
        if oracle == "python":
            tr = cpu_reference.CPUTracker(sim.mc, prims, seed=seed + 1 + r,
                                          bias_fixed=bias_fixed)
            tr.run(photons)
        else:
            tr = oracle_native.NativeTracker(sim.mc, prims, seed=seed + 1 + r,
                                             bias_fixed=bias_fixed)
            tr.run(photons, progress_every=0)
        return tr.spec.copy(), int(tr.n_recorded), float(tr.max_tau_scatt)

    reps = max(1, reps)
    if oracle == "python":  # it holds the GIL: threads would only take turns
        done = [one(r) for r in range(reps)]
    else:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=min(reps, os.cpu_count() or 1)) as ex:
            done = list(ex.map(one, range(reps)))
    specs = np.stack([d[0] for d in done])
    counts = dict(n_photons=int(rows.shape[0]),
                  n_recorded=int(round(float(np.mean([d[1] for d in done])))),
                  max_tau_scatt=float(np.max([d[2] for d in done])))
    return specs.mean(0), specs, counts, time.time() - t0


def gate_sample(args):
    """(``Simulation``, the emitted sample's rows) of a run of ``args``: the
    first ``--photons`` photons of the plan on the n1 x n2 torus."""
    import torch

    from grmonty_tpu_torch.transport import driver

    cfg, tail = _config(args)
    sim = driver.Simulation(_torus(args.n1, args.n2), photon_n=args.photon_n,
                            mass_unit=args.mass_unit, seed=args.seed, config=cfg,
                            device=torch.device(args.device), emit_chunk=4096, warmup=PILOT,
                            **tail)
    plan = sim.plan()
    return sim, sim.emit_rows(0, min(args.photons, plan.total))


def run(args):
    """The gate: the engine and the oracle on one sample, :func:`compare`,
    the result printed (and written to ``--json``, the spectra to
    ``--save-spec``).  Returns the result; the hard gates are the
    caller's (:func:`gate_failures`)."""
    import torch

    from grmonty_tpu_torch.transport import driver, engine

    device = torch.device(args.device)
    cfg, tail = _config(args)
    sim, rows = gate_sample(args)
    n = rows.shape[0]
    bias_fixed = (args.freeze_bias, args.freeze_avg) if args.freeze_bias > 0.0 else None
    regime = oracle_regime(args, n)
    # a cached oracle of another regime stops the tool before the engine runs
    cached = (load_oracle(args.oracle_npz, regime)
              if args.oracle_npz and os.path.exists(args.oracle_npz) else None)

    spec_e, eng, t_eng = run_engine(
        sim, rows, args.seed + 2 if args.engine_seed is None else args.engine_seed)

    if cached is not None:
        so, so_reps, orc, t_orc = cached
    else:
        so, so_reps, orc, t_orc = run_oracle(sim, rows, args.seed, args.oracle_reps,
                                             bias_fixed, args.oracle)
        if args.oracle_npz:
            save_oracle(args.oracle_npz, regime, so, so_reps, orc, t_orc)

    out = compare(spec_e, so, so_reps, eng, orc, group=args.group)
    out.update(engine_s=t_eng, oracle_s=t_orc, mass_unit=args.mass_unit, oracle=args.oracle,
               oracle_reps=args.oracle_reps,
               freeze_bias=[args.freeze_bias, args.freeze_avg] if bias_fixed else None)
    out["engine_config"] = {
        "dtype": str(cfg.dtype).removeprefix("torch."), "pool": cfg.n_pool,
        "sec_cap": cfg.sec_cap, "m_period": cfg.m_period,
        "refill_period": cfg.refill_period, "ev_k": sim.engine.ev_k,
        "light_k": sim.engine.light_k, "grow_cap": cfg.grow_cap,
        "step_ctrl": engine.STEP_CTRL,
        "stall_steps": cfg.stall_steps, "tail_grow_cap": tail["tail_grow_cap"],
        "tail_stall_steps": tail["tail_stall_steps"], "bench_profile": bool(args.bench_profile),
        "reference": bool(cfg.reference),
    }
    out["device"] = _device_record(device)
    engines = [sim.engine, *sim._tail_engines.values()]
    out["engine_run"] = {"hot_iters": eng["hot_iters"], "device_s": sim.device_s,
                         "compile_s": sim.compile_s,
                         "full_phases": sum(e.phases["full"] for e in engines),
                         "light_phases": sum(e.phases["light"] for e in engines),
                         "engine_phases": driver.engine_phases(engines),
                         **driver.engine_loops(engines),
                         "tail_stages": [[st["pool"], st["iters"]] for st in sim.tail_stages],
                         "pilot": sim.pilot}
    print(json.dumps(out, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    if args.save_spec:
        nb, ne = consts.N_TH_BINS, consts.N_E_BINS
        np.savez(args.save_spec, spec_engine=spec_e[: nb * ne].reshape(nb, ne, -1),
                 spec_oracle=np.asarray(so).reshape(nb, ne, -1), n_engine=n, n_oracle=n)
    return out


def main(argv=None):
    args = parse_args(argv)
    import torch

    from grmonty_tpu_torch.utils.logging import setup

    setup("info")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("validate_accuracy: no CUDA device (use --device cpu)", file=sys.stderr)
        sys.exit(2)
    out = run(args)
    decomp = out["origin_decomp"] or {}
    if out["freeze_bias"] is None and decomp.get("chi2_sec_gen_per_dof", 0.0) >= GEN_GATE:
        print(f"note: live-bias secondary count shape chi2/dof "
              f"{decomp['chi2_sec_gen_per_dof']:.1f} (diagnostic only - the hard gate "
              "runs with --freeze-bias)", file=sys.stderr)
    fails = gate_failures(out)
    if fails:
        print("validate_accuracy: FAILED: " + "; ".join(fails), file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
