"""The port's accuracy gate (``grmonty_tpu_torch.tools.validate_accuracy``)
against the JAX package's, on the 64x32 synthetic torus (CPU).

(a) The JAX tool ``tools/validate_accuracy.py`` runs in a subprocess at a
    small size (300 photons, 3 oracle replicates, frozen bias); its saved
    spectra, its oracle replicates and its counters go through the port's
    :func:`compare`, which must give every statistic of its JSON to rel
    1e-12.
(b) The frozen-bias mode: ``Engine._bias_scale`` under a frozen config is
    the JAX ``_bias_denom`` formula rounded once into the engine dtype, and
    the live path is the live formula (the frozen hot-chain parity is
    ``tests/test_torch_slice.py``).
(c) The native tracker's frozen mode: the port's and the JAX
    ``NativeTracker(bias_fixed=...)`` give the same spectrum and counters
    on the same photons and seed, and the frozen spectrum is not the live
    one.
(d) The tracker's hooks ``probe``, ``sample_electron`` and
    ``sample_scattered``, port against JAX, bit for bit.
(e) The port's gate end to end on the CPU at a tiny size: exit 0, the JAX
    tool's keys, no hotcross clamp; and with ``--reference`` (reference
    semantics in float64) its hard gates; the profiles ``_config`` gives,
    float64 on the card among them.
(f) :func:`compare` on seeded synthetic spectra: a distorted secondary
    shape trips the kappa^g gate, the undistorted one passes, and a clamp
    fails its gate.
(g) The ``--oracle-npz`` cache: a file written in one regime stops the
    tool (``SystemExit`` naming the field) under another, before the engine
    runs, for every field of ``ORACLE_FIELDS``; a file without the fields
    is refused too; only an exact match is reused.
"""

import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.tools import validate_accuracy as va
from grmonty_tpu_torch.transport import driver, engine, oracle_native, profiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FREEZE = (0.0025, 2.6)
# The tool's results that are not statistics of the two spectra: its
# clocks and its run's description.
NOT_STATISTICS = {"engine_s", "oracle_s", "mass_unit", "oracle", "oracle_reps", "freeze_bias",
                  "engine_config"}


def _env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX tool at 300 photons, 3 oracle replicates, frozen bias, the
    step cap cut to 5,000: (its JSON, its saved spectra, its oracle npz)."""
    va._torus(64, 32)  # written once, atomically, before the JAX tool reads it
    d = tmp_path_factory.mktemp("jax_gate")
    paths = {k: str(d / f"{k}{ext}") for k, ext in (("json", ".json"), ("spec", ".npz"),
                                                    ("oracle", ".npz"))}
    cmd = [sys.executable, os.path.join(ROOT, "tools", "validate_accuracy.py"),
           "--photons", "300", "--oracle-reps", "3", "--freeze-bias", str(FREEZE[0]),
           "--freeze-avg", str(FREEZE[1]), "--stall-steps", "5000",
           "--oracle-npz", paths["oracle"], "--save-spec", paths["spec"],
           "--json", paths["json"]]
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(paths["json"]) as f:
        res = json.load(f)
    return res, dict(np.load(paths["spec"])), dict(np.load(paths["oracle"]))


def _assert_same(got, want, where):
    """``got`` equals ``want`` (the JAX tool's JSON values): floats to rel
    1e-12, everything else exactly, recursively."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=0.0) or got == want, (
            where, got, want)
    else:
        assert got == want, (where, got, want)


def test_compare_gives_the_jax_tools_statistics(jax_run):
    res, spec, orc = jax_run
    n = int(spec["n_engine"])
    engine_counts = dict(
        n_photons=n, n_recorded=int(round(res["recorded_frac_engine"] * n)),
        max_tau_scatt=res["max_tau_scatt_engine"], n_stall=res["n_stall_engine"],
        w_stall_frac=res["w_stall_frac_engine"], n_hc_clamp=res["n_hc_clamp_engine"],
        n_ev_soft=res["n_ev_soft_engine"], n_ev_forced=res["n_ev_forced_engine"])
    oracle_counts = dict(n_photons=int(spec["n_oracle"]), n_recorded=int(orc["n_recorded"]),
                         max_tau_scatt=float(orc["max_tau_scatt"]))
    got = va.compare(spec["spec_engine"], spec["spec_oracle"], orc["specs"], engine_counts,
                     oracle_counts, group=10)
    want = {k: v for k, v in res.items() if k not in NOT_STATISTICS}
    assert res["dof"] > 0 and res["origin_decomp"]["dof_sec_gen"] > 0
    assert res["origin_decomp"]["sec_gen_variance_model"] == "replicate median/MAD (R=3)"
    _assert_same(json.loads(json.dumps(got)), want, "result")


@pytest.fixture(scope="module")
def small_sim(tmp_path_factory):
    """A port Simulation on the 64x32 torus (CPU, float64), plan drawn."""
    cfg = profiles.bench_config(pool=256, dtype=torch.float64)
    sim = driver.Simulation(va._torus(64, 32), photon_n=2000, mass_unit=4.0e19, seed=123,
                            config=cfg, device="cpu", warmup=0)
    sim.plan()
    return sim


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_frozen_bias_scale_is_the_jax_formula(small_sim, dtype):
    mc, cpu = small_sim.mc, torch.device("cpu")
    live_cfg = profiles.bench_config(pool=256, dtype=dtype)
    counters = engine.init_counters(mc.max_tau_scatt0, dtype, cpu)._replace(
        max_tau_scatt=torch.tensor(0.0371, dtype=dtype), avg_ema=torch.tensor(1.7, dtype=dtype))
    tabs = small_sim.tables
    frozen = engine.Engine(mc, live_cfg._replace(bias_fixed_tau=FREEZE[0],
                                                 bias_fixed_avg=FREEZE[1]), tabs, cpu, None)
    live = engine.Engine(mc, live_cfg, tabs, cpu, None)
    # the JAX engine: jnp.asarray(100 / (bias_norm * tau (avg + 2))).astype(dt), one
    # rounding of a Python float
    want = np.asarray(100.0 / (mc.bias_norm * (FREEZE[0] * (FREEZE[1] + 2.0))),
                      dtype=str(dtype).removeprefix("torch."))
    got = frozen._bias_scale(counters)
    assert got.dtype == dtype and got.item() == want.item()
    # whatever the counters hold
    moved = counters._replace(max_tau_scatt=counters.max_tau_scatt * 9.0)
    assert frozen._bias_scale(moved).item() == want.item()
    live_want = (100.0 / (mc.bias_norm * (counters.max_tau_scatt * (counters.avg_ema + 2.0))))
    assert live._bias_scale(counters).item() == live_want.to(dtype).item()
    assert live._bias_scale(moved).item() != live._bias_scale(counters).item()
    # the event phase's bias reads the same frozen normalization
    theta = torch.tensor([0.5, 3.0], dtype=dtype)
    w = torch.tensor([1e20, 1e20], dtype=dtype)
    assert torch.equal(frozen.bias_func(theta, w, counters), frozen.bias_func(theta, w, moved))


@pytest.fixture(scope="module")
def jx():
    import jax  # noqa: F401

    from grmonty_tpu.models import harm
    from grmonty_tpu.ops import fluid
    from grmonty_tpu.transport import oracle_native as joracle
    from grmonty_tpu.utils import cache

    return types.SimpleNamespace(harm=harm, fluid=fluid, oracle=joracle, cache=cache)


@pytest.fixture(scope="module")
def trackers(jx, small_sim):
    """(port tracker factory, JAX tracker factory, photons) on one dump."""
    model = jx.harm.read_dump(va._torus(64, 32), 4.0e19)
    jmc = jx.fluid.make_model_consts(model)
    jtabs = types.SimpleNamespace(hotcross=jx.cache.hotcross_table(),
                                  k2_table=jx.cache.jnu_tables()[1])
    prims = np.asarray(model.data.stacked())
    photons = oracle_native.photons_from_rows(small_sim.emit_rows(0, 400),
                                              engine.WEIGHT_SCALE)

    def mine(seed, bias_fixed=None):
        return oracle_native.NativeTracker(small_sim.mc, prims, seed=seed, bias_fixed=bias_fixed)

    def ref(seed, bias_fixed=None):
        return jx.oracle.NativeTracker(jmc, jtabs, prims, seed=seed, bias_fixed=bias_fixed)

    return mine, ref, photons


def test_frozen_native_tracker_matches_jax(trackers):
    mine, ref, photons = trackers
    a, b, live = mine(125, FREEZE), ref(125, FREEZE), mine(125)
    for tr in (a, b, live):
        tr.run(photons, progress_every=0)
    assert b.n_recorded > 0 and b.n_scatt_rec > 0
    assert np.array_equal(a.spec, b.spec)
    assert (a.n_recorded, a.n_scatt_rec, a.max_tau_scatt) == (
        b.n_recorded, b.n_scatt_rec, b.max_tau_scatt)
    assert not np.array_equal(a.spec, live.spec)


def test_tracker_hooks_match_jax(trackers, small_sim):
    mine, ref, photons = trackers
    a, b = mine(7, FREEZE), ref(7, FREEZE)
    rng = np.random.default_rng(11)
    live = np.nonzero(photons.w > 0.0)[0][:12]
    assert live.size == 12
    for i in live:
        x, k = photons.x[i], photons.k[i]
        dk = rng.normal(size=4) * np.abs(k).max()
        dl = float(rng.uniform(0.01, 0.3))
        pa, pb = a.probe(x, k, dk, photons.e[i], dl), b.probe(x, k, dk, photons.e[i], dl)
        assert pa.shape == (oracle_native.PROBE_LEN,) and np.isfinite(pa[:77]).all()
        assert np.array_equal(pa, pb, equal_nan=True)
    k_tet = np.array([0.0, 1.1e-4, 0.8e-4, 0.5e-4])
    k_tet[0] = math.sqrt(np.sum(k_tet[1:] ** 2))
    for theta_e in (0.6, 5.0):
        ea = a.sample_electron(k_tet, theta_e, 300, seed=5)
        assert ea.shape == (300, 4) and np.isfinite(ea).all()
        assert np.array_equal(ea, b.sample_electron(k_tet, theta_e, 300, seed=5))
    p = np.array([1.25, 0.5, 0.3, 0.2])
    sa = a.sample_scattered(k_tet, p, 300, seed=9)
    assert sa.shape == (300, 4) and np.isfinite(sa).all()
    assert np.array_equal(sa, b.sample_scattered(k_tet, p, 300, seed=9))


def test_port_gate_end_to_end_on_the_cpu(jax_run, tmp_path):
    res, _, _ = jax_run
    out_json = tmp_path / "gate.json"
    cmd = [sys.executable, "-m", "grmonty_tpu_torch.tools.validate_accuracy", "--device", "cpu",
           "--photons", "150", "--oracle-reps", "3", "--freeze-bias", str(FREEZE[0]),
           "--json", str(out_json)]
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(out_json) as f:
        got = json.load(f)
    assert set(res) <= set(got), set(res) - set(got)
    assert set(res["origin_decomp"]) <= set(got["origin_decomp"])
    assert got["n_hc_clamp_engine"] == 0 and got["n_engine"] == got["n_oracle"] == 150
    assert got["freeze_bias"] == list(FREEZE) and got["engine_config"]["dtype"] == "float64"
    assert got["device"]["platform"] == "cpu" and got["engine_run"]["hot_iters"] > 0
    assert 0.5 < got["lum_ratio"] < 2.0 and got["dof"] > 0


def test_reference_gate_passes_its_hard_gates_on_the_cpu(tmp_path):
    """``--reference`` (reference semantics in float64, the JAX tool's
    default run) against the native oracle at a tiny size: exit 0, so every
    hard gate passes; the run was reference semantics in float64."""
    va._torus(64, 32)
    out_json = tmp_path / "gate.json"
    cmd = [sys.executable, "-m", "grmonty_tpu_torch.tools.validate_accuracy", "--device", "cpu",
           "--reference", "--photons", "150", "--oracle-reps", "3",
           "--freeze-bias", str(FREEZE[0]), "--json", str(out_json)]
    out = subprocess.run(cmd, cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(out_json) as f:
        got = json.load(f)
    conf = got["engine_config"]
    assert conf["reference"] is True and conf["dtype"] == "float64"
    assert conf["grow_cap"] == 1.0 and conf["refill_period"] == 0
    assert not va.gate_failures(got) and got["n_hc_clamp_engine"] == 0
    assert got["origin_decomp"]["chi2_sec_gen_per_dof"] < va.GEN_GATE
    assert got["n_engine"] == got["n_oracle"] == 150 and got["engine_run"]["hot_iters"] > 0
    assert 0.5 < got["lum_ratio"] < 2.0 and got["dof"] > 0


def test_gate_config_takes_float64_and_reference_semantics_on_the_card():
    cfg, tail = va._config(va.parse_args(["--device", "cuda"]))
    assert cfg == profiles.bench_config(pool=va.POOL, dtype=torch.float64)._replace(
        sec_cap=va.SEC_CAP)
    assert tail == {"tail_grow_cap": 16.0, "tail_stall_steps": 50000}
    cfg, tail = va._config(va.parse_args(["--device", "cuda", "--bench-profile",
                                          "--freeze-bias", "0.025"]))
    assert cfg.dtype == torch.float32 and cfg.n_pool == va.POOL and cfg.sec_cap == va.SEC_CAP
    assert (cfg.bias_fixed_tau, cfg.bias_fixed_avg) == (0.025, 2.6)
    assert tail == {"tail_grow_cap": 16.0, "tail_stall_steps": 50000}
    # --reference: reference_config's fields in float64 (the tool's ring), the
    # tail of reference_sim_kwargs (no overrides), the frozen bias applied
    cfg, tail = va._config(va.parse_args(["--device", "cuda", "--reference",
                                          "--freeze-bias", "0.0025"]))
    want = profiles.reference_config(pool=va.POOL, dtype=torch.float64)
    assert cfg == want._replace(sec_cap=va.SEC_CAP, bias_fixed_tau=0.0025, bias_fixed_avg=2.6)
    kw = profiles.reference_sim_kwargs(va.POOL)
    assert tail == {k: kw.get(k) for k in ("tail_grow_cap", "tail_stall_steps")}
    assert tail == {"tail_grow_cap": None, "tail_stall_steps": None}
    with pytest.raises(SystemExit):
        va.parse_args(["--reference", "--bench-profile"])


def _synthetic(rng, sec_scale=None):
    """Seeded spectra of R = 5 oracle replicates and one engine run: per
    energy bin, primaries and secondaries (channels 2, 14), their
    generations (15), weights (1, 13) and scatters (3); ``sec_scale``
    multiplies the engine's secondaries per energy group."""
    nb, ne, c = consts.N_TH_BINS, consts.N_E_BINS, oracle_native.N_SPEC_CHAN
    e = np.arange(ne)
    prim = np.where((e > 20) & (e < 120), 40.0, 0.0)
    sec = np.where((e > 60) & (e < 190), 200.0 * np.exp(-((e - 130) / 40.0) ** 2), 0.0)
    gen = 1.0 + 4.0 * np.clip((e - 60) / 130.0, 0.0, 1.0)

    def one(scale):
        s = np.zeros((nb, ne, c))
        for th in range(nb):
            p_n = rng.poisson(prim / nb)
            s_n = rng.poisson(sec * scale / nb)
            s[th, :, 2] = p_n + s_n
            s[th, :, 14] = s_n
            s[th, :, 15] = s_n * gen
            s[th, :, 1] = (p_n + s_n) * 1e30 * (1.0 + e / 50.0)
            s[th, :, 13] = (p_n + s_n) * (1e30 * (1.0 + e / 50.0)) ** 2
            s[th, :, 3] = s_n * gen
        return s

    reps = np.stack([one(1.0) for _ in range(5)])
    scale = np.ones(ne) if sec_scale is None else np.repeat(sec_scale, 10)
    return one(scale), reps


@pytest.mark.parametrize("distorted", [False, True])
def test_compare_trips_the_generation_gate_on_a_distorted_shape(distorted):
    rng = np.random.default_rng(2026)
    groups = consts.N_E_BINS // 10
    scale = None
    if distorted:  # the top Compton groups doubled, the middle ones halved
        scale = np.ones(groups)
        scale[14:] = 2.0
        scale[8:11] = 0.5
    se, reps = _synthetic(rng, scale)
    n = 20000
    counts = dict(n_photons=n, n_recorded=int(se[:, :, 2].sum()), max_tau_scatt=0.0025,
                  n_stall=0, w_stall_frac=0.0, n_hc_clamp=0, n_ev_soft=0, n_ev_forced=0)
    ocounts = dict(n_photons=n, n_recorded=int(reps[:, :, :, 2].sum(axis=(1, 2)).mean()),
                   max_tau_scatt=0.0025)
    out = va.compare(se, reps.mean(0), reps, counts, ocounts)
    out["freeze_bias"] = list(FREEZE)
    gen = out["origin_decomp"]["chi2_sec_gen_per_dof"]
    assert out["origin_decomp"]["sec_gen_variance_model"] == "replicate median/MAD (R=5)"
    if distorted:
        assert gen >= va.GEN_GATE and any("kappa^g" in f for f in va.gate_failures(out))
    else:
        assert gen < va.GEN_GATE and va.gate_failures(out) == []
        out["n_hc_clamp_engine"] = 3
        assert va.gate_failures(out) == ["hotcross clamp path reached 3 times"]


# (g) the oracle cache: a regime and, per field, an argument that changes it
CACHE_BASE = ["--device", "cpu", "--photons", "6", "--oracle-reps", "3",
              "--freeze-bias", str(FREEZE[0])]
CACHE_CHANGES = {
    "n_photons": ["--photons", "5"], "photon_n": ["--photon-n", "2001"],
    "seed": ["--seed", "124"], "mass_unit": ["--mass-unit", "4e18"],
    "freeze_bias": ["--freeze-bias", "0.025"], "freeze_avg": ["--freeze-avg", "2.5"],
    "oracle_reps": ["--oracle-reps", "5"], "oracle": ["--oracle", "python"],
    "n1": ["--n1", "32"], "n2": ["--n2", "16"], "reference": ["--reference"],
    "dtype": ["--bench-profile"], "device": ["--device", "cuda"],
}


def _cache(path, argv):
    """Write a cache with fake spectra for the regime of ``argv`` at 6
    photons; returns what was written."""
    args = va.parse_args(argv)
    spec = np.random.default_rng(3).random((4, 2))
    specs, counts = np.stack([spec, 2.0 * spec]), dict(n_recorded=17, max_tau_scatt=0.5)
    va.save_oracle(str(path), va.oracle_regime(args, args.photons), spec, specs, counts, 1.5)
    return spec, specs


def test_oracle_regime_records_every_field():
    regime = va.oracle_regime(va.parse_args(CACHE_BASE), 6)
    assert tuple(regime) == va.ORACLE_FIELDS == tuple(CACHE_CHANGES)
    live = va.oracle_regime(va.parse_args(["--device", "cpu"]), 6)
    assert (live["freeze_bias"], live["freeze_avg"]) == (0.0, 0.0)


@pytest.mark.parametrize("field", list(CACHE_CHANGES))
def test_oracle_cache_of_another_regime_is_refused(tmp_path, field):
    path = tmp_path / "oracle.npz"
    _cache(path, CACHE_BASE)
    args = va.parse_args(CACHE_BASE + CACHE_CHANGES[field])
    with pytest.raises(SystemExit, match=f"with {field} = .*, this run has {field} = "):
        va.load_oracle(str(path), va.oracle_regime(args, args.photons))


def test_oracle_cache_is_reused_on_an_exact_match(tmp_path):
    path = tmp_path / "oracle.npz"
    spec, specs = _cache(path, CACHE_BASE)
    args = va.parse_args(CACHE_BASE)
    got_spec, got_specs, counts, secs = va.load_oracle(str(path), va.oracle_regime(args, 6))
    assert np.array_equal(got_spec, spec) and np.array_equal(got_specs, specs)
    assert counts == dict(n_photons=6, n_recorded=17, max_tau_scatt=0.5) and secs == 1.5


@pytest.mark.parametrize("change", [["--seed", "124"], ["--mass-unit", "4e18"],
                                    ["--freeze-bias", "0.025"], None],
                         ids=["seed", "mass_unit", "freeze_bias", "no_fields"])
def test_gate_stops_on_a_cache_of_another_regime(tmp_path, change, monkeypatch):
    """The tool itself (``run``) refuses a cache written under another seed,
    mass unit or frozen bias, and one written without the regime's fields,
    before its engine runs."""
    path = tmp_path / "oracle.npz"
    if change is None:  # the fields an older file held
        np.savez(path, spec=np.zeros(2), specs=np.zeros((3, 2)), n_recorded=1, seconds=1.0,
                 n_photons=6, seed=123, mass_unit=4e19, max_tau_scatt=0.1)
        field, argv = "photon_n", CACHE_BASE
    else:
        _cache(path, CACHE_BASE)
        field, argv = change[0].strip("-").replace("-", "_"), CACHE_BASE + change
    monkeypatch.setattr(va, "run_engine", lambda *a: pytest.fail("the engine ran"))
    match = "records no photon_n" if change is None else f"with {field} = "
    with pytest.raises(SystemExit, match=match):
        va.run(va.parse_args(argv + ["--oracle-npz", str(path)]))


def test_oracle_spread_runs_the_gates_replicates(capsys):
    """``tools/oracle_spread.py`` at its defaults tracks the gate's own
    sample at the gate's replicate seeds: its per-seed secondaries equal
    those of ``validate_accuracy.run_oracle``'s replicates."""
    from grmonty_tpu_torch.tools import oracle_spread

    argv = ["--device", "cpu", "--reference", "--photons", "150", "--freeze-bias",
            str(FREEZE[0])]
    oracle_spread.main(argv + ["--n-seeds", "3"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    runs, summary = lines[:-1], lines[-1]
    args = va.parse_args(argv)
    sim, rows = va.gate_sample(args)
    _, specs, _, _ = va.run_oracle(sim, rows, args.seed, 3, (args.freeze_bias, args.freeze_avg))
    assert [r["seed"] for r in runs] == [args.seed + 1, args.seed + 2, args.seed + 3]
    assert [r["n_sec"] for r in runs] == [float(sp[..., 14].sum()) for sp in specs]
    assert summary["photons"] == 150 and summary["seeds"] == [args.seed + 1, args.seed + 3]
    assert summary["n_sec_min"] <= summary["n_sec_median"] <= summary["n_sec_max"]
