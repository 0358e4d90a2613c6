"""The port's run schedule against the JAX driver's, on the 64x32 torus (CPU).

* The native tracker: the port's ``csrc/oracle.cpp`` is the JAX package's
  ``native/oracle.cpp`` byte for byte, and the port's ``NativeTracker``
  gives the JAX one's spectrum and counters to every bit on one batch and
  seed (two chunked calls); a missing ``g++`` or a failed build raises.
* The pilot: its photons sit at the plan indices linspace(0, total - 1,
  warm) in plan order, and its warmed counters equal JAX
  ``Simulation._host_warm_counters`` on the same batch to every bit, in
  float64 and float32; with the pilot on, the spectrum's photon count
  equals ``n_recorded`` (the port of tests/test_fast_e2e.py:61).
* The first-wave ramp: :func:`driver.wave_list` equals the waves (first
  photon, photons, exit occupancy) that JAX ``Simulation.run`` hands to its
  ``_run_wave``, for several (total, chunk) pairs.
* The tail cascade: ``tail_gather`` / ``tail_merge`` equal the ``gather`` /
  ``merge`` of JAX ``Simulation._drain_jits`` field by field on a seeded
  JAX pool of 1,024 lanes carried in with ``convert.from_jax_pool``, at
  n_t = 512.

* The kernel build: a CPU ``Simulation`` builds nothing and reports
  ``compile_s`` 0.0; a CUDA one has its kernels loaded before ``run()``
  (a ``cuda`` test).

JAX's driver methods run on stand-in objects that hold only the attributes
they read, so no JAX engine is compiled.  JAX is imported inside a fixture,
so that the card test, which needs no JAX, also runs on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_driver.py``.
"""

import hashlib
import os
import types

import numpy as np
import pytest
import torch

from grmonty_tpu_torch import consts, convert
from grmonty_tpu_torch.models import torus
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, oracle_native, profiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M_UNIT = 4.0e18


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Pools of a few hundred lanes: intra-op threads only add overhead, and
    the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules that the comparisons read."""
    import jax
    import jax.numpy as jnp
    from jax import random

    from grmonty_tpu.models import harm
    from grmonty_tpu.ops import fluid
    from grmonty_tpu.transport import driver as jdriver
    from grmonty_tpu.transport import engine as jengine
    from grmonty_tpu.transport import oracle_native as joracle
    from grmonty_tpu.utils import cache

    return types.SimpleNamespace(jax=jax, jnp=jnp, random=random, harm=harm, fluid=fluid,
                                 driver=jdriver, engine=jengine, oracle=joracle, cache=cache)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dump") / "torus")
    torus.write_torus_dump(path, n1=64, n2=32)
    return path


@pytest.fixture(scope="module")
def sim(dump):
    """A port Simulation (CPU, float64) with its plan drawn."""
    cfg = profiles.bench_config(pool=256, dtype=torch.float64)
    s = driver.Simulation(dump, photon_n=180, mass_unit=M_UNIT, config=cfg, device="cpu",
                          warmup=1024)
    s.plan_ = s.plan()
    return s


@pytest.fixture(scope="module")
def jax_side(jx, dump):
    """What the JAX tracker reads: mc, the two tables, the primitives."""
    model = jx.harm.read_dump(dump, M_UNIT)
    tabs = types.SimpleNamespace(hotcross=jx.cache.hotcross_table(),
                                 k2_table=jx.cache.jnu_tables()[1])
    return jx.fluid.make_model_consts(model), tabs, np.asarray(model.data.stacked())


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_oracle_source_is_the_jax_packages():
    assert _sha(oracle_native.SRC) == _sha(os.path.join(ROOT, "native", "oracle.cpp"))


def test_native_tracker_matches_jax(jx, sim, jax_side):
    jmc, jtabs, prims = jax_side
    batch = oracle_native.photons_from_rows(sim._pilot_rows(600))
    mine = oracle_native.NativeTracker(sim.mc, prims, seed=7)
    ref = jx.oracle.NativeTracker(jmc, jtabs, prims, seed=7)
    for lo, hi in ((0, 250), (250, 600)):
        part = oracle_native.Photons(*[a[lo:hi] for a in batch])
        mine.run(part, progress_every=0)
        ref.run(part, progress_every=0)
    assert ref.n_recorded > 0 and ref.n_scatt_rec > 0
    assert np.array_equal(mine.spec, ref.spec)
    assert (mine.n_recorded, mine.n_scatt_rec) == (ref.n_recorded, ref.n_scatt_rec)
    assert mine.max_tau_scatt == ref.max_tau_scatt


def test_native_tracker_raises_without_a_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(oracle_native, "_lib", None)
    monkeypatch.setattr(oracle_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(oracle_native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        oracle_native.load()
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.undo()
    monkeypatch.setattr(oracle_native, "_lib", None)
    monkeypatch.setattr(oracle_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(oracle_native, "SRC", str(bad))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        oracle_native.load()
    assert not any(p.suffix == ".so" for p in tmp_path.iterdir())


def test_pilot_photons_sit_at_evenly_spaced_plan_indices(sim):
    warm = 300
    rows = sim._pilot_rows(warm).numpy()
    plan = sim.plan_
    idx = np.asarray(np.linspace(0, plan.total - 1, warm), np.int64)
    zflat = plan.zone_i[idx].astype(np.int64) * sim.mc.n2 + plan.zone_j[idx]
    assert rows.shape == (warm, engine.ROW_WIDTH) and rows.dtype == np.float64
    np.testing.assert_array_equal(rows[:, :4], sim._zone_tabs.x[zflat].numpy())
    live = rows[:, engine.ROW_W] > 0.0
    # raw weights (the engine's units are WEIGHT_SCALE = 1e-25 times these)
    assert live.mean() > 0.5 and np.median(rows[live, engine.ROW_W]) > consts.WEIGHT_MIN


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_pilot_counters_match_jax(jx, sim, jax_side, dtype):
    jmc, jtabs, prims = jax_side
    rows = sim._pilot_rows(min(1024, sim.plan_.total))
    t_dt, j_dt = getattr(torch, dtype), getattr(jx.jnp, dtype)
    mine = sim._host_warm_counters(rows, engine.init_counters(sim.mc.max_tau_scatt0, t_dt,
                                                              torch.device("cpu")))
    stand_in = types.SimpleNamespace(mc=jmc, tables=jtabs, prims=prims, seed=sim.seed)
    ref = jx.driver.Simulation._host_warm_counters(
        stand_in, oracle_native.photons_from_rows(rows),
        jx.engine.init_counters(jmc.max_tau_scatt0, j_dt))
    assert ref is not None and int(ref.n_recorded) > 0
    for name in ("n_recorded", "n_scatt_rec", "max_tau_scatt", "avg_ema", "ema_scatt_mark",
                 "ema_rec_mark"):
        got, want = getattr(mine, name).numpy(), np.asarray(getattr(ref, name))
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (name, got, want)
    assert sim.pilot["n_recorded"] == int(ref.n_recorded)


@pytest.mark.parametrize("total,chunk", [(100, 1000), (1000, 1000), (5000, 1024),
                                         (2000, 8), (20, 7), (1_587_750, 1 << 20),
                                         (793_890, 1 << 20), (3 << 20, 1 << 20)])
def test_wave_list_matches_jax(jx, total, chunk):
    jengine, jnp = jx.engine, jx.jnp
    pool, tail_exit = 65536, 65536
    seen = []
    state = jengine.State(
        pool=jengine.empty_pool(8, jnp.float32), spec=jnp.zeros((1, 1)),
        counters=jengine.init_counters(1.0, jnp.float32),
        sec=jengine.empty_secbuf(8, jnp.float32), backlog_pos=jnp.zeros((), jnp.int32),
        key=jx.random.PRNGKey(0), it=jnp.zeros((), jnp.int32))

    def run_wave(st, backlog, t0, c, n, tot, start=0, tail_exit=None, n_valid=None):
        seen.append((start, n_valid, tail_exit))
        return st

    stand_in = types.SimpleNamespace(
        plan=lambda: types.SimpleNamespace(total=total), key=jx.random.PRNGKey(0),
        engine={"fresh_state": lambda k: state}, _warm_compile=lambda plan: None,
        warmup=0, emit_chunk=chunk, cfg=types.SimpleNamespace(n_pool=pool, weight_scale=1.0),
        _wave_tail_exit=tail_exit, emit_packed_host=lambda *a: None, _run_wave=run_wave,
        _drain_tail=lambda st: st, _drain_spec=lambda st: st, device_s=0.0,
        spec_acc=np.zeros((1, 16)))
    jx.driver.Simulation.run(stand_in)
    assert driver.wave_list(total, chunk, pool, tail_exit) == seen
    assert sum(n for _, n, _ in seen) == total


def _jax_pool(jx, n, seed):
    """A JAX pool with detached events, every field seeded at random, about
    60% of the lanes occupied."""
    jnp = jx.jnp
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype == bool:
            return jnp.asarray(rng.random(a.shape) < 0.6)
        if a.dtype.kind == "i":
            return jnp.asarray(rng.integers(0, 1000, a.shape).astype(a.dtype))
        return jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype))

    return jx.jax.tree.map(fill, jx.engine.empty_pool(n, jnp.float64, detached_events=True))


def _assert_pools_equal(got, ref, what):
    for name in engine.Pool._fields:
        g, r = getattr(got, name), getattr(ref, name)
        for i, (gc, rc) in enumerate(zip(g, r) if isinstance(g, tuple) else [(g, r)]):
            assert gc.dtype == rc.dtype and torch.equal(gc, rc), f"{what}.{name}[{i}]"


def test_tail_gather_and_merge_match_jax(jx):
    jnp = jx.jnp
    n_pool, n_t = 1024, 512
    stand_in = types.SimpleNamespace(
        cfg=types.SimpleNamespace(n_pool=n_pool, detached_events=True), _drain_fns={})
    gather, merge, _ = jx.driver.Simulation._drain_jits(stand_in, n_t)
    jpool = _jax_pool(jx, n_pool, 11)
    assert int(jpool.occupied.sum()) > n_t  # the gather must truncate
    j_small, j_wide = gather(jpool)
    small, wide = driver.tail_gather(convert.from_jax_pool(jpool, torch.float64), n_t)
    _assert_pools_equal(small, convert.from_jax_pool(j_small, torch.float64), "small")
    _assert_pools_equal(wide, convert.from_jax_pool(j_wide, torch.float64), "wide")
    assert int(small.occupied.sum()) == n_t

    # leftovers of a stage: some lanes retired, the rest merged back
    left = np.random.default_rng(12).random(n_t) < 0.3
    j_small = j_small._replace(occupied=j_small.occupied & jnp.asarray(left))
    small = small._replace(occupied=small.occupied & torch.as_tensor(left))
    merged = driver.tail_merge(wide, small)
    _assert_pools_equal(merged, convert.from_jax_pool(merge(j_wide, j_small), torch.float64),
                        "merged")
    assert int(merged.occupied.sum()) == int(wide.occupied.sum()) + int(left.sum())


def test_tail_sizes_follow_the_pool(sim):
    assert sim._tail_sizes() == [256]
    wide = driver.Simulation.__new__(driver.Simulation)
    wide.cfg = profiles.bench_config(pool=65536)
    assert wide._tail_sizes() == [65536, 4096, 512]


def test_pilot_accounting(dump):
    """The spectrum's photon count equals n_recorded with the pilot on: its
    records are injected into the counters and its spectrum dropped, so
    they are debited at the end."""
    cfg = profiles.bench_config(pool=64, dtype=torch.float64)._replace(
        m_period=8, sec_cap=512, stall_steps=5000)
    s = driver.Simulation(dump, photon_n=30, mass_unit=M_UNIT, config=cfg, device="cpu",
                          emit_chunk=1024, warmup=64, tail_stall_steps=5000)
    spec, stats = s.run()
    assert s._warm_counts is not None and s._warm_counts[0] > 0
    assert stats["pilot"]["photons"] == 64 and stats["n_recorded"] > 0
    assert spec[: engine.N_BINS, 2].sum() == stats["n_recorded"]
    assert [st["pool"] for st in stats["tail_stages"]] == [64]


def test_cpu_simulation_builds_no_kernels(dump, monkeypatch):
    """On the CPU nothing is built: ``compile_s`` is 0.0 from ``run()``."""
    def refuse():
        raise AssertionError("a CPU Simulation built the CUDA kernels")

    monkeypatch.setattr(hot_kernels, "build", refuse)
    cfg = profiles.bench_config(pool=64, dtype=torch.float64)._replace(
        m_period=8, sec_cap=512, stall_steps=100)
    s = driver.Simulation(dump, photon_n=1, mass_unit=M_UNIT, config=cfg, device="cpu",
                          emit_chunk=1024, warmup=0, tail_stall_steps=100)
    assert s.compile_s == 0.0
    _, stats = s.run()
    assert stats["compile_s"] == 0.0 and stats["device_s"] is None
    assert stats["n_created"] > 0


@pytest.mark.cuda
def test_cuda_simulation_loads_the_kernels_before_run(dump, monkeypatch):
    """A CUDA ``Simulation`` builds or loads the kernels in ``__init__`` as a
    process that does not hold them yet must (the loaded state is dropped
    first), reports those seconds as ``compile_s``, and ``run()`` then finds
    them loaded at every launch, so no build falls inside ``device_s``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    first_in_process = not hot_kernels.built()
    for attr in ("fns", "paths", "seconds", "log"):
        monkeypatch.setattr(hot_kernels._Build, attr, getattr(hot_kernels._Build, attr))
    hot_kernels._Build.fns = None

    def make():
        return driver.Simulation(dump, photon_n=10, mass_unit=M_UNIT,
                                 config=profiles.bench_config(pool=512, dtype=torch.float32),
                                 device="cuda", warmup=0)

    s = make()
    assert hot_kernels.built() and s.compile_s > 0.0
    build = hot_kernels.build

    def loaded_only():
        assert hot_kernels.built(), "run() built the kernels inside the device window"
        return build()

    monkeypatch.setattr(hot_kernels, "build", loaded_only)
    _, stats = s.run()
    assert stats["compile_s"] == s.compile_s and stats["device_s"] > 0.0
    assert stats["n_created"] > 0
    print(f"compile_s {s.compile_s:.4f} device_s {stats['device_s']:.4f} "
          f"(first build in this process: {first_in_process})")
    assert make().compile_s == 0.0  # the process already holds them
