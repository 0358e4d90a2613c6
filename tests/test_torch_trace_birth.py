"""The engine's birth-state trace (``EngineConfig.trace_birth``, ``Pool.bx/bk/bw``,
``Counters.mt_*``) and the deep-tau replay tool, on the 64x32 torus (CPU).

* Against JAX, float64: a JAX engine with the trace on and the shipped
  profile's physics runs light phases (record, free, refill, fresh-lane
  init: no random draw) from a fresh state and from a state whose pending
  records carry distinct ``tau_scatt`` against a ratchet some of them pass
  (and one none passes); each state is carried into the port with
  ``convert.from_jax_state`` and the port runs the same phase.  Every pool
  field, the birth fields among them, and every counter, the ``mt_*``
  capture among them, agree to rtol 1e-12.
* The trace changes nothing else: a ``Simulation`` with and without it on
  one seed gives the same spectrum to every bit and the same counters,
  apart from ``mt_*``, which only the traced run fills.
* A traced checkpoint round-trips every tensor; a checkpoint resumed with
  the trace switched is refused, naming ``trace_birth``;
  ``ShardedSimulation`` refuses the trace.
* ``replay_deep_tau --device cpu --bench-profile`` at 8 photons and 256
  lanes writes the JAX tool's keys, a finite nonzero birth wave vector
  and one of its three verdicts.
* On the card (a ``cuda`` test), the trace changes no counter but ``mt_*``
  and no kernel launch, and the spectrum within rtol 1e-6 (float atomics
  sum it there).  JAX is imported inside a fixture, so that this test also
  runs on the card: ``python -m pytest --noconftest -m cuda
  tests/test_torch_trace_birth.py``.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from grmonty_tpu_torch import convert
from grmonty_tpu_torch.models import harm, torus
from grmonty_tpu_torch.ops import fluid
from grmonty_tpu_torch.parallel import sharding
from grmonty_tpu_torch.tools import replay_deep_tau
from grmonty_tpu_torch.transport import driver, engine, profiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL = 256
MT = ("mt_bx", "mt_bk", "mt_bw", "mt_nsc0")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Pools of a few hundred lanes: intra-op threads only add overhead, and
    the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return str(path)


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.dtype.kind in "bi":
        assert np.array_equal(got.astype(ref.dtype), ref), what
        return
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0, err_msg=what)


def _assert_states_close(got, ref):
    for name in engine.Pool._fields:
        g, r = getattr(got.pool, name), getattr(ref.pool, name)
        assert isinstance(g, tuple) == isinstance(r, tuple), name
        pairs = list(zip(g, r)) if isinstance(g, tuple) else [(g, r)]
        assert len(pairs) == (len(r) if isinstance(r, tuple) else 1), name
        for i, (gc, rc) in enumerate(pairs):
            _close(gc.numpy(), rc.numpy(), f"pool.{name}[{i}]")
    for name in engine.Counters._fields:
        _close(getattr(got.counters, name).numpy(), getattr(ref.counters, name).numpy(),
               f"counters.{name}")
    _close(got.spec.numpy(), ref.spec.numpy(), "spec")


@pytest.fixture(scope="module")
def jax_side(dump):
    """The JAX engine (trace on, shipped physics, float64, POOL lanes), its
    jitted light phase, a fresh state and a backlog; the port's engine on
    the same tables."""
    import jax
    import jax.numpy as jnp
    from jax import random

    from grmonty_tpu.transport import driver as jdriver
    from grmonty_tpu.transport import engine as jengine

    pcfg = profiles.bench_config(pool=POOL, dtype=torch.float64)._replace(
        sec_cap=4 * POOL, ev_k=POOL // 4, refill_k=POOL // 2, light_k=POOL // 4,
        trace_birth=True)
    jcfg = jengine.EngineConfig(
        n_pool=POOL, m_period=pcfg.m_period, sec_cap=pcfg.sec_cap, stall_steps=pcfg.stall_steps,
        fp_iters=engine.FP_ITERS, ev_k=pcfg.ev_k, refill_k=pcfg.refill_k,
        light_k=pcfg.light_k, refill_period=pcfg.refill_period, grow_cap=pcfg.grow_cap,
        grow_tau_cap=engine.GROW_TAU_CAP, step_ctrl=engine.STEP_CTRL,
        bias_ema=engine.BIAS_EMA, detached_events=True, derived_fluid=True,
        trace_birth=True, dtype=jnp.float64)
    assert convert.from_jax_config(jcfg) == pcfg
    jsim = jdriver.Simulation(dump, photon_n=2000, mass_unit=4e19, config=jcfg,
                              cdf_sampler=True, emit_stride=True, warmup=0)
    backlog = jsim.emit_packed(jsim.plan(), 0, 4 * POOL)
    eng = jsim.engine
    mc = fluid.make_model_consts(harm.read_dump(dump, 4e19))
    port = engine.Engine(mc, pcfg, convert.from_jax_engine_tables(jsim._engine_tabs),
                         torch.device("cpu"), torch.Generator())
    return dict(light=jax.jit(eng["light_phase"]), fresh=eng["fresh_state"](random.PRNGKey(3)),
                backlog=backlog, port=port, jnp=jnp)


def test_fresh_lanes_capture_their_birth_state_as_jax(jax_side):
    light, port, backlog = jax_side["light"], jax_side["port"], jax_side["backlog"]
    s0 = jax_side["fresh"]
    ref = convert.from_jax_state(light(s0, backlog))
    got = port.light_phase(convert.from_jax_state(s0), torch.as_tensor(np.array(backlog)))
    _assert_states_close(got, ref)
    occ = got.pool.occupied
    assert int(occ.sum()) == port.light_k
    for birth, now in zip((*got.pool.bx, *got.pool.bk, got.pool.bw),
                          (*got.pool.x, *got.pool.k, got.pool.w)):
        assert torch.equal(birth[occ], now[occ])
    assert float(got.pool.bw[occ].min()) > 0.0


@pytest.mark.parametrize("ratchet", [0.5, 2.0])
def test_recorded_ratchet_captures_the_birth_state_as_jax(jax_side, ratchet):
    """Pending records with distinct tau_scatt in [0, 1) against a ratchet
    of 0.5 (the deepest valid one is captured) and of 2.0 (none passes:
    mt_* keep their values)."""
    light, port, backlog = jax_side["light"], jax_side["port"], jax_side["backlog"]
    jnp = jax_side["jnp"]
    s1 = light(jax_side["fresh"], backlog)
    rng = np.random.default_rng(5)
    occ = np.asarray(s1.pool.occupied)
    pend = occ & (rng.random(POOL) < 0.5)
    tau = rng.permutation(POOL) / POOL
    c = s1.counters
    s1 = s1._replace(
        pool=s1.pool._replace(record_pending=jnp.asarray(pend), tau_scatt=jnp.asarray(tau),
                              alive=s1.pool.alive & ~jnp.asarray(pend)),
        counters=c._replace(max_tau_scatt=jnp.asarray(ratchet, jnp.float64),
                            mt_bx=jnp.full((4,), 7.0), mt_bk=jnp.full((4,), 3.0),
                            mt_bw=jnp.asarray(2.0), mt_nsc0=jnp.asarray(4, jnp.int64)))
    ref = convert.from_jax_state(light(s1, backlog))
    p1 = convert.from_jax_state(s1)
    got = port.light_phase(p1, torch.as_tensor(np.array(backlog)))
    _assert_states_close(got, ref)

    # the deepest of the first light_k pending lanes, as the record reads them
    lanes = np.flatnonzero(pend)[:port.light_k]
    best = lanes[np.argmax(tau[lanes])]
    if tau[best] > ratchet:
        want = ([float(v[best]) for v in p1.pool.bx], [float(v[best]) for v in p1.pool.bk],
                float(p1.pool.bw[best]), int(p1.pool.nsc0[best]))
    else:
        want = ([7.0] * 4, [3.0] * 4, 2.0, 4)
    assert got.counters.mt_bx.tolist() == want[0] and got.counters.mt_bk.tolist() == want[1]
    assert float(got.counters.mt_bw) == want[2] and int(got.counters.mt_nsc0) == want[3]


def _sim(dump, trace_birth, **kw):
    cfg = profiles.bench_config(pool=POOL, dtype=torch.float64)._replace(
        m_period=8, sec_cap=4096, stall_steps=5000, trace_birth=trace_birth)
    args = dict(photon_n=8, mass_unit=4.0e19, seed=123, config=cfg, device="cpu",
                emit_chunk=512, warmup=64, tail_stall_steps=5000)
    args.update(kw)
    return driver.Simulation(dump, **args)


def test_trace_changes_nothing_else(dump):
    runs = {}
    for traced in (False, True):
        sim = _sim(dump, traced)
        spec, stats = sim.run()
        runs[traced] = (spec, stats, sim.state.counters)
    (spec0, st0, c0), (spec1, st1, c1) = runs[False], runs[True]
    assert np.array_equal(spec0, spec1)
    for name in engine.Counters._fields:
        if name not in MT:
            assert torch.equal(getattr(c0, name), getattr(c1, name)), name
    for key in st0:
        if key not in ("elapsed_s", "photon_rate", "pilot"):
            assert st0[key] == st1[key], key
    assert all(not bool(getattr(c0, name).any()) for name in MT)
    assert float(c1.mt_bw) > 0.0 and float(c1.mt_bk[0]) > 0.0
    assert int(c0.n_recorded) > 0


@pytest.mark.cuda
def test_trace_changes_nothing_else_on_the_card(dump):
    from grmonty_tpu_torch.transport import hot_kernels

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    runs = {}
    for traced in (False, True):
        cfg = profiles.bench_config(pool=512, dtype=torch.float32)._replace(trace_birth=traced)
        sim = driver.Simulation(dump, photon_n=20, mass_unit=4e20, seed=123, config=cfg,
                                device="cuda", warmup=0)
        hot_kernels.reset_launches()
        spec, stats = sim.run()
        runs[traced] = (spec, stats, sim.state.counters, dict(hot_kernels.launches))
    (spec0, st0, c0, n0), (spec1, st1, c1, n1) = runs[False], runs[True]
    np.testing.assert_allclose(spec1, spec0, rtol=1e-6, atol=0.0)
    for name in engine.Counters._fields:
        if name not in MT:
            assert torch.equal(getattr(c0, name), getattr(c1, name)), name
    assert n0 == n1 and n0["hot_step"] == st0["hot_iters"] > 0
    assert all(not bool(getattr(c0, name).any()) for name in MT)
    print(f"mt_bw {float(c1.mt_bw)} mt_nsc0 {int(c1.mt_nsc0)} max_tau {float(c1.max_tau_scatt)}")


def _state_after_a_phase(sim):
    sim.plan()
    state = sim.engine.fresh_state()
    state = sim.engine.periodic_phase(state, sim.emit_rows(0, 512))
    return sim.engine.hot_step(state)._replace(it=3)


def test_traced_checkpoint_round_trips(dump, tmp_path):
    ck = str(tmp_path / "traced.npz")
    sim = _sim(dump, True)
    state = _state_after_a_phase(sim)
    sim.save_checkpoint(ck, 1, state)
    _, got = _sim(dump, True).load_checkpoint(ck)
    flat_got, flat_ref = driver._flat_state(got), driver._flat_state(state)
    assert flat_got.keys() == flat_ref.keys()
    assert {"pool.bx.3", "pool.bk.0", "pool.bw", "counters.mt_bx"} <= flat_ref.keys()
    for name, ref in flat_ref.items():
        assert flat_got[name].dtype == ref.dtype and torch.equal(flat_got[name], ref), name
    assert float(got.pool.bw.max()) > 0.0


@pytest.mark.parametrize("saved_traced", [True, False])
def test_checkpoint_refuses_a_switched_trace(dump, tmp_path, saved_traced):
    ck = str(tmp_path / "switched.npz")
    sim = _sim(dump, saved_traced)
    sim.save_checkpoint(ck, 1, _state_after_a_phase(sim))
    with pytest.raises(ValueError, match="trace_birth"):
        _sim(dump, not saved_traced).load_checkpoint(ck)


def test_untraced_checkpoint_holds_no_birth_fields(dump, tmp_path):
    ck = str(tmp_path / "untraced.npz")
    sim = _sim(dump, False)
    state = _state_after_a_phase(sim)
    assert state.pool.bx == () and state.pool.bk == () and state.pool.bw == ()
    sim.save_checkpoint(ck, 1, state)
    _, got = _sim(dump, False).load_checkpoint(ck)
    assert got.pool.bx == () and got.pool.bk == () and got.pool.bw == ()
    with np.load(ck) as dat:
        assert not any(k.startswith(("pool.bx", "pool.bk", "pool.bw")) for k in dat.files)


def test_sharded_simulation_refuses_the_trace(dump):
    cfg = profiles.bench_config(pool=POOL, dtype=torch.float64)._replace(trace_birth=True)
    with pytest.raises(ValueError, match="trace_birth"):
        sharding.ShardedSimulation(dump, photon_n=8, config=cfg, device="cpu")


def _jax_tool_keys():
    """The keys of the JAX replay tool's JSON object (its ``out[...]`` and
    the literal it starts from), read from its source."""
    with open(os.path.join(ROOT, "tools", "replay_deep_tau.py")) as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "out" and isinstance(node.value, ast.Dict)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and node.value.id == "out" and isinstance(node.ctx, ast.Store)):
            keys.add(node.slice.value)
    return keys


def test_replay_tool_on_the_cpu(tmp_path):
    path = str(tmp_path / "replay.json")
    replay_deep_tau.main(["--device", "cpu", "--bench-profile", "--photons", "8",
                          "--pool", "256", "--mass-unit", "4e19", "--json", path])
    with open(path) as f:
        out = json.load(f)
    want = _jax_tool_keys()
    assert len(want) >= 15 and want <= out.keys(), want - out.keys()
    k = np.asarray(out["mt_birth_k"])
    assert k.shape == (4,) and np.isfinite(k).all() and k[0] > 0.0
    assert out["mt_birth_w"] > 0.0 and out["mt_birth_n_e"] > 0.0
    assert out["verdict"] in (
        "true-tail (replay reproduces the depth)",
        "true-tail (nominal-step engine reaches comparable depth; per-photon replay "
        "non-probative on chaotic near-orbit trajectories)",
        "stepping-artifact-suspected")
    assert [r["seed"] for r in out["replays"]] == [130, 224, 626]
    runs = out["runs"]
    assert runs["engine"]["grow_caps"] == {"wave": 8.0, "tail": 16.0}
    assert runs["nominal"]["grow_caps"] == {"wave": 1.0, "tail": 16.0}
    assert out["device"]["platform"] == "cpu" and out["dtype"] == "float32"
