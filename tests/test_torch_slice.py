"""The port's slice as a whole, on the 64x32 synthetic torus (CPU).

(a) Hot-chain parity: a JAX ``Simulation`` with the shipped profile's
    physics knobs at small widths, float64, runs one full periodic phase;
    its state is carried into the port (``convert``) and both sides run 8
    hot steps, the port fed the uniforms the JAX engine draws.  Pools and
    counters agree field by field: masks and integers exactly, floats to
    rtol 1e-10 (absolute floor 1e-12 of the field's largest magnitude);
    with the live bias feedback, and with the bias frozen on both sides.
(b) End to end: the port's ``Simulation`` at photon_n=180, M=4e18, through
    the whole schedule (the host pilot, the waves, the tail cascade); its
    luminosity lies in the golden band of tests/golden/spectrum_torus64x32.json
    (the gate of tests/test_spectrum_regression.py: max(3.5 sigma, 5%)), and
    the spectrum's photon count equals n_recorded.
(c) The port imports with JAX and the JAX package blocked, every module
    (the command line and the native tracker's binding among them).
"""

import json
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax import random

from grmonty_tpu.models import torus as jtorus
from grmonty_tpu.transport import driver as jdriver
from grmonty_tpu.transport import engine as jengine
from grmonty_tpu_torch import consts, convert
from grmonty_tpu_torch.models import harm, torus
from grmonty_tpu_torch.ops import fluid
from grmonty_tpu_torch.transport import driver, engine, profiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "spectrum_torus64x32.json")
POOL = 1024


def _port_cfg(dtype=torch.float64, **over):
    cfg = profiles.bench_config(pool=POOL, dtype=dtype)
    return cfg._replace(sec_cap=4 * POOL, ev_k=POOL // 4, refill_k=POOL // 2,
                        light_k=POOL // 4, **over)


def _jax_cfg(c):
    return jengine.EngineConfig(
        n_pool=c.n_pool, m_period=c.m_period, sec_cap=c.sec_cap, stall_steps=c.stall_steps,
        fp_iters=engine.FP_ITERS, ev_k=c.ev_k, refill_k=c.refill_k, light_k=c.light_k,
        refill_period=c.refill_period, grow_cap=c.grow_cap,
        grow_tau_cap=engine.GROW_TAU_CAP, step_ctrl=engine.STEP_CTRL,
        bias_ema=engine.BIAS_EMA, detached_events=True, derived_fluid=True,
        bias_fixed_tau=c.bias_fixed_tau, bias_fixed_avg=c.bias_fixed_avg, dtype=jnp.float64)


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.dtype.kind in "bi":
        assert np.array_equal(got.astype(ref.dtype), ref), what
        return
    fin = np.isfinite(ref)
    scale = np.abs(ref[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * scale, err_msg=what)


def test_hot_chain_matches_jax(tmp_path):
    _hot_chain(tmp_path, _port_cfg())


def test_hot_chain_matches_jax_under_a_frozen_bias(tmp_path):
    """The same chain with both engines' bias normalization pinned (the
    accuracy gate's frozen-bias mode): the hot step's bias scale is the
    constant, on both sides."""
    _hot_chain(tmp_path, _port_cfg(bias_fixed_tau=0.0025, bias_fixed_avg=2.6))


def _hot_chain(tmp_path, pcfg):
    path = str(tmp_path / "torus")
    jtorus.write_torus_dump(path, n1=64, n2=32)
    jsim = jdriver.Simulation(path, photon_n=2000, mass_unit=4e19, config=_jax_cfg(pcfg),
                              cdf_sampler=True, emit_stride=True, warmup=0)
    plan = jsim.plan()
    backlog = jsim.emit_packed(plan, 0, 4 * POOL)
    eng = jsim.engine
    state = jax.jit(eng["periodic_phase"])(eng["fresh_state"](random.PRNGKey(3)), backlog)
    assert int(state.pool.occupied.sum()) > POOL // 4

    mc = fluid.make_model_consts(harm.read_dump(path, 4e19))
    tabs = convert.from_jax_engine_tables(jsim._engine_tabs)
    gen = torch.Generator()
    port = engine.Engine(mc, pcfg, tabs, torch.device("cpu"), gen)
    pstate = convert.from_jax_state(state)

    hot = jax.jit(eng["hot_step"])
    for _ in range(8):
        _, k_roul, k_x1 = random.split(state.key, 3)
        u_roul = np.array(random.uniform(k_roul, (POOL,), jnp.float64))
        u_x1 = np.array(random.uniform(k_x1, (POOL,), jnp.float64))
        state = hot(state)
        pstate = port.hot_step(pstate, u_roul=torch.as_tensor(u_roul),
                               u_x1=torch.as_tensor(u_x1))
    ref = convert.from_jax_state(state)
    for name in engine.Pool._fields:
        g, r = getattr(pstate.pool, name), getattr(ref.pool, name)
        for i, (gc, rc) in enumerate(zip(g, r) if isinstance(g, tuple) else [(g, r)]):
            _close(gc.numpy(), rc.numpy(), f"pool.{name}[{i}]")
    for name in engine.Counters._fields:
        _close(getattr(pstate.counters, name).numpy(), getattr(ref.counters, name).numpy(),
               f"counters.{name}")
    moved = int(ref.counters.ls_committed)
    assert pstate.it == int(state.it) and moved > 0


def test_end_to_end_luminosity_in_golden_band(tmp_path):
    path = str(tmp_path / "torus")
    torus.write_torus_dump(path, n1=64, n2=32)
    # step caps cut to 5000 to bound the CPU drain; no photon reaches them
    cfg = _port_cfg(stall_steps=5000)
    kw = profiles.bench_sim_kwargs(POOL)
    kw["tail_stall_steps"] = 5000
    sim = driver.Simulation(path, photon_n=180, mass_unit=4.0e18, seed=123, config=cfg,
                            device="cpu", **kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # 1024-lane tensors: threads only add overhead
    try:
        spec, stats = sim.run()
    finally:
        torch.set_num_threads(threads)
    with open(GOLDEN) as f:
        gold = json.load(f)
    nb = consts.N_TH_BINS * consts.N_E_BINS
    lum = float(spec[:nb, 1].sum())
    tol = max(3.5 * gold["luminosity_std"], 0.05 * abs(gold["luminosity_mean"]))
    assert abs(lum - gold["luminosity_mean"]) <= tol, (lum, gold["luminosity_mean"], tol)
    assert np.isfinite(spec).all()
    assert spec[:, 2].sum() == stats["n_recorded"] > 0
    assert stats["n_secondary_dropped"] == 0 and stats["n_stall_killed"] == 0
    assert stats["hot_iters"] > 0 and stats["device_s"] is None
    rows = sim.report(str(tmp_path / "spectrum"))
    with open(tmp_path / "spectrum") as f:
        lines = f.read().splitlines()
    assert len(lines) == consts.N_E_BINS and len(lines[0].split()) == 1 + 6 * 6
    assert rows["luminosity"] > 0


def test_port_imports_without_jax():
    import grmonty_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(grmonty_tpu_torch.__path__,
                                                   "grmonty_tpu_torch.")]
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'grmonty_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            f"import importlib\nfor n in {names!r}:\n    importlib.import_module(n)\n"
            "assert not any(m.split('.')[0] in ('jax', 'grmonty_tpu') for m in sys.modules)\n"
            "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.startswith("ok"), out.stderr
    assert len(names) >= 20
    assert {"grmonty_tpu_torch.cli", "grmonty_tpu_torch.__main__",
            "grmonty_tpu_torch.transport.oracle_native",
            "grmonty_tpu_torch.utils.logging"} <= set(names)
    for mod in names:
        src = open(sys.modules[mod].__file__ if mod in sys.modules else
                   __import__(mod, fromlist=["_"]).__file__).read()
        assert "import jax" not in src and "grmonty_tpu." not in src, mod
