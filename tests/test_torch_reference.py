"""Reference semantics (``EngineConfig.reference``) in the port, against the
JAX package at its defaults, on the 64x32 synthetic torus (CPU).

(a) Hot-chain parity: a JAX ``Simulation`` at the JAX ``EngineConfig``
    defaults (reference semantics) with ``vmem_gather=True``, so the Pallas
    row gather runs in interpret mode inside the chain, at small widths in
    float64, runs one full periodic phase; its state is carried into the
    port (``convert``) and both sides run 8 hot steps, the port fed the
    uniforms the JAX engine draws.  Pools and counters agree field by
    field: masks and integers exactly, floats to rtol 1e-10 (absolute floor
    1e-12 of the field's largest magnitude).
(b) End to end: the port's ``Simulation`` with ``profiles.reference_config``
    at the cell of tests/test_spectrum_regression.py (photon_n=180,
    M=4e18, seed 123, pool 256, m_period 8); its luminosity lies in the
    golden band of tests/golden/spectrum_torus64x32.json (max(3.5 sigma,
    5%)), and the spectrum's photon count equals n_recorded.  The step cap
    is cut to 5000 to bound the CPU drain; the weight it kills must stay
    below 1e-6 of the recorded weight.
(c) The rejection emission sampler against JAX's on the same zones, in
    distribution: the means of ln E and |cos theta| (tetrad-frame energy
    and direction) to 5 combined standard errors, and a two-sample
    Kolmogorov-Smirnov test of each at p > 1e-4, on 20,000 photons.
(d) ``Simulation`` runs on the card unless the caller asks for the CPU.
"""

import inspect
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats
import torch
from jax import random

from grmonty_tpu.models import torus as jtorus
from grmonty_tpu.transport import driver as jdriver
from grmonty_tpu.transport import engine as jengine
from grmonty_tpu_torch import consts, convert
from grmonty_tpu_torch.models import harm, torus
from grmonty_tpu_torch.ops import emission, fluid
from grmonty_tpu_torch.transport import driver, engine, profiles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "spectrum_torus64x32.json")
POOL = 1024


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    if ref.dtype.kind in "bi":
        assert np.array_equal(got.astype(ref.dtype), ref), what
        return
    fin = np.isfinite(ref)
    scale = np.abs(ref[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12 * scale, err_msg=what)


def test_reference_hot_chain_matches_jax(tmp_path):
    path = str(tmp_path / "torus")
    jtorus.write_torus_dump(path, n1=64, n2=32)
    jcfg = jengine.EngineConfig(n_pool=POOL, m_period=8, sec_cap=4 * POOL, ev_k=POOL // 2,
                                vmem_gather=True, dtype=jnp.float64)
    jsim = jdriver.Simulation(path, photon_n=2000, mass_unit=4e19, config=jcfg, warmup=0)
    plan = jsim.plan()
    backlog = jsim.emit_packed(plan, 0, 4 * POOL)
    eng = jsim.engine
    state = jax.jit(eng["periodic_phase"])(eng["fresh_state"](random.PRNGKey(3)), backlog)
    assert int(state.pool.occupied.sum()) > POOL // 4

    pcfg = convert.from_jax_config(jcfg)
    assert pcfg.reference and pcfg.grow_cap == 1.0
    mc = fluid.make_model_consts(harm.read_dump(path, 4e19))
    port = engine.Engine(mc, pcfg, convert.from_jax_engine_tables(jsim._engine_tabs),
                         torch.device("cpu"), torch.Generator())
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
    assert pstate.it == int(state.it) and int(ref.counters.ls_committed) > 0
    # arrivals park at_event under reference semantics
    assert bool(ref.pool.at_event.any()) and not bool(pstate.pool.ev_pending.any())


def test_reference_end_to_end_luminosity_in_golden_band(tmp_path):
    path = str(tmp_path / "torus")
    torus.write_torus_dump(path, n1=64, n2=32)
    cfg = profiles.reference_config(pool=256, dtype=torch.float64, stall_steps=5000)
    cfg = cfg._replace(m_period=8, sec_cap=4096)
    kw = dict(profiles.reference_sim_kwargs(256), emit_chunk=2048)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # 256-lane tensors: threads only add overhead
    try:
        sim = driver.Simulation(path, photon_n=180, mass_unit=4.0e18, seed=123, config=cfg,
                                device="cpu", **kw)
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
    assert stats["n_secondary_dropped"] == 0 and stats["w_stall_frac"] < 1e-6
    assert stats["hot_iters"] > 0 and stats["device_s"] is None


def _tetrad_frame(k, e_cov):
    """(ln E, cos theta) of photons from coordinate momenta (N, 4) and
    their zones' covariant tetrads (N, 4, 4)."""
    k_tet = np.einsum("nmj,nj->nm", e_cov, k)
    return np.log(k_tet[:, 0]), k_tet[:, 1] / k_tet[:, 0]


def test_rejection_sampler_matches_jax(tmp_path):
    path = str(tmp_path / "torus")
    jtorus.write_torus_dump(path, n1=64, n2=32)
    jcfg = jengine.EngineConfig(n_pool=256, m_period=8, sec_cap=1024)
    jsim = jdriver.Simulation(path, photon_n=2000, mass_unit=4e19, config=jcfg, warmup=0)
    plan = jsim.plan()
    n = 20000
    zi = np.resize(plan.zone_i, n).astype(np.int32)
    zj = np.resize(plan.zone_j, n).astype(np.int32)
    jb = jsim._sample_jit(random.PRNGKey(8), jnp.asarray(zi), jnp.asarray(zj))

    psim = driver.Simulation(path, photon_n=2000, mass_unit=4e19, device="cpu",
                             config=profiles.reference_config(pool=256, dtype=torch.float64))
    zflat = torch.as_tensor(zi.astype(np.int64) * psim.mc.n2 + zj)
    gen = torch.Generator()
    gen.manual_seed(8)
    rows = emission.sample_photons(gen, zflat, psim._zone_tabs, psim.host["f_t"],
                                   torch.float64).numpy()
    e_cov = psim._zone_tabs.e_cov[zflat].numpy()
    live_j, live_p = np.asarray(jb.w) > 0.0, rows[:, engine.ROW_W] > 0.0
    assert live_p.mean() > 0.9 and abs(live_j.mean() - live_p.mean()) < 0.01
    np.testing.assert_allclose(rows[:, :4], np.asarray(jb.x), rtol=1e-12)
    jl, jc = _tetrad_frame(np.asarray(jb.k)[live_j], e_cov[live_j])
    pl, pc = _tetrad_frame(rows[live_p, 4:8], e_cov[live_p])
    for what, a, b in (("ln E", jl, pl), ("|cos theta|", np.abs(jc), np.abs(pc))):
        se = math.sqrt(a.var() / a.size + b.var() / b.size)
        assert abs(a.mean() - b.mean()) <= 5.0 * se, (what, a.mean(), b.mean(), se)
        assert scipy.stats.ks_2samp(a, b).pvalue > 1e-4, what


def test_simulation_runs_on_the_card_by_default():
    assert inspect.signature(driver.Simulation).parameters["device"].default == "cuda"
