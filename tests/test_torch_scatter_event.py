"""The event phase's scatter event: the counter-based draws, the plain event
on them against the JAX package's, the wrapper, and the CUDA kernel.

* ``draws.PhiloxDraws`` is the plain version of the kernel's generator:
  its raw words must equal ``numpy.random.Philox``'s (the first four words
  at counter c are the words at c + 1), and its uniforms and normals must
  have the right range and moments.
* The plain event (``scattering.scatter_event_c``) drawing from
  ``PhiloxDraws`` against the JAX ``scatter_event_c`` (threefry) in
  distribution, float64 on the CPU, at the tolerance of
  tests/test_torch_samplers.py: the means of ``e_sec`` and ``k_sec^0`` to 5
  combined standard errors, their 99th percentiles by rank (each side's
  within the other's at 0.99 -/+ 5 sqrt(2 p (1 - p) / n)), and the made and
  sampled fractions to 5 binomial standard errors; the guarded and inactive
  lanes' masks exactly.
* ``Engine.process_scatters`` on the CPU through ``hot_kernels.
  scatter_event`` equals the same phase calling the plain event directly.
* On the card (``-m cuda``, ``--noconftest``): the kernels against the plain
  version on ``PhiloxDraws`` under the same key (``hot_kernels.
  compare_event``), and the raw words bitwise.

JAX is imported inside the tests that compare with it.
"""

import math
import os

import numpy as np
import pytest
import torch

from grmonty_tpu_torch.models import torus
from grmonty_tpu_torch.ops import draws, fluid, geometry, proba, scattering, tetrads
from grmonty_tpu_torch.transport import driver, engine, hot_kernels

Z = 5.0
KEYS = [(0, 0), (0x0123456789ABCDEF, 0x7EDCBA9876543210), (2**64 - 1, 12345)]


def _numpy_words(key, ctr):
    """numpy.random.Philox's words at counter ``ctr`` (four uint64) under ``key``."""
    c = sum(int(w) << (64 * j) for j, w in enumerate(ctr)) - 1
    bg = np.random.Philox(key=np.array(key, dtype=np.uint64), counter=np.array(
        [(c >> (64 * j)) & (2**64 - 1) for j in range(4)], dtype=np.uint64))
    return bg.random_raw(4)


@pytest.mark.parametrize("key", KEYS, ids=["zero", "mixed", "top"])
def test_philox_words_match_numpy(key):
    rng = np.random.default_rng(1)
    ctr = rng.integers(0, 2**63 - 1, (40, 4), dtype=np.int64)
    ctr[:6] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1], [-1, -1, 5, 0],
               [7, 2**40, 3, 2]]
    key_t = torch.tensor([k - 2**64 if k >= 2**63 else k for k in key], dtype=torch.int64)
    before = dict(hot_kernels.launches)
    got = hot_kernels.philox_words(torch.as_tensor(ctr), key_t).numpy().view(np.uint64)
    assert hot_kernels.launches == before
    for c, row in zip(ctr.view(np.uint64), got):
        np.testing.assert_array_equal(row, _numpy_words(key, c))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_philox_uniforms_and_normals(dtype):
    n = 50000
    src = draws.PhiloxDraws((99, 7))
    like = torch.zeros(n, dtype=dtype)
    x1, nrm, u_y, u_mu, u_kn = src.electron_round(3, like)
    u = torch.cat([x1, u_y, u_mu, u_kn]).double()
    assert bool(((u >= 0.0) & (u < 1.0)).all())
    bits = 24 if dtype == torch.float32 else 53
    assert bool((u * 2.0**bits == torch.floor(u * 2.0**bits)).all())
    m = u.numel()
    assert abs(float(u.mean()) - 0.5) < Z * math.sqrt(1.0 / 12.0 / m)
    assert abs(float(u.var()) - 1.0 / 12.0) < Z * math.sqrt(1.0 / 180.0 / m)
    z = nrm.double().flatten()
    m = z.numel()
    assert abs(float(z.mean())) < Z / math.sqrt(m)
    assert abs(float(z.var()) - 1.0) < Z * math.sqrt(2.0 / m)
    assert abs(float((z**4).mean()) - 3.0) < Z * math.sqrt(96.0 / m)
    # other rounds, samplers and lanes draw other numbers
    assert not torch.equal(src.electron_round(4, like)[0], x1)
    assert not torch.equal(src.pair_round(draws.KLEIN_NISHINA, 3, like)[0], x1)
    assert not torch.equal(x1[1:], x1[:-1])


def _kerr_lanes(n, theta_e, k0, seed):
    """(k, fl, g7, b_unit) as numpy float64 at one point of the Kerr metric:
    a moving fluid with a field, and null wave vectors of tetrad-frame
    energy near ``k0`` in random directions."""
    x1, x2, a, h = 2.0, 0.4, 0.9375, 0.3
    t = lambda v: torch.full((n,), v, dtype=torch.float64)  # noqa: E731
    g7 = np.stack([c.numpy() for c in geometry.gcov_c(t(x1), t(x2), a, h, 0.0)])
    g00, g01, g03, g11, g13, g22, g33 = g7

    def lower(v):
        return np.stack([g00 * v[0] + g01 * v[1] + g03 * v[3], g01 * v[0] + g11 * v[1] + g13 * v[3],
                         g22 * v[2], g03 * v[0] + g13 * v[1] + g33 * v[3]])

    def future_null(v1, v2, v3):
        b = g01 * v1 + g03 * v3
        c = g11 * v1 * v1 + 2.0 * g13 * v1 * v3 + g22 * v2 * v2 + g33 * v3 * v3
        return (-b - np.sqrt(b * b - g00 * c)) / g00

    # a timelike 4-velocity: spatial part, then u^0 from u.u = -1
    us = np.array([0.05, 0.02, 0.1])
    b_ = g01 * us[0] + g03 * us[2]
    c_ = g11 * us[0] ** 2 + 2 * g13 * us[0] * us[2] + g22 * us[1] ** 2 + g33 * us[2] ** 2 + 1.0
    u0 = (-b_ - np.sqrt(b_ * b_ - g00 * c_)) / g00
    u_con = np.stack([u0, *[np.full(n, v) for v in us]])
    b_con = np.stack([np.full(n, v) for v in (0.01, 0.2, 0.05, 0.3)])
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    r = math.exp(x1)
    kv = np.stack([np.zeros(n), d[0] / r, d[1] / (math.pi * r), d[2] / r])
    kv[0] = future_null(kv[1], kv[2], kv[3])
    e_fluid = -(lower(kv) * u_con).sum(0)  # the energy in the fluid frame
    k = kv * (k0 / e_fluid)
    fl = dict(n_e=np.full(n, 1e5), theta_e=np.full(n, theta_e), b=np.full(n, 40.0),
              u_con=u_con, u_cov=lower(u_con), b_con=b_con, b_cov=lower(b_con))
    return k, fl, g7, 400.0


def _port_fl(fl):
    t = lambda v: torch.as_tensor(v)  # noqa: E731
    return fluid.FluidC(t(fl["n_e"]), t(fl["theta_e"]), t(fl["b"]),
                        *(tuple(t(c) for c in fl[f]) for f in ("u_con", "u_cov", "b_con", "b_cov")))


def _jax_event(k, fl, g7, b_unit, active=None, force=None, seed=3):
    import jax.numpy as jnp
    from jax import random

    from grmonty_tpu.ops import fluid as jfluid
    from grmonty_tpu.ops import scattering as jsc

    j = lambda v: jnp.asarray(v)  # noqa: E731
    jfl = jfluid.FluidC(j(fl["n_e"]), j(fl["theta_e"]), j(fl["b"]),
                        *(tuple(j(c) for c in fl[f]) for f in ("u_con", "u_cov", "b_con", "b_cov")))
    res = jsc.scatter_event_c(random.PRNGKey(seed), tuple(j(c) for c in k), jfl,
                              tuple(j(c) for c in g7), b_unit,
                              active=None if active is None else j(active),
                              force=None if force is None else j(force))
    return {f: np.asarray(getattr(res, f)) for f in ("parent_die", "made", "sampled", "e_sec")} | {
        "k_sec0": np.asarray(res.k_sec[0])}


def _port_event(k, fl, g7, b_unit, active=None, force=None, key=(5, 6)):
    res = hot_kernels.scatter_event(tuple(torch.as_tensor(c) for c in k), _port_fl(fl),
                                    tuple(torch.as_tensor(c) for c in g7), b_unit,
                                    None if active is None else torch.as_tensor(active),
                                    None if force is None else torch.as_tensor(force),
                                    key=torch.tensor(key))
    return {f: getattr(res, f).numpy() for f in ("parent_die", "made", "sampled", "e_sec")} | {
        "k_sec0": res.k_sec[0].numpy(), "rounds_el": res.rounds_el.numpy(),
        "rounds_sc": res.rounds_sc.numpy()}


def _same_mean_and_q99(a, b, what):
    se = math.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) <= Z * se + 1e-12 * abs(a.mean()), (
        f"{what}: means {a.mean()} vs {b.mean()} (se {se})")
    p = 0.99
    dp = Z * math.sqrt(2.0 * p * (1.0 - p) / min(a.size, b.size))
    for x, y in ((a, b), (b, a)):
        q = np.quantile(y, p)
        lo, hi = np.quantile(x, p - dp), np.quantile(x, min(p + dp, 1.0))
        assert lo <= q <= hi, f"{what}: q99 {q} outside [{lo}, {hi}]"


def _same_fraction(fa, fb, n, what):
    p = 0.5 * (fa + fb)
    se = math.sqrt(2.0 * p * (1.0 - p) / n) + 1e-12
    assert abs(fa - fb) <= Z * se, f"{what}: fractions {fa} vs {fb}"


@pytest.mark.parametrize("theta_e", [0.5, 8.0])
@pytest.mark.parametrize("k0", [1e-6, 1e-2])
def test_event_on_philox_matches_jax_in_distribution(theta_e, k0):
    n = 16000
    k, fl, g7, b_unit = _kerr_lanes(n, theta_e, k0, seed=11)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = _port_event(k, fl, g7, b_unit)
    finally:
        torch.set_num_threads(threads)
    jx = _jax_event(k, fl, g7, b_unit)
    for f in ("made", "sampled"):
        _same_fraction(jx[f].mean(), port[f].mean(), n, f"{f} at theta_e {theta_e}, k0 {k0}")
    assert port["sampled"].mean() > 0.5
    ok_j, ok_p = jx["made"] & jx["sampled"], port["made"] & port["sampled"]
    for f in ("e_sec", "k_sec0"):
        _same_mean_and_q99(jx[f][ok_j], port[f][ok_p], f"{f} at theta_e {theta_e}, k0 {k0}")
    # the kernel's round counts: within the caps, on every (unguarded) lane
    assert port["rounds_el"].min() >= 1 and port["rounds_el"].max() <= proba._ELECTRON_CAP_DEFER
    assert port["rounds_sc"].min() >= 1 and port["rounds_sc"].max() <= proba._KN_CAP_DEFER


def test_guarded_and_inactive_lanes_give_the_jax_masks():
    n = 400
    k, fl, g7, b_unit = _kerr_lanes(n, 3.0, 1e-3, seed=12)
    kind = np.arange(n) % 8
    k[0] = np.where(kind == 0, -k[0], k[0])  # flying backwards: a doomed parent
    k[0] = np.where(kind == 1, 2.0e5, k[0])
    k[0] = np.where(kind == 2, np.nan, k[0])
    k[1] = np.where(kind == 3, np.nan, k[1])
    k[3] = np.where(kind == 4, np.nan, k[3])
    k[0] = np.where(kind == 5, 1e-4 * k[0], k[0])  # spacelike: some in an invalid frame
    active = kind != 6
    force = kind == 7
    fl["b"] = np.where(np.arange(n) % 3 == 0, 0.0, fl["b"])  # unmagnetised: the x1 axis
    jx = _jax_event(k, fl, g7, b_unit, active=active, force=force)
    port = _port_event(k, fl, g7, b_unit, active=active, force=force)
    np.testing.assert_array_equal(port["parent_die"], jx["parent_die"])
    guard = jx["parent_die"] | ~active | (kind == 5)
    assert jx["parent_die"].sum() >= 5 * n // 8 - 1
    for f in ("parent_die", "made", "sampled"):
        np.testing.assert_array_equal(port[f][guard], jx[f][guard], err_msg=f)
    assert (port["rounds_el"][jx["parent_die"] | ~active] == 0).all()
    # forced lanes always consume their event
    assert port["sampled"][force].all()


@pytest.fixture(scope="module")
def cpu_sim(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dump") / "torus")
    torus.write_torus_dump(path, n1=64, n2=32)
    cfg = engine.EngineConfig(n_pool=256, m_period=8, sec_cap=512, dtype=torch.float64)
    return driver.Simulation(path, photon_n=100, mass_unit=4e19, config=cfg, device="cpu",
                             emit_chunk=256, warmup=0)


def _event_pool(eng, seed):
    """A pool whose lanes hold the synthetic events of ``seed``: half of them
    parked at their event, a quarter in the detached-event registers."""
    n = eng.cfg.n_pool
    ev = hot_kernels.synthetic_events(eng, n, seed)
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    where = rng.random(n)
    at_event, pending = t(where < 0.5), t((where >= 0.5) & (where < 0.75))
    dt = eng.dt
    pool = engine.empty_pool(n, dt, "cpu")._replace(
        x=ev.x, k=ev.k, ev_x=ev.x, ev_k=ev.k, occupied=t(where < 0.9), alive=t(where < 0.85),
        at_event=at_event, ev_pending=pending, ev_tries=ev.tries,
        w=t(rng.uniform(1.0, 2.0, n)).to(dt), sec_w=t(rng.uniform(0.1, 1.0, n)).to(dt),
        ev_w=t(rng.uniform(0.1, 1.0, n)).to(dt), n_e_0=t(rng.uniform(1.0, 2.0, n)).to(dt),
        theta_e_0=t(rng.uniform(1.0, 5.0, n)).to(dt), e_0=t(rng.uniform(1.0, 2.0, n)).to(dt))
    sec = engine.SecBuf(rows=torch.zeros((eng.cfg.sec_cap, engine.ROW_WIDTH), dtype=dt),
                        count=torch.tensor(3, dtype=torch.int64))
    return pool, sec, engine.init_counters(1e-3, dt, "cpu")


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b, strict=True))
    if a is None:
        return b is None
    return bool(torch.equal(a, b) or (a.dtype.is_floating_point and torch.allclose(
        a, b, rtol=0.0, atol=0.0, equal_nan=True)))


def test_process_scatters_through_the_wrapper_equals_the_plain_call(cpu_sim, monkeypatch):
    """The full phase's events run through one call of the event phase's
    wrapper, whose event draws from the engine's generator: the same pool,
    ring and counters, and the same draws, as the plain event phase on that
    generator."""
    eng = cpu_sim.engine
    pool, sec, counters = _event_pool(eng, 21)
    eng.gen.manual_seed(4)
    state = eng.gen.get_state()
    calls = []
    wrapper = hot_kernels.event_phase

    def counted(*a, **kw):
        calls.append(1)
        return wrapper(*a, **kw)

    monkeypatch.setattr(hot_kernels, "event_phase", counted)
    got = eng.process_scatters(pool, sec, counters, eng._bias_den(counters))
    after = eng.gen.get_state()
    assert calls == [1]

    eng.gen.set_state(state)

    def plain(p, c, sel, room, wedged, den, mc, tables, gen=None, key=None):
        assert key is None and gen is eng.gen
        return engine.event_phase_plain(p, c, sel, room, wedged, den, mc, tables, gen)

    monkeypatch.setattr(hot_kernels, "event_phase", plain)
    want = eng.process_scatters(pool, sec, counters, eng._bias_den(counters))
    assert torch.equal(eng.gen.get_state(), after)
    for a, b in zip(got, want, strict=True):
        for f in a._fields:
            assert _same(getattr(a, f), getattr(b, f)), f
    # the phase consumed events and made secondaries
    assert int(want[1].count) > 3 and int(want[2].n_sec_drop) == 0


def test_wrapper_takes_exactly_one_draw_source(cpu_sim):
    ev = hot_kernels.synthetic_events(cpu_sim.engine, 8, 1)
    args = (ev.k, ev.fl, ev.g7, cpu_sim.mc.b_unit, ev.active, ev.force)
    for kw in ({}, {"gen": cpu_sim.gen, "key": torch.tensor([1, 2])}):
        with pytest.raises(ValueError):
            hot_kernels.scatter_event(*args, **kw)
    with pytest.raises(ValueError):
        hot_kernels.scatter_chain(ev.k, ev.fl.theta_e)
    with pytest.raises(ValueError):
        hot_kernels.entry_point("scatter_event", torch.float16)
    assert hot_kernels.entry_point("scatter_event", torch.float64) == "scatter_event_f64"
    assert hot_kernels.entry_point("scatter_chain", torch.float32) == "scatter_chain"


def test_synthetic_events_reach_every_kind_of_lane(cpu_sim):
    ev = hot_kernels.synthetic_events(cpu_sim.engine, 4000, 2026)
    src = draws.PhiloxDraws((5, 9), margins=True)
    res = scattering.scatter_event_c(src, ev.k, ev.fl, ev.g7, cpu_sim.mc.b_unit,
                                     active=ev.active, force=ev.force)
    a = ev.active
    hot = res.rounds_sc > 0
    assert int((res.parent_die & a).sum()) > 100 and int((~a).sum()) > 200
    assert int((a & ~res.parent_die & ~res.made).sum()) > 0  # invalid frames
    assert int(ev.force.sum()) > 50 and int((ev.tries >= engine.EV_HALVE).sum()) > 200
    assert int((a & hot & (res.rounds_el > 1)).sum()) > 0
    assert int((a & ~res.sampled).sum()) > 0  # a deferred event
    assert int((res.rounds_sc >= 8).sum()) > 0
    # the margins are finite on the sampled lanes and none is NaN
    assert not bool(torch.isnan(src.margin).any())


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_sims(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    path = str(tmp_path_factory.mktemp("dump") / "torus")
    torus.write_torus_dump(path, n1=64, n2=32)
    return {dt: driver.Simulation(path, photon_n=100, mass_unit=4e19, device="cuda",
                                  config=engine.EngineConfig(n_pool=1024, m_period=8,
                                                             sec_cap=1024, dtype=dt),
                                  emit_chunk=256, warmup=0)
            for dt in (torch.float32, torch.float64)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 513, 16384])
def test_event_kernel_matches_plain_on_the_card(card_sims, dtype, n):
    sim = card_sims[dtype]
    ev = hot_kernels.synthetic_events(sim.engine, n, 77 + n)
    key = torch.tensor([n, 0xABCDEF], dtype=torch.int64, device="cuda")
    src = draws.PhiloxDraws(key, margins=True)
    ref = scattering.scatter_event_c(src, ev.k, ev.fl, ev.g7, sim.mc.b_unit, active=ev.active,
                                     force=ev.force)
    name = hot_kernels.entry_point("scatter_event", dtype)
    before = hot_kernels.launches[name]
    got = hot_kernels.scatter_event(ev.k, ev.fl, ev.g7, sim.mc.b_unit, ev.active, ev.force,
                                    key=key)
    torch.cuda.synchronize()
    assert hot_kernels.launches[name] == before + 1
    rec, fails, rows = hot_kernels.compare_event(name, ref, got, src.margin,
                                                 ev.active)
    assert not fails, (fails, rows)
    # the key drawn from a generator advances it, and the same state draws
    # the same event
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    one = hot_kernels.scatter_event(ev.k, ev.fl, ev.g7, sim.mc.b_unit, ev.active, ev.force,
                                    gen=gen)
    gen.manual_seed(3)
    two = hot_kernels.scatter_event(ev.k, ev.fl, ev.g7, sim.mc.b_unit, ev.active, ev.force,
                                    gen=gen)
    assert all(_same(getattr(one, f), getattr(two, f)) for f in one._fields)


# the event phase's widths, and both sides of each change of the lanes a
# warp (csrc/scatter_event.cu event_lanes: 1 up to 1,024 lanes, 8 up to 4,096)
EVENT_EDGES = (512, 1024, 1025, 4096, 4097, 16384)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", EVENT_EDGES)
def test_event_kernel_is_the_plain_event_bit_for_bit_at_every_deal(card_sims, dtype, n):
    """At every lanes-a-warp instance (the width's own, 32, 8 and 1) the
    kernel's masks and round counts equal the plain event's on PhiloxDraws
    on every active lane, its floats on the made and sampled lanes bit for
    bit, and every output is the same bits as the width's own instance."""
    sim = card_sims[dtype]
    ev = hot_kernels.synthetic_events(sim.engine, n, 2026)
    key = torch.tensor([0x5EED0000 + n, 0xC0FFEE], dtype=torch.int64, device="cuda")
    src = draws.PhiloxDraws(key, margins=True)
    ref = scattering.scatter_event_c(src, ev.k, ev.fl, ev.g7, sim.mc.b_unit, active=ev.active,
                                     force=ev.force)
    name = hot_kernels.entry_point("scatter_event", dtype)
    outs = {}
    for lanes in (None, 32, 8, 1):
        got = hot_kernels.scatter_event(ev.k, ev.fl, ev.g7, sim.mc.b_unit, ev.active, ev.force,
                                        key=key, lanes=lanes)
        torch.cuda.synchronize()
        rec, fails, rows = hot_kernels.compare_event(name, ref, got, src.margin, ev.active)
        assert not fails, (lanes, fails, rows)
        assert rec["lanes_differing"] == 0 and rec["max_abs_err"] == 0.0, (lanes, rec)
        outs[lanes] = hot_kernels._flat(got._asdict())
    shape = hot_kernels.event_shape(name, n)
    assert shape["lanes"] == (32 if n > 4096 else 8 if n > 1024 else 1)
    for lanes in (32, 8, 1):
        for f, a in outs[None].items():
            assert bool(hot_kernels._same_bits(a, outs[lanes][f]).all()), (lanes, f)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_chain_kernel_matches_plain_on_the_card(card_sims, dtype):
    n = 20000
    dev = torch.device("cuda")
    cell = torch.arange(n, device=dev) % 9
    th = torch.tensor([2.0, 8.0, 20.0], dtype=dtype, device=dev)[cell // 3]
    k0 = torch.tensor([1e-6, 1e-3, 1e-1], dtype=dtype, device=dev)[cell % 3]
    k_tet = (k0, k0.clone(), torch.zeros_like(k0), torch.zeros_like(k0))
    key = torch.tensor([17, 19], dtype=torch.int64, device=dev)
    src = draws.PhiloxDraws(key, margins=True)
    ref = scattering.scatter_chain_c(src, k_tet, th)
    got = hot_kernels.scatter_chain(k_tet, th, key=key)
    torch.cuda.synchronize()
    name = hot_kernels.entry_point("scatter_chain", dtype)
    rec, fails, rows = hot_kernels.compare_event(name, ref, got, src.margin)
    assert not fails, (fails, rows)
    assert rec["lanes_compared"] > 0.9 * n


@pytest.mark.cuda
def test_philox_words_bitwise_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    rng = np.random.default_rng(8)
    ctr = rng.integers(-2**63, 2**63 - 1, (4097, 4), dtype=np.int64)
    for key in KEYS:
        key_t = torch.tensor([k - 2**64 if k >= 2**63 else k for k in key], dtype=torch.int64)
        got = hot_kernels.philox_words(torch.as_tensor(ctr, device="cuda"), key_t.cuda())
        assert torch.equal(got.cpu(), hot_kernels.philox_words(torch.as_tensor(ctr), key_t))
        for c, row in zip(ctr[:16].view(np.uint64), got[:16].cpu().numpy().view(np.uint64)):
            np.testing.assert_array_equal(row, _numpy_words(key, c))
    assert os.path.exists(hot_kernels.CSRC_DIR)


# ---------------------------------------------------------------------------
# the card kernel's round selection, emulated on the CPU
# ---------------------------------------------------------------------------
#
# csrc/scatter_event.cu runs each rejection loop in passes over a warp's L
# lanes: the warp's 32 threads are dealt over the lanes still sampling
# (thread t runs round base + t // m of the (t % m)-th of the m live lanes),
# and each lane takes its lowest accepted round.  The emulation below
# evaluates the dealt (lane, round) pairs of every pass with the plain
# samplers' own per-round arithmetic (a draw source that gives each
# element its lane's words at its dealt round, the samplers at cap 1) and
# must pick the rounds, values and round counts of the sequential loops.

class _DealtDraws(draws.PhiloxDraws):
    """Philox draws for a batch of (lane, round) elements: a looping
    sampler's round ``it`` gives element e the words of (lane[e], sampler,
    rnd[e], block), a direction those of (lane[e], sampler, 0, 0); ``gap``
    keeps the last test's outcome (``accepted``: u < threshold)."""

    def __init__(self, key, lane, rnd):
        super().__init__(key)
        self.lane, self.rnd = lane, rnd
        self.accepted = None

    def _words(self, sampler, rnd, block, like, chunk=1):
        looping = sampler in (draws.ELECTRON, draws.KLEIN_NISHINA, draws.THOMSON)
        r = self.rnd if looping else torch.zeros_like(self.lane)
        ctr = [draws._word_limbs(v, self.lane) for v in (self.lane, sampler, r, block)]
        return draws.philox_limbs(ctr, self.key)

    def gap(self, u, thr, live):
        self.accepted = u < thr


def _passes(go, cap, evaluate, lanes_a_warp, deal=True):
    """The passes of one loop over warps of ``lanes_a_warp`` lanes: each
    pass the 32 threads of a warp are dealt over its lanes still sampling
    (``deal``), or each lane keeps its 32 // lanes_a_warp threads; a lane
    stops at its lowest accepted round or at its cap (``cap`` (N,)).
    ``evaluate(lane, rnd)`` -> (accepted (E,), values (E, ...)) for
    element pairs.  Returns (accepted, rounds, values, passes), the values
    of each lane's accepted round (else of its last round run)."""
    n = go.shape[0]
    base = [0] * n
    sampling = go.tolist()
    rounds, acc, vals = [0] * n, [False] * n, [None] * n
    passes = 0
    while any(sampling):
        passes += 1
        pairs = []
        for w0 in range(0, n, lanes_a_warp):
            own = range(w0, min(w0 + lanes_a_warp, n))
            live = [o for o in own if sampling[o]]
            if not live:
                continue
            for t in range(32):
                if deal:
                    src, off = live[t % len(live)], t // len(live)
                else:
                    src = w0 + t // (32 // lanes_a_warp)
                    off = t % (32 // lanes_a_warp)
                    if src >= n or not sampling[src]:
                        continue
                if base[src] + off < int(cap[src]):
                    pairs.append((src, base[src] + off))
        lane = torch.tensor([p[0] for p in pairs])
        rnd = torch.tensor([p[1] for p in pairs])
        ok, v = evaluate(lane, rnd)
        order = sorted(range(len(pairs)), key=lambda e: pairs[e])
        ran = {}
        for e in order:
            src, r = pairs[e]
            ran[src] = ran.get(src, 0) + 1
            if sampling[src] and bool(ok[e]):
                sampling[src], acc[src], rounds[src], vals[src] = False, True, r + 1, v[e]
            elif sampling[src]:
                vals[src] = v[e]
        for src, cnt in ran.items():
            if sampling[src]:
                base[src] = min(base[src] + cnt, int(cap[src]))
                if base[src] >= int(cap[src]):
                    sampling[src], rounds[src] = False, int(cap[src])
    return torch.tensor(acc), torch.tensor(rounds, dtype=torch.int32), vals, passes


def _chain_lanes(n, seed, dtype):
    """Tetrad-frame photons of energies 1e-8 ... 300 (cold lanes run the
    Thomson loop, hot ones Klein-Nishina; at the top the electron loop
    rarely accepts and forced lanes take their cap), theta_e 0.05 ... 20,
    a fifth forced and a sixth not sampling (guarded or inactive)."""
    rng = np.random.default_rng(seed)
    k0 = torch.as_tensor(10.0 ** rng.uniform(-8.0, 2.5, n), dtype=dtype)
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    k_tet = (k0, *(k0 * torch.as_tensor(c, dtype=dtype) for c in d))
    theta = torch.as_tensor(10.0 ** rng.uniform(-1.3, 1.3, n), dtype=dtype)
    force = torch.as_tensor(rng.random(n) < 0.2)
    go = torch.as_tensor(rng.random(n) >= 1.0 / 6.0)
    return k_tet, theta, force, go


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("warp", [(32, True), (8, True), (4, True), (1, True), (32, False),
                                  (16, False), (4, False), (1, False)],
                         ids=["deal32", "deal8", "deal4", "deal1", "g1", "g2", "g8", "g32"])
def test_round_passes_pick_the_sequential_rounds(dtype, warp):
    """The electron, Klein-Nishina and Thomson loops run in passes (the
    kernel's deal over L lanes a warp, or fixed groups of G = 32 / L
    threads) pick, on every sampling lane, the round the sequential plain
    loop stops at: the same values bit for bit and the same round counts,
    forced lanes at the cap included; lanes that do not sample run none."""
    lanes_a_warp, deal = warp
    n, key = 352, (0x5EED, 0xC0FFEE)
    k_tet, th, force, go = _chain_lanes(n, 2027, dtype)
    seq = draws.PhiloxDraws(key)
    p_seq, ok_seq = proba.sample_electron_distr_p_c(seq, k_tet, th, force=force)
    r_seq = seq.rounds["electron"]

    def rep(v, lane):
        return tuple(c[lane] for c in v) if isinstance(v, tuple) else v[lane]

    def electron(lane, rnd):
        src = _DealtDraws(key, lane, rnd)
        f = rep(force, lane) & (rnd == proba._ELECTRON_CAP_DEFER - 1)
        p, ok = proba.sample_electron_distr_p_c(src, rep(k_tet, lane), rep(th, lane), force=f,
                                                cap=1)
        return ok, list(zip(*p))

    cap = torch.full((n,), proba._ELECTRON_CAP_DEFER)
    ok, rounds, vals, passes_el = _passes(go, cap, electron, lanes_a_warp, deal)
    assert torch.equal(ok[go], ok_seq[go]) and torch.equal(rounds[go], r_seq[go])
    assert bool((rounds[~go] == 0).all())
    for i in torch.nonzero(go).flatten().tolist():
        assert all(_same(a, b[i]) for a, b in zip(vals[i], p_seq)), i
    # forced lanes at the cap, lanes that never accepted, lanes past a pass
    assert int((go & force & ok & (r_seq == proba._ELECTRON_CAP_DEFER)).sum()) > 0
    assert int((go & ~ok_seq).sum()) > 0 and passes_el >= 1
    assert int((go & (r_seq > 32 // lanes_a_warp)).sum()) > 0 or lanes_a_warp < 4

    # the second loop on the sequential electron: Klein-Nishina where hot
    ke = tetrads.boost_c(k_tet, p_seq)
    hot = ke[0] > 1.0e-4
    k0 = torch.clamp(ke[0], min=1.0e-4)
    seq = draws.PhiloxDraws(key)
    k0p_seq, okkn_seq = proba.sample_klein_nishina_c(seq, k0, force=force)
    rkn_seq = seq.rounds["klein_nishina"]
    seq = draws.PhiloxDraws(key)
    cth_seq = proba.sample_thomson(seq, ke[0])
    rth_seq = seq.rounds["thomson"]

    def second(lane, rnd):
        src = _DealtDraws(key, lane, rnd)
        h = hot[lane]
        f = force[lane] & (rnd == proba._KN_CAP_DEFER - 1)
        k0p, ok_kn = proba.sample_klein_nishina_c(src, k0[lane], force=f, cap=1)
        src = _DealtDraws(key, lane, rnd)
        c_th = proba.sample_thomson(src, ke[0][lane], cap=1)
        return torch.where(h, ok_kn, src.accepted), torch.where(h, k0p, c_th)

    cap = torch.where(hot, proba._KN_CAP_DEFER, proba._THOMSON_CAP)
    ok, rounds, vals, _ = _passes(go, cap, second, lanes_a_warp, deal)
    sel = go & hot
    assert torch.equal(ok[sel], okkn_seq[sel]) and torch.equal(rounds[sel], rkn_seq[sel])
    assert torch.equal(rounds[go & ~hot], rth_seq[go & ~hot])
    for i in torch.nonzero(go).flatten().tolist():
        if bool(hot[i]):
            want = k0p_seq[i] if bool(ok[i]) else k0[i]
        else:
            want = cth_seq[i]
            assert bool(ok[i]) == bool(cth_seq[i] != 0.0) or float(vals[i]) == 0.0
        got = vals[i] if bool(ok[i]) else (k0[i] if bool(hot[i]) else torch.zeros((), dtype=dtype))
        assert _same(got, want), i
    assert int((go & hot).sum()) > 0 and int((go & ~hot).sum()) > 0
    assert int((go & hot & (rkn_seq > 1)).sum()) > 0
    # the rounds the whole chain reports are these
    chain = scattering.scatter_chain_c(draws.PhiloxDraws(key), k_tet, th, force=force)
    assert torch.equal(chain.rounds_el[go], r_seq[go])
    assert torch.equal(chain.rounds_sc[go], torch.where(hot, rkn_seq, rth_seq)[go])


def test_round_passes_keep_the_lane_rules():
    """The pass selection on a made-up acceptance table: lanes that never
    accept (a Thomson lane keeps cos 0: no value taken), lanes that accept
    only at their cap (a forced lane), lanes of caps 16 and 128 side by
    side in a warp, and lanes that do not sample, under every deal: each
    takes its lowest accepted round, or its cap."""
    n = 96
    rng = np.random.default_rng(5)
    cap = torch.as_tensor(np.where(rng.random(n) < 0.5, 128, 16))
    table = torch.as_tensor(rng.random((n, 128)) < 0.05)
    never = torch.arange(n) % 7 == 0
    at_cap = torch.arange(n) % 7 == 1
    table[never] = False
    table[at_cap] = False
    table[at_cap, cap[at_cap] - 1] = True
    go = torch.arange(n) % 11 != 3
    first = torch.where(table.any(1), table.float().argmax(1), -1)
    first = torch.where(first >= cap, -1, first)

    def evaluate(lane, rnd):
        return table[lane, rnd], [float(r) for r in rnd]

    for lanes_a_warp in (32, 8, 4, 1):
        for deal in (True, False):
            ok, rounds, vals, _ = _passes(go, cap, evaluate, lanes_a_warp, deal)
            want_ok = go & (first >= 0)
            assert torch.equal(ok, want_ok)
            want_r = torch.where(first >= 0, first + 1, cap).to(torch.int32)
            assert torch.equal(rounds[go], want_r[go]) and bool((rounds[~go] == 0).all())
            assert all(vals[i] == float(first[i]) for i in torch.nonzero(want_ok).flatten())
            assert not bool(ok[never].any()) and bool((rounds[never & go] == cap[never & go]).all())


@pytest.mark.parametrize("kernel", ["scatter_event", "fresh_init"])
def test_phase_clock_stamps_find_every_anchor(kernel):
    """``tools/clock_phase_kernels`` stamps the event kernel and the track
    start at lines it must find: every segment's stamp (the track start's
    surface wait among them), the clock's start and the warps' count land
    in the source, and a source without an anchor raises."""
    from grmonty_tpu_torch.tools import clock_phase_kernels as clock

    with open(os.path.join(hot_kernels.CSRC_DIR, f"{kernel}.cu")) as f:
        src = f.read()
    out = clock.stamped(src, kernel)
    for k in range(len(clock.SEGMENTS[kernel])):
        assert f"STAMP({k}, " in out, k
    assert out.count("CLK_START();") == 1 and "CLK_WARP();" in out and "clk_read" in out
    with pytest.raises(ValueError, match="no anchor"):
        clock.stamped(src.replace("rounds_sc;\n}", "rounds_sc;\n }").replace(
            "P.bw[i] = w;\n  }\n}", "P.bw[i] = w;\n  }\n }"), kernel)
