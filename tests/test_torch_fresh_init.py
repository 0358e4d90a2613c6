"""Refill's sources and the track start of freshly loaded lanes
(``hot_kernels.refill_fresh``; ``engine.refill_sources_plain``,
``engine.init_fresh_plain``) and the event phase's fluid, opacities and bias
(``hot_kernels.event_fluid``, ``engine.event_fluid_plain``), on the 64x32
torus.

* Against JAX, float64 (CPU): a JAX engine of each semantics, with the
  birth-state trace off and on, runs two light phases (record, free,
  refill, the fresh-lane init: no random draw) from a fresh state, with
  zero-weight photons in the backlog (loaded, not valid; a NaN photon is
  not among them, because the JAX refill's one-hot transpose spreads a NaN
  over the whole row, its load flag too, so that JAX never loads it); each
  state is carried into the port (``convert.from_jax_state``) and the
  port's light phase agrees with JAX's on every pool field and counter to
  rtol 1e-10, the masks and integers exactly.
* ``engine.event_fluid_plain`` on seeded positions, null wave vectors,
  weights and defer counts equals the JAX engine's composition of
  ``grmonty_tpu.ops`` (``geometry.gcov_c``, ``fluid.get_fluid_params_c``,
  ``radiation.kinematics_sin_c``, ``alpha_inv_scatt_c``,
  ``alpha_inv_abs_sin_c``, its ``bias_func`` and the halved theta_e) in
  float64 to rtol 1e-10 (and atol 1e-300: XLA on the CPU flushes the
  denormal opacities of a few lanes to zero).
* On CPU tensors both wrappers are their plain versions bit for bit, the
  engine's phases call each once, and the card checks' comparisons
  (``hot_kernels.compare_fresh`` / ``compare``) pass a plain result and
  catch a changed kept lane.
* On the card (``cuda`` tests, ``python -m pytest --noconftest -m cuda
  tests/test_torch_fresh_init.py``): each kernel against its plain version
  at the path's widths in float32 and float64 and, for the track start, in
  both semantics with the birth state traced, on synthetic refill slots:
  the ring's count, the backlog position and n_created exactly,
  dk/dlambda, interacting and the birth state bit for bit, every lane
  outside the valid fresh set unchanged, the opacities and the bias (and
  every event-fluid output) at ``hot_kernels.KERNEL_TOLERANCE``.  JAX is imported inside fixtures, so
  these run where JAX is missing.
"""

import numpy as np
import pytest
import torch

from grmonty_tpu_torch import convert
from grmonty_tpu_torch.models import harm, torus
from grmonty_tpu_torch.ops import fluid
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

POOL = 256
RTOL = 1e-10
DENORMAL = 1e-300  # below it XLA on the CPU flushes results to zero
BAD_ROWS = (2, 5)  # backlog rows given zero weight: loaded, not valid


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
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0, err_msg=what)


def _assert_states_close(got, ref):
    for name in engine.Pool._fields:
        g, r = getattr(got.pool, name), getattr(ref.pool, name)
        assert isinstance(g, tuple) == isinstance(r, tuple), name
        pairs = list(zip(g, r, strict=True)) if isinstance(g, tuple) else [(g, r)]
        for i, (gc, rc) in enumerate(pairs):
            _close(gc.numpy(), rc.numpy(), f"pool.{name}[{i}]")
    for name in engine.Counters._fields:
        _close(getattr(got.counters, name).numpy(), getattr(ref.counters, name).numpy(),
               f"counters.{name}")
    _close(got.spec.numpy(), ref.spec.numpy(), "spec")


@pytest.fixture(scope="module", params=[(False, False), (False, True), (True, False),
                                        (True, True)],
                ids=["shipped", "shipped-trace", "reference", "reference-trace"])
def jax_side(request, dump):
    """A JAX engine of one semantics (float64, POOL lanes, the trace off or
    on), its jitted light phase, a fresh state and a backlog with two
    zero-weight photons; the port's engine of the same config on the same
    tables."""
    import jax
    import jax.numpy as jnp
    from jax import random

    from grmonty_tpu.transport import driver as jdriver
    from grmonty_tpu.transport import engine as jengine

    reference, trace = request.param
    physics = convert._REFERENCE if reference else convert._SHIPPED
    jcfg = jengine.EngineConfig(
        n_pool=POOL, m_period=16, sec_cap=4 * POOL, ev_k=POOL // 4, refill_k=POOL // 2,
        light_k=POOL // 4, refill_period=4, trace_birth=trace, dtype=jnp.float64,
        **({} if reference else {"grow_cap": 8.0}), **physics)
    pcfg = convert.from_jax_config(jcfg)
    assert pcfg.reference == reference and pcfg.trace_birth == trace
    jsim = jdriver.Simulation(dump, photon_n=2000, mass_unit=4e19, config=jcfg,
                              cdf_sampler=True, emit_stride=True, warmup=0)
    backlog = np.array(jsim.emit_packed(jsim.plan(), 0, 4 * POOL))
    backlog[list(BAD_ROWS), engine.ROW_W] = 0.0
    eng = jsim.engine
    mc = fluid.make_model_consts(harm.read_dump(dump, 4e19))
    port = engine.Engine(mc, pcfg, convert.from_jax_engine_tables(jsim._engine_tabs),
                         torch.device("cpu"), torch.Generator())
    return dict(light=jax.jit(eng["light_phase"]), fresh=eng["fresh_state"](random.PRNGKey(3)),
                backlog=jnp.asarray(backlog), port=port)


def test_light_phase_matches_jax(jax_side):
    """Two light phases: the first loads light_k lanes into an empty pool
    (two of them invalid), the second the next light_k beside lanes that
    keep their start; each of the port's agrees with JAX's from the same
    state."""
    light, port = jax_side["light"], jax_side["port"]
    backlog = torch.as_tensor(np.array(jax_side["backlog"]))
    s0 = jax_side["fresh"]
    s1 = light(s0, jax_side["backlog"])
    s2 = light(s1, jax_side["backlog"])
    got1 = port.light_phase(convert.from_jax_state(s0), backlog)
    _assert_states_close(got1, convert.from_jax_state(s1))
    got2 = port.light_phase(convert.from_jax_state(s1), backlog)
    _assert_states_close(got2, convert.from_jax_state(s2))
    # the invalid photons were loaded and dropped; the rest interact or not
    occ = got1.pool.occupied
    assert int(occ.sum()) == port.light_k - len(BAD_ROWS)
    assert int(got2.pool.occupied.sum()) == 2 * port.light_k - len(BAD_ROWS)
    assert 0 < int((got2.pool.interacting & got2.pool.occupied).sum())
    assert bool((got2.pool.dkdlam[1][occ] != 0.0).all())


@pytest.fixture(scope="module")
def cpu_sim(dump):
    cfg = engine.EngineConfig(n_pool=1024, m_period=8, sec_cap=1024, dtype=torch.float64)
    return driver.Simulation(dump, photon_n=100, mass_unit=4e19, config=cfg, device="cpu",
                             emit_chunk=256, warmup=0)


def test_event_fluid_plain_matches_the_jax_composition(cpu_sim, dump):
    import jax.numpy as jnp

    from grmonty_tpu import consts as jconsts
    from grmonty_tpu.models import harm as jharm
    from grmonty_tpu.ops import fluid as jfluid
    from grmonty_tpu.ops import geometry as jgeo
    from grmonty_tpu.ops import radiation as jrad

    eng = cpu_sim.engine
    rows, x1, x2, k, w, tries, den = hot_kernels.synthetic_event_fluid(eng, 2048, 41)
    got = hot_kernels.event_fluid_outputs(engine.event_fluid_plain(
        rows, x1, x2, k, w, tries, den, eng.mc, eng.tables))

    mc = jfluid.make_model_consts(jharm.read_dump(dump, 4e19))
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    jx1, jx2, jk, jw = j(x1), j(x2), tuple(j(c) for c in k), j(w)
    g7 = jgeo.gcov_c(jx1, jx2, mc.a, mc.h_slope, mc.r_0)
    fl = jfluid.get_fluid_params_c(jx1, jx2, j(eng.tables.corner_rows), mc, g7=g7)
    sin_th, nu = jrad.kinematics_sin_c(jk, fl.u_cov, fl.b_cov, fl.b, mc.b_unit)
    nu_safe = jnp.abs(nu) + jconsts.EPS
    hc, k2 = j(eng.tables.hc_coeffs), jnp.asarray(eng.tables.k2_coeffs)
    a_sc = jrad.alpha_inv_scatt_c(nu_safe, fl.theta_e, fl.n_e, hc)
    a_ab = jrad.alpha_inv_abs_sin_c(nu_safe, fl.theta_e, fl.n_e, fl.b, sin_th, k2)
    bias = jnp.minimum(jnp.maximum(100.0 * fl.theta_e * fl.theta_e / float(den),
                                   jconsts.TP_OVER_TE),
                       0.5 * jw / engine.WEIGHT_MIN) / jconsts.TP_OVER_TE
    neg = nu < 0.0
    want = hot_kernels._flat({
        "g7": g7, "n_e": fl.n_e, "theta_e": fl.theta_e, "b": fl.b, "u_con": fl.u_con,
        "u_cov": fl.u_cov, "b_con": fl.b_con, "b_cov": fl.b_cov,
        "theta_s": fl.theta_e * jnp.exp2(-(j(tries) // engine.EV_HALVE).astype(jnp.float64)),
        "a_sc": jnp.where(neg, 0.0, a_sc), "a_ab": jnp.where(neg, 0.0, a_ab), "bias": bias})
    assert set(want) == set(got)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=DENORMAL, err_msg=name)
    # the inputs reach every branch: vacuum, plasma, negative frequencies,
    # halved theta_e, the bias's cap and its free range
    assert int((got["n_e"] == 0.0).sum()) > 0 and int((got["n_e"] > 0.0).sum()) > 1000
    assert int((np.asarray(nu) < 0.0).sum()) > 0
    assert int((got["theta_s"] < got["theta_e"]).sum()) > 0
    assert int((got["bias"] < 1.0).sum()) > 0 and int((got["bias"] > 1.0).sum()) > 0


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return bool(torch.equal(a, b) or (a.dtype.is_floating_point and torch.allclose(
            a, b, rtol=0.0, atol=0.0, equal_nan=True)))
    return a == b


@pytest.mark.parametrize("reference", [False, True], ids=["shipped", "reference"])
def test_fresh_init_wrapper_is_the_plain_version_on_the_cpu(cpu_sim, reference):
    mc, tabs = cpu_sim.mc, cpu_sim.tables
    pool, slots, counters, den, cfg = hot_kernels.synthetic_refill(
        mc, 600, 256, 9, torch.float64, "cpu", reference=reference)
    got, sec, pos, c = hot_kernels.refill_fresh(pool, slots, counters, den, mc, tabs, cfg,
                                                hot_kernels.fresh_ticket("cpu"))
    sec0, pos0, c0, load = engine.refill_sources_plain(slots, counters)
    want = engine.init_fresh_plain(pool, load, den, mc, tabs, cfg)
    for f in engine.Pool._fields:
        assert _same(getattr(got, f), getattr(want, f)), f
    assert _same((tuple(sec), pos, tuple(c)), (tuple(sec0), pos0, tuple(c0)))
    # the card check's comparison passes it and sees what the load and start wrote
    rec, fails = hot_kernels.compare_fresh("fresh_init_f64", pool, load, want, got)
    assert not fails and rec["kept_bitwise"] and rec["bi_bitwise"]
    assert 0 < rec["lanes_plasma"] < rec["lanes_fresh"] < rec["lanes_loaded"] < 256
    # a changed lane outside the loaded slots, a changed dk/dlambda or a
    # changed loaded field fails it
    loaded, started = hot_kernels.fresh_lanes(pool, load)
    kept = int(torch.nonzero(~loaded)[0])
    bad = got._replace(alpha_absi=got.alpha_absi.clone())
    bad.alpha_absi[kept] += 1.0
    assert hot_kernels.compare_fresh("fresh_init_f64", pool, load, want, bad)[1]
    lane = int(torch.nonzero(started)[0])
    up = torch.tensor(np.inf).double()
    bad = got._replace(dkdlam=(got.dkdlam[0].clone(),) + got.dkdlam[1:])
    bad.dkdlam[0][lane] = torch.nextafter(bad.dkdlam[0][lane], up)
    assert hot_kernels.compare_fresh("fresh_init_f64", pool, load, want, bad)[1]
    lane = int(torch.nonzero(loaded & ~started)[0])
    bad = got._replace(e_0=got.e_0.clone())
    bad.e_0[lane] = torch.nextafter(bad.e_0[lane], up)
    assert hot_kernels.compare_fresh("fresh_init_f64", pool, load, want, bad)[1]


def _refill_before(eng, p, sec, backlog_rows, backlog_pos, counters, n_valid, width=None,
                   use_sec=True):
    """``Engine.refill`` as it was before its row moves went into the track
    start (one function: the sources, the staged rows and their moves),
    returning (pool, sec, backlog_pos, counters, (valid, sidx))."""
    n, dt = eng.cfg.n_pool, eng.dt
    t_total = backlog_rows.shape[0]
    k_w = eng.rf_k if width is None else width
    valid_g, gi_g, sidx_g = engine.compact_idx(~p.occupied, k_w)
    rank_g = torch.arange(k_w, device=eng.device)
    n_sec = sec.count if use_sec else torch.zeros_like(sec.count)
    from_sec_g = valid_g & (rank_g < n_sec)
    sec_idx_g = torch.clamp(n_sec - 1 - rank_g, 0, sec.rows.shape[0] - 1)
    bl_idx_g = backlog_pos + torch.clamp(rank_g - n_sec, min=0)
    from_bl_g = valid_g & (rank_g >= n_sec) & (bl_idx_g < n_valid)
    bl_idx_g = torch.clamp(bl_idx_g, 0, t_total - 1)
    load_g = from_sec_g | from_bl_g

    rows_g = torch.where(from_sec_g[:, None], sec.rows[sec_idx_g], backlog_rows[bl_idx_g])
    stag = torch.zeros((n + 1, engine.ROW_WIDTH + 1), dtype=dt, device=eng.device)
    stag[sidx_g] = torch.cat([rows_g, load_g[:, None].to(dt)], dim=1)
    rows = stag[:n].T.contiguous()
    load = rows[engine.ROW_WIDTH] > 0.5

    x_new = tuple(rows[m] for m in range(0, 4))
    k_new = tuple(rows[m] for m in range(4, 8))
    w, e = rows[engine.ROW_W], rows[engine.ROW_E]
    ok = load & ~(engine.isnan4(x_new) | engine.isnan4(k_new) | (w == 0.0))
    zero = torch.zeros_like(w)
    nsc_row = rows[engine.ROW_NSCATT].to(torch.int32)

    def pick(row, cur):
        return torch.where(load, row, cur)

    p = p._replace(
        x=engine.where4(load, x_new, p.x), k=engine.where4(load, k_new, p.k),
        w=pick(w, p.w), e=pick(e, p.e), l=pick(rows[engine.ROW_L], p.l),
        n_e_0=pick(rows[engine.ROW_NE0], p.n_e_0),
        theta_e_0=pick(rows[engine.ROW_THETAE0], p.theta_e_0),
        b_0=pick(rows[engine.ROW_B0], p.b_0), e_0=pick(rows[engine.ROW_E0], p.e_0),
        e_0_s=pick(e, p.e_0_s), x1i=pick(x_new[1], p.x1i), x2i=pick(x_new[2], p.x2i),
        tau_abs=pick(zero, p.tau_abs), tau_scatt=pick(zero, p.tau_scatt),
        n_scatt=pick(nsc_row, p.n_scatt), nsc0=pick(nsc_row, p.nsc0),
        n_step=pick(torch.zeros_like(p.n_step), p.n_step),
        ev_tries=pick(torch.zeros_like(p.ev_tries), p.ev_tries),
        pend_dl=pick(zero, p.pend_dl), dl_shrink=pick(torch.ones_like(w), p.dl_shrink),
        sec_w=pick(zero, p.sec_w),
        occupied=p.occupied | ok, alive=p.alive | ok,
        pend_push=p.pend_push & ~load, at_event=p.at_event & ~load,
        record_pending=p.record_pending & ~load,
    )
    n_from_bl = from_bl_g.sum()
    sec = sec._replace(count=sec.count - from_sec_g.sum())
    counters = counters._replace(n_created=counters.n_created + n_from_bl)
    bad_g = torch.any(torch.isnan(rows_g[:, 0:8]), dim=1) | (rows_g[:, engine.ROW_W] == 0.0)
    return p, sec, backlog_pos + n_from_bl, counters, (load_g & ~bad_g, sidx_g)


@pytest.fixture(scope="module")
def refill_sims(dump):
    """A CPU engine of each semantics (float64, 512 lanes, refill slots 384,
    ring 96), with the birth trace off and on."""
    out = {}
    for reference in (False, True):
        for trace in (False, True):
            cfg = (profiles.reference_config(pool=512, dtype=torch.float64) if reference
                   else profiles.bench_config(pool=512, dtype=torch.float64))
            cfg = cfg._replace(refill_k=384, sec_cap=96, trace_birth=trace)
            out[reference, trace] = driver.Simulation(dump, photon_n=100, mass_unit=4e19,
                                                      config=cfg, device="cpu",
                                                      emit_chunk=256, warmup=0)
    return out


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("reference", [False, True], ids=["shipped", "reference"])
@pytest.mark.parametrize("sources", ["ring", "backlog", "both"])
def test_split_refill_equals_the_refill_before_it(refill_sims, reference, trace, sources):
    """Refill's slots (``Engine.refill_slots``) through ``refill_fresh`` (the
    sources, then the load and start of init_fresh_plain) equal the refill
    that moved the rows itself followed by the start, bit for bit: every pool field, the ring, the backlog
    position and the counters.  The pool has 400 free lanes for 384 slots
    (or 300: padding slots); the ring is partly filled (a NaN row and a
    zero-weight row among its photons), the backlog has a NaN row and a
    zero-weight row and runs out before the slots."""
    sim = refill_sims[reference, trace]
    eng = sim.engine
    n, dt = eng.cfg.n_pool, eng.dt
    rng = np.random.default_rng([7, reference, trace])
    sim.plan()
    backlog = sim.emit_rows(0, 256)
    backlog[3, 5] = float("nan")
    backlog[6, engine.ROW_W] = 0.0
    ring = sim.emit_rows(256, 96).flip(0).contiguous()
    ring[:, engine.ROW_NSCATT] = torch.as_tensor(rng.integers(1, 4, 96), dtype=dt)
    ring[1, 2] = float("nan")
    ring[4, engine.ROW_W] = 0.0
    free = 300 if sources == "backlog" else 400
    state = eng.fresh_state()
    occupied = torch.ones(n, dtype=torch.bool)
    occupied[torch.as_tensor(rng.choice(n, free, replace=False))] = False
    pool = state.pool._replace(
        occupied=occupied, alive=torch.as_tensor(rng.random(n) < 0.5),
        pend_push=torch.as_tensor(rng.random(n) < 0.3),
        at_event=torch.as_tensor(rng.random(n) < 0.3),
        record_pending=torch.as_tensor(rng.random(n) < 0.3),
        w=torch.as_tensor(rng.uniform(1.0, 2.0, n), dtype=dt),
        tau_abs=torch.as_tensor(rng.random(n), dtype=dt),
        n_step=torch.as_tensor(rng.integers(1, 9, n).astype(np.int32)))
    n_sec = {"ring": 96, "backlog": 0, "both": 40}[sources]
    sec = state.sec._replace(count=torch.tensor(n_sec))
    sec = sec._replace(rows=ring.clone())
    pos, n_valid = torch.tensor(2), 2 if sources == "ring" else 250
    counters = state.counters._replace(n_created=torch.tensor(5))
    den = eng._bias_den(counters)

    p0, sec0, pos0, c0, fresh = _refill_before(eng, pool, sec, backlog, pos, counters, n_valid)
    want = engine.init_fresh_plain(p0, fresh, den, eng.mc, eng.tables, eng.cfg)
    slots = eng.refill_slots(sec, pool.occupied, backlog, pos, n_valid)
    got, sec1, pos1, c1 = hot_kernels.refill_fresh(pool, slots, counters, den, eng.mc,
                                                   eng.tables, eng.cfg, eng._fresh_ticket)
    load = engine.refill_sources_plain(slots, counters)[3]
    for f in engine.Pool._fields:
        assert _same(getattr(got, f), getattr(want, f)), f
    assert _same(tuple(sec1), tuple(sec0)) and _same(pos1, pos0)
    assert _same(tuple(c1), tuple(c0))
    # the sources reached what the test set up: both kinds of rows, a bad
    # row from each source used, slots past the sources and padding slots
    loaded, started = hot_kernels.fresh_lanes(pool, load)
    assert int((load.load & load.from_sec).sum()) == min(n_sec, 384)
    assert int((load.load & ~load.from_sec).sum()) == min(n_valid - 2, 384 - n_sec)
    assert int(loaded.sum()) - int(started.sum()) >= {"ring": 2, "backlog": 2, "both": 4}[sources]
    assert bool((load.sidx == n).any()) == (sources == "backlog")
    assert int((got.interacting & started).sum()) > 0


def test_event_fluid_wrapper_is_the_plain_version_on_the_cpu(cpu_sim):
    eng = cpu_sim.engine
    args = hot_kernels.synthetic_event_fluid(eng, 700, 5)
    got = hot_kernels.event_fluid(*args, eng.mc, eng.tables)
    want = engine.event_fluid_plain(*args, eng.mc, eng.tables)
    assert _same(tuple(got), tuple(want))
    ref = hot_kernels.event_fluid_outputs(want)
    assert not hot_kernels.compare(ref, hot_kernels.event_fluid_outputs(got),
                                   **hot_kernels.KERNEL_TOLERANCE["event_fluid_f64"],
                                   nan_equal=True)[3]
    with pytest.raises(ValueError):
        hot_kernels.entry_point("event_fluid", torch.float16)
    assert hot_kernels.entry_point("fresh_init", torch.float64, True) == "fresh_init_ref_f64"
    assert hot_kernels.entry_point("event_fluid", torch.float32, True) == "event_fluid"


def test_the_engine_runs_both_through_their_wrappers(cpu_sim, monkeypatch):
    """A full phase calls the event phase once (which runs the event fluid
    on one row gather of the events' rows) and refill_fresh once; each equals
    a run whose wrappers are replaced by the plain versions."""
    sim = cpu_sim
    eng = sim.engine
    sim.plan()
    backlog = sim.emit_rows(0, 1024)
    state = eng.fresh_state()
    for _ in range(3):  # load lanes and run them to events
        state = eng.periodic_phase(state, backlog)
        for _ in range(8):
            state = eng.hot_step(state)
    calls = {"refill_fresh": 0, "event_phase": 0}
    wrapped = {name: getattr(hot_kernels, name) for name in calls}

    def counting(name):
        def fn(*a, **kw):
            calls[name] += 1
            return wrapped[name](*a, **kw)
        return fn

    for name in calls:
        monkeypatch.setattr(hot_kernels, name, counting(name))
    gen_state = eng.gen.get_state()
    got = eng.periodic_phase(state, backlog)
    assert calls == {"refill_fresh": 1, "event_phase": 1}

    def fresh_plain(p, slots, counters, den, mc, tables, cfg, ticket):
        sec, pos, counters, load = engine.refill_sources_plain(slots, counters)
        return engine.init_fresh_plain(p, load, den, mc, tables, cfg), sec, pos, counters

    monkeypatch.setattr(hot_kernels, "refill_fresh", fresh_plain)
    monkeypatch.setattr(hot_kernels, "event_phase",
                        lambda *a, gen, **kw: engine.event_phase_plain(*a, src=gen))
    eng.gen.set_state(gen_state)
    want = eng.periodic_phase(state, backlog)
    for f in engine.Pool._fields:
        assert _same(getattr(got.pool, f), getattr(want.pool, f)), f
    assert _same(tuple(got.counters), tuple(want.counters))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

# the track starts' (pool lanes, fresh-set width) on either semantics' path,
# held in both semantics; the event phase's compacted widths
FRESH_WIDTHS = sorted(set(hot_kernels.FRESH_WIDTHS[False]) | set(hot_kernels.FRESH_WIDTHS[True]),
                      reverse=True)
EVENT_WIDTHS = hot_kernels.EVENT_FLUID_WIDTHS


@pytest.fixture(scope="module")
def card_sims(dump):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return {dt: driver.Simulation(dump, photon_n=100, mass_unit=4e19, device="cuda",
                                  config=profiles.bench_config(pool=1024, dtype=dt),
                                  emit_chunk=256, warmup=0)
            for dt in (torch.float32, torch.float64)}


def _refill_on_card(sim, n, k, seed, dtype, reference, trace_birth=True):
    """Synthetic refill slots on the card (``hot_kernels.synthetic_refill``),
    the plain result (``engine.refill_sources_plain``, then
    ``engine.init_fresh_plain``) and the slots' load."""
    pool, slots, counters, den, cfg = hot_kernels.synthetic_refill(
        sim.mc, n, k, seed, dtype, "cuda", reference=reference, trace_birth=trace_birth)
    sec, pos, c, load = engine.refill_sources_plain(slots, counters)
    want = engine.init_fresh_plain(pool, load, den, sim.mc, sim.tables, cfg)
    return pool, slots, counters, den, cfg, (want, sec, pos, c), load


def _counts(sec, pos, counters):
    return [int(sec.count), int(pos), int(counters.n_created)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("reference", [False, True], ids=["shipped", "reference"])
@pytest.mark.parametrize("n,k", FRESH_WIDTHS, ids=[f"{n}x{k}" for n, k in FRESH_WIDTHS])
def test_fresh_init_kernel_matches_plain_on_the_card(card_sims, dtype, reference, n, k):
    sim = card_sims[dtype]
    pool, slots, counters, den, cfg, ref, load = _refill_on_card(sim, n, k, 2030 + k, dtype,
                                                                 reference)
    name = hot_kernels.entry_point("fresh_init", dtype, reference)
    ticket = hot_kernels.fresh_ticket("cuda")
    work = engine.clone_pool(pool)
    before = dict(hot_kernels.launches)
    got = hot_kernels.refill_fresh(work, slots, counters, den, sim.mc, sim.tables, cfg, ticket)
    torch.cuda.synchronize()
    assert hot_kernels.launches[name] == before[name] + 1
    assert sum(hot_kernels.launches.values()) == sum(before.values()) + 1
    rec, fails = hot_kernels.compare_fresh(name, pool, load, ref[0], got[0])
    assert not fails, (fails, rec)
    assert rec["lanes_plasma"] > 0 and rec["lanes_loaded"] > rec["lanes_fresh"]
    assert _counts(*got[1:]) == _counts(*ref[1:]) and not bool(ticket.any())
    # the trace off: no birth state in, none out
    pool, slots, counters, den, off, ref, load = _refill_on_card(sim, n, k, 2030 + k, dtype,
                                                                 reference, trace_birth=False)
    assert pool.bx == () and pool.bw == ()
    got = hot_kernels.refill_fresh(engine.clone_pool(pool), slots, counters, den, sim.mc,
                                   sim.tables, off, ticket)
    assert got[0].bx == () and got[0].bw == ()
    assert not hot_kernels.compare_fresh(name, pool, load, ref[0], got[0])[1]
    assert _counts(*got[1:]) == _counts(*ref[1:])


# the sets on both sides of each change of the threads a slot
# (csrc/fresh_init.cu fresh_group: 8 up to 1,024 slots, 4 up to 4,096)
GROUP_EDGES = ((2048, 1024), (2048, 1025), (8192, 4096), (8192, 4097))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("reference", [False, True], ids=["shipped", "reference"])
@pytest.mark.parametrize("n,k", GROUP_EDGES, ids=[f"{n}x{k}" for n, k in GROUP_EDGES])
def test_fresh_init_updates_the_pool_in_place(card_sims, dtype, reference, n, k):
    """The kernel writes the loaded lanes of the pool it is given and the
    three counts and nothing else: the same tensors come back, every lane
    outside the loaded slots (padding slots too) keeps its bits, within the
    tolerance of the plain version, on both sides of each change of the
    threads a slot; a second launch from the same counts writes the same
    bits."""
    sim = card_sims[dtype]
    pool, slots, counters, den, cfg, ref, load = _refill_on_card(sim, n, k, 4040 + k, dtype,
                                                                 reference)
    name = hot_kernels.entry_point("fresh_init", dtype, reference)
    assert bool((slots.sidx == n).any())
    shape = hot_kernels.fresh_shape(name, k)["group"]
    assert shape == (8 if k <= 1024 else 4 if k <= 4096 else 1)
    ticket = hot_kernels.fresh_ticket("cuda")
    outs = []
    for _ in range(2):
        work = engine.clone_pool(pool)
        tensors = hot_kernels._flat(work._asdict())
        sl = slots._replace(sec=slots.sec._replace(count=slots.sec.count.clone()),
                            backlog_pos=slots.backlog_pos.clone())
        c = counters._replace(n_created=counters.n_created.clone())
        held = (sl.sec.count, sl.backlog_pos, c.n_created)
        got, sec, pos, c1 = hot_kernels.refill_fresh(work, sl, c, den, sim.mc, sim.tables, cfg,
                                                     ticket)
        torch.cuda.synchronize()
        assert got is work
        assert all(t is tensors[f] for f, t in hot_kernels._flat(got._asdict()).items())
        assert all(a is b for a, b in zip((sec.count, pos, c1.n_created), held))
        assert _counts(sec, pos, c1) == _counts(*ref[1:]) and not bool(ticket.any())
        rec, fails = hot_kernels.compare_fresh(name, pool, load, ref[0], got)
        assert not fails and rec["kept_bitwise"], fails
        outs.append(hot_kernels._flat(got._asdict()))
    for f, a in outs[0].items():
        assert bool(hot_kernels._same_bits(a, outs[1][f]).all()), f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", EVENT_WIDTHS)
def test_event_fluid_kernel_matches_plain_on_the_card(card_sims, dtype, n):
    sim = card_sims[dtype]
    args = hot_kernels.synthetic_event_fluid(sim.engine, n, 3030 + n)
    name = hot_kernels.entry_point("event_fluid", dtype)
    want = hot_kernels.event_fluid_outputs(engine.event_fluid_plain(*args, sim.mc, sim.tables))
    before = hot_kernels.launches[name]
    got = hot_kernels.event_fluid_outputs(hot_kernels.event_fluid(*args, sim.mc, sim.tables))
    torch.cuda.synchronize()
    assert hot_kernels.launches[name] == before + 1
    err, rel, mask, fails = hot_kernels.compare(want, got, **hot_kernels.KERNEL_TOLERANCE[name],
                                                nan_equal=True)
    assert not fails, fails
