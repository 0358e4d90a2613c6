"""The whole event phase as one kernel (``hot_kernels.event_phase``,
``engine.event_phase_plain``) and the order-preserving compaction
(``hot_kernels.compact``, its rows mode ``hot_kernels.compact_rows``;
``engine.compact_idx``, ``engine.pack_rows_plain``), on the 64x32 torus.

* CPU: ``Engine.process_scatters`` through the new wrappers equals the
  composition it replaces (the sort's compaction, the row gather, the event
  fluid, the plain event on the engine's generator, the column moves and
  the cumsum pack, :func:`_parent_process_scatters`) bit for bit, with the
  same draws, on seeded pools that hold every kind of lane (parked,
  shadow-register, deferred, forced at ``EV_FORCE``, doomed parents,
  outside the plasma) against an open ring, a ring with room for half the
  set and a wedged one, in float32 and float64; the ring's rows and their
  order are the same.  ``compact``'s wrapper equals the JAX engine's
  formulation (``jax.lax.sort`` of ``where(mask, iota, n)``) on seeded
  masks at N = 512, 4,096 and 65,536 with k below, at and above the set
  count.  The port's light phase, whose refill compacts through the
  wrapper (and whose record ranks its lanes in ``record_phase``), matches
  JAX's from the same state.
* On the card (``cuda`` tests, ``python -m pytest --noconftest -m cuda
  tests/test_torch_event_phase.py``): each kernel against its plain version
  at the path's widths in both dtypes (``hot_kernels.compare_event_phase``:
  the pool, the staged rows, the counters and the ring bit for bit, the
  refreshed opacities and bias at the event fluid's tolerance; the
  compaction bit for bit); every lanes-a-warp instance (the shape
  table's, by dtype) the same bits; the kernel against its plain version
  at each side of every edge of its shape table; the
  wrapper's refusal of fields that share memory; the graphed block bit for
  bit the eager one.  JAX is imported inside the tests, so these run where
  JAX is missing.  CPU: the shape table itself (``EVENT_PHASE_SHAPES``) and
  ``tools/clock_phase_kernels``' anchors in this and the previous source.
"""

import numpy as np
import pytest
import torch

from grmonty_tpu_torch import convert
from grmonty_tpu_torch.models import harm, torus
from grmonty_tpu_torch.ops import draws, fluid, scattering
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

POOL = 256
EV_K = 128  # the CPU engine's compacted width: fewer than its events
RTOL = 1e-10


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


@pytest.fixture(scope="module")
def cpu_sims(dump):
    return {dt: driver.Simulation(
        dump, photon_n=100, mass_unit=4e19, device="cpu", emit_chunk=256, warmup=0,
        config=engine.EngineConfig(n_pool=POOL, m_period=8, sec_cap=512, ev_k=EV_K, dtype=dt))
        for dt in (torch.float32, torch.float64)}


def _parent_process_scatters(eng, p, sec, counters):
    """The full phase's events as the engine ran them before the event phase
    was one kernel: the sort's compaction, the ring's room, the columns
    gathered, the row gather, the event fluid, the event on the engine's
    generator, the columns put back and the cumsum pack."""
    mc, dt = eng.mc, eng.dt
    valid, gi, sidx = engine.compact_idx(p.ev_pending | p.at_event, eng.ev_k)
    sec_cap = sec.rows.shape[0]
    room = torch.clamp(sec_cap - sec.count, min=0)
    rank_e = torch.arange(eng.ev_k)
    wedged = (room == 0) & ~torch.any(~p.occupied)
    valid = valid & ((rank_e < room) | wedged)
    cols = engine.take_cols(gi, [*p.x, *p.k, p.sec_w, p.w, p.ev_tries, p.n_e_0, p.theta_e_0,
                                 p.e_0, p.n_scatt, p.alive, p.occupied, p.at_event,
                                 p.alpha_scatti, p.alpha_absi, p.bi, p.ev_pending, *p.ev_x,
                                 *p.ev_k, p.ev_w])
    (x0g, x1g, x2g, x3g, k0g, k1g, k2g, k3g, secw_g, wg, tries_g, ne0_g, te0_g, e0_g, nsc_g,
     alive_g, occ_g, atev_g, asc_g, aab_g, bi_g, evp_g) = cols[:22]
    evx, evk, evw_g = cols[22:26], cols[26:30], cols[30]
    reg_g = evp_g & valid
    xg = engine.where4(reg_g, evx, (x0g, x1g, x2g, x3g))
    kg = engine.where4(reg_g, evk, (k0g, k1g, k2g, k3g))
    secw_g = torch.where(reg_g, evw_g, secw_g)
    force_g = valid & (tries_g >= engine.EV_FORCE)
    rows = hot_kernels.row_gather(eng.tables.corner_rows,
                                  fluid.cell_index_c(xg[1], xg[2], mc).to(torch.int32))
    ev = engine.event_fluid_plain(rows, xg[1], xg[2], kg, wg, tries_g, eng._bias_den(counters),
                                  mc, eng.tables)
    g7, fl = ev.g7, ev.fl
    res = scattering.scatter_event_c(eng.gen, kg, fl._replace(theta_e=ev.theta_s), g7,
                                     mc.b_unit, active=valid, force=force_g)
    defer_g = valid & ~(res.sampled | res.parent_die)
    valid = valid & ~defer_g
    parent_die = valid & res.parent_die & ~reg_g
    make = valid & res.made & (fl.n_e > 0.0) & ~res.parent_die
    surv = valid & ~res.parent_die & ~reg_g
    zero = torch.zeros_like(wg)
    news = engine.put_cols(sidx, [
        (p.alpha_scatti, torch.where(surv, ev.a_sc, asc_g)),
        (p.alpha_absi, torch.where(surv, ev.a_ab, aab_g)),
        (p.bi, torch.where(surv, ev.bias, bi_g)),
        (p.w, torch.where(parent_die, zero, wg)),
        (p.ev_tries, torch.where(defer_g, tries_g + 1,
                                 torch.where(valid, 0, tries_g)).to(torch.int32)),
        (p.alive, alive_g & ~parent_die),
        (p.occupied, occ_g & ~parent_die),
        (p.at_event, atev_g & ~(valid & ~reg_g)),
        (p.ev_pending, evp_g & ~(valid & reg_g)),
    ])
    p = p._replace(**dict(zip(("alpha_scatti", "alpha_absi", "bi", "w", "ev_tries", "alive",
                               "occupied", "at_event", "ev_pending"), news)))
    rank = torch.cumsum(make.to(torch.int64), 0) - 1
    pos = sec.count + rank
    fits = make & (pos < sec_cap)
    slot = torch.where(fits, pos, sec_cap)
    new_rows = torch.stack([*xg, *res.k_sec, secw_g, res.e_sec, res.l_sec, ne0_g, te0_g, fl.b,
                            e0_g, (nsc_g + 1).to(dt)], dim=-1)
    sec = engine.SecBuf(rows=engine.put(sec.rows, slot, new_rows), count=sec.count + fits.sum())
    counters = counters._replace(
        n_sec_drop=counters.n_sec_drop + (make & ~fits).sum(),
        n_ev_soft=counters.n_ev_soft + (valid & (tries_g >= engine.EV_HALVE)).sum(),
        n_ev_forced=counters.n_ev_forced + (valid & force_g).sum())
    return p, sec, counters


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b, strict=True))
    return bool(hot_kernels._same_bits(a, b).all()) and a.dtype == b.dtype


def _counted(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(hot_kernels, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(hot_kernels, name, counted)
    return calls


@pytest.mark.parametrize("ring", hot_kernels.EVENT_RINGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_process_scatters_equals_the_composition_it_replaces(cpu_sims, dtype, ring,
                                                             monkeypatch):
    sim = cpu_sims[dtype]
    eng = sim.engine
    pool, sec, counters, _ = hot_kernels.synthetic_event_pool(eng, POOL, EV_K, 31, ring)
    eng.gen.manual_seed(11)
    g0 = eng.gen.get_state()
    want = _parent_process_scatters(eng, pool, sec, counters)
    g1 = eng.gen.get_state()
    eng.gen.set_state(g0)
    calls = _counted(monkeypatch, ("compact", "event_phase", "compact_rows"))
    got = eng.process_scatters(pool, sec, counters, eng._bias_den(counters))
    assert calls == {"compact": 1, "event_phase": 1, "compact_rows": 1}
    assert torch.equal(eng.gen.get_state(), g1)
    for a, b in zip(got, want, strict=True):
        for f in a._fields:
            assert _same(getattr(a, f), getattr(b, f)), f
    p, sec_out, c = got
    events = pool.ev_pending | pool.at_event
    assert int(events.sum()) > EV_K  # the compaction cuts the set
    ran = int((events & ~(p.ev_pending | p.at_event)).sum())
    made = int(sec_out.count - sec.count) + int(c.n_sec_drop - counters.n_sec_drop)
    assert ran > 0 and made > 0
    if ring == "wedged":  # every event ran; its secondaries dropped
        assert int(sec_out.count) == int(sec.count) and int(c.n_sec_drop) > 1
    else:
        assert int(c.n_sec_drop) == 1 and int(sec_out.count) > int(sec.count)
    if ring == "room":
        assert ran <= EV_K // 2
    # deferred, forced and parent-death lanes are among the set
    assert int(c.n_ev_forced) > 2 and int((p.ev_tries > pool.ev_tries).sum()) > 0
    assert int((pool.alive & ~p.alive).sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_the_ring_takes_the_secondaries_in_lane_order(cpu_sims, dtype):
    """The pack puts the slots' rows at count + rank in the compacted set's
    order (ascending lanes), which refill's LIFO reads back; a ring short of
    room keeps the first rows and counts the rest as dropped."""
    eng = cpu_sims[dtype].engine
    pool, sec, counters, den = hot_kernels.synthetic_event_pool(eng, POOL, EV_K, 32, "open")
    sel, room, wedged = engine.event_set(pool, sec, EV_K)
    _, c1, stage = hot_kernels.event_phase(pool, counters, sel, room, wedged, den, eng.mc,
                                           eng.tables, key=torch.tensor([3, 4]))
    made = torch.nonzero(stage.make).flatten()
    assert made.numel() > 2
    out, _ = hot_kernels.compact_rows(stage, sec, c1)
    c0 = int(sec.count)
    assert int(out.count) == c0 + made.numel()
    assert torch.equal(out.rows[c0:c0 + made.numel()], stage.rows[made])
    assert torch.equal(out.rows[:c0], sec.rows[:c0])
    short = sec._replace(count=torch.tensor(sec.rows.shape[0] - 2))
    out, c2 = hot_kernels.compact_rows(stage, short, c1)
    assert int(out.count) == sec.rows.shape[0]
    assert torch.equal(out.rows[-2:], stage.rows[made[:2]])
    assert int(c2.n_sec_drop - c1.n_sec_drop) == made.numel() - 2


def _jax_compact(mask, k):
    import jax
    import jax.numpy as jnp

    n = mask.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    idx = jax.lax.sort(jnp.where(jnp.asarray(mask), lane, n))[:k]
    valid = idx < n
    return valid, jnp.minimum(idx, n - 1), jnp.where(valid, idx, n)


@pytest.mark.parametrize("where", ["below", "at", "above"])
@pytest.mark.parametrize("n", [512, 4096, 65536])
def test_compact_equals_the_jax_sort(n, where):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < rng.uniform(0.05, 0.6)
    mask[[0, n - 1]] = (True, False)
    count = int(mask.sum())
    k = {"below": count // 3, "at": count, "above": min(n, count + 17 + n // 8)}[where]
    got = hot_kernels.compact(torch.as_tensor(mask), k)
    want = _jax_compact(mask, k)
    for g, w, name in zip(got, want, ("valid", "gi", "sidx")):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype)), name
    assert got[0].dtype == torch.bool and got[1].dtype == got[2].dtype == torch.int64


def _shape_edges(dtype):
    """(k below, k above) of each edge of the event phase's shape table."""
    return [(top, top + 1) for top, _ in hot_kernels.EVENT_PHASE_SHAPES[dtype] if top is not None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_the_event_phase_shape_table(dtype):
    """Bands in ascending order, the last unbounded; every shape an
    instance of the kernel; a band's shape on both sides of its edges, and
    another across each edge; one lane a warp at the cascade's 512 and the
    gate's 256 slots, more at the waves' 16,384."""
    table = hot_kernels.EVENT_PHASE_SHAPES[dtype]
    tops = [top for top, _ in table]
    assert tops[-1] is None and tops[:-1] == sorted(tops[:-1]) and len(set(tops)) == len(tops)
    assert all(lanes in (32, 16, 8, 4, 1) for _, lanes in table)  # the launch's cases
    bands = [0] + tops[:-1]
    for (lo, (top, lanes)) in zip(bands, table):
        for k in (lo + 1, top if top is not None else lo + 100000):
            assert hot_kernels.event_phase_shape(k, dtype) == {"lanes": lanes,
                                                               "group": 32 // lanes}, k
    for below, above in _shape_edges(dtype):
        assert (hot_kernels.event_phase_shape(below, dtype)
                != hot_kernels.event_phase_shape(above, dtype))
    for k in (256, 512):
        assert hot_kernels.event_phase_shape(k, dtype)["lanes"] == 1, k
    assert hot_kernels.event_phase_shape(16384, dtype)["lanes"] > 1


# The lines of the event phase before its redesign onto pairs of warps that
# the clock's alternative anchors match (one thread a lane; the epilogue's pool reads
# after the samplers), as this source's counterparts
_PARENT_LINES = {
    "  const int s0 = phase_lane<L>(t);\n": "  const int s0 = warp_lane<L>(t);\n",
    "    r[15] = keep[10 * THREADS];\n": "    r[15] = (T)(P.n_scatt[i] + 1);\n",
    "  metric_pair(x1, x2, CB, g, gc);\n": "    metric_pair(x1, x2, CB, g, gc);\n",
}


def test_event_phase_clock_stamps_find_every_anchor():
    """``tools/clock_phase_kernels`` stamps the event phase at lines it must
    find in this source and in the one before the redesign (its forms of
    the lines that moved): every segment's stamp once, the clock's start
    and the warps' count; a source without an anchor raises."""
    import os

    from grmonty_tpu_torch.tools import clock_phase_kernels as clock

    with open(os.path.join(hot_kernels.CSRC_DIR, clock.SOURCES["event_phase"])) as f:
        src = f.read()
    before = src
    for now, then in _PARENT_LINES.items():
        assert src.count(now) == 1, now
        before = before.replace(now, then)
    for text in (src, before):
        out = clock.stamped(text, "event_phase")
        for k in range(len(clock.PHASE_SEGMENTS)):
            assert out.count(f"STAMP({k}, ") == 1, k
        assert out.count("CLK_START();") == 1 and "CLK_WARP();" in out and "clk_read" in out
    with pytest.raises(ValueError, match="no anchor"):
        clock.stamped(src.replace("barrier_wait(&hc_bar);", "barrier_wait( &hc_bar);"),
                      "event_phase")


def test_wrappers_check_their_arguments(cpu_sims):
    eng = cpu_sims[torch.float64].engine
    pool, sec, counters, den = hot_kernels.synthetic_event_pool(eng, POOL, EV_K, 33, "room")
    sel, room, wedged = engine.event_set(pool, sec, EV_K)
    args = (pool, counters, sel, room, wedged, den, eng.mc, eng.tables)
    for kw in ({}, {"gen": eng.gen, "key": torch.tensor([1, 2])}):
        with pytest.raises(ValueError, match="exactly one"):
            hot_kernels.event_phase(*args, **kw)
    for k in (-1, POOL + 1, 2.0):
        with pytest.raises(ValueError):
            hot_kernels.compact(pool.occupied, k)
    with pytest.raises(ValueError):
        hot_kernels.synthetic_event_pool(eng, POOL, EV_K, 1, "full")
    assert hot_kernels.entry_point("event_phase", torch.float64, True) == "event_phase_f64"
    assert hot_kernels.entry_point("compact_rows", torch.float32) == "compact_rows"
    assert hot_kernels.entry_point("compact", torch.float64) == "compact"
    # the key's draws are draws.PhiloxDraws' on the CPU
    key = torch.tensor([5, 6])
    one = hot_kernels.event_phase(*args, key=key)
    two = engine.event_phase_plain(*args, draws.PhiloxDraws(key))
    assert all(_same(getattr(one[0], f), getattr(two[0], f)) for f in engine.Pool._fields)
    assert _same(tuple(one[2]), tuple(two[2]))


@pytest.fixture(scope="module", params=[False, True], ids=["shipped", "reference"])
def jax_light(request, dump):
    """A JAX engine of one semantics (float64, POOL lanes), its jitted light
    phase, a fresh state and a backlog; the port's engine of the same config
    on the same tables."""
    import jax
    import jax.numpy as jnp
    from jax import random

    from grmonty_tpu.transport import driver as jdriver
    from grmonty_tpu.transport import engine as jengine

    reference = request.param
    physics = convert._REFERENCE if reference else convert._SHIPPED
    jcfg = jengine.EngineConfig(
        n_pool=POOL, m_period=16, sec_cap=4 * POOL, ev_k=POOL // 4, refill_k=POOL // 2,
        light_k=POOL // 4, refill_period=4, dtype=jnp.float64,
        **({} if reference else {"grow_cap": 8.0}), **physics)
    jsim = jdriver.Simulation(dump, photon_n=2000, mass_unit=4e19, config=jcfg,
                              cdf_sampler=True, emit_stride=True, warmup=0)
    backlog = np.array(jsim.emit_packed(jsim.plan(), 0, 4 * POOL))
    mc = fluid.make_model_consts(harm.read_dump(dump, 4e19))
    port = engine.Engine(mc, convert.from_jax_config(jcfg),
                         convert.from_jax_engine_tables(jsim._engine_tabs), torch.device("cpu"),
                         torch.Generator())
    return dict(light=jax.jit(jsim.engine["light_phase"]),
                fresh=jsim.engine["fresh_state"](random.PRNGKey(3)),
                backlog=jnp.asarray(backlog), port=port)


def test_light_phase_through_compact_matches_jax(jax_light, monkeypatch):
    """Two light phases from a fresh state: each of the port's, whose record
    runs through ``hot_kernels.record_phase`` (which ranks its lanes
    itself) and whose refill compacts through ``hot_kernels.compact`` (one
    call each a phase), agrees with JAX's from the same state to rtol
    1e-10, masks and integers exactly."""
    light, port = jax_light["light"], jax_light["port"]
    backlog = torch.as_tensor(np.array(jax_light["backlog"]))
    calls = _counted(monkeypatch, ("compact", "record_phase"))
    s0 = jax_light["fresh"]
    s1 = light(s0, jax_light["backlog"])
    s2 = light(s1, jax_light["backlog"])
    for src, dst in ((s0, s1), (s1, s2)):
        got = port.light_phase(convert.from_jax_state(src), backlog)
        want = convert.from_jax_state(dst)
        for name, g, w in zip(driver._flat_state(want), engine.state_tensors(got),
                              engine.state_tensors(want), strict=True):
            if w.dtype.is_floating_point:
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL, atol=0.0,
                                           err_msg=name)
            else:
                assert np.array_equal(g.numpy(), w.numpy().astype(g.numpy().dtype)), name
    assert calls == {"compact": 2, "record_phase": 2}
    assert int(got.pool.occupied.sum()) == 2 * port.light_k


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")


@pytest.fixture(scope="module")
def card_sims(dump):
    _card()
    return {dt: driver.Simulation(dump, photon_n=100, mass_unit=4e19, device="cuda",
                                  config=profiles.bench_config(pool=1024, dtype=dt),
                                  emit_chunk=256, warmup=0)
            for dt in (torch.float32, torch.float64)}


def _card_phase(sim, n, k, seed, ring, lanes=None):
    """(ref, got, launches) of one event phase and the ring's pack on a
    synthetic pool: the plain version on PhiloxDraws, the kernels on a copy
    of the pool, ring and counters under the same key."""
    eng = sim.engine
    pool, sec, counters, den = hot_kernels.synthetic_event_pool(eng, n, k, seed, ring)
    sel, room, wedged = engine.event_set(pool, sec, k)
    key = torch.tensor([0x5EED0000 + seed, 0xC0FFEE], dtype=torch.int64, device="cuda")
    rp, rc, rs = engine.event_phase_plain(pool, counters, sel, room, wedged, den, sim.mc,
                                          sim.tables, draws.PhiloxDraws(key))
    rsec, rc = engine.pack_rows_plain(rs, sec, rc)
    work = engine.clone_pool(pool)
    wsec = engine.SecBuf(*(t.clone() for t in sec))
    wc = engine.Counters(*(t.clone() for t in counters))
    before = dict(hot_kernels.launches)
    gp, gc, gs = hot_kernels.event_phase(work, wc, sel, room, wedged, den, sim.mc, sim.tables,
                                         key=key, lanes=lanes)
    gsec, gc = hot_kernels.compact_rows(gs, wsec, gc, hot_kernels.rows_ticket("cuda"))
    torch.cuda.synchronize()
    added = {k_: v - before[k_] for k_, v in hot_kernels.launches.items() if v != before[k_]}
    assert gp is work and gsec.rows is wsec.rows and gc.n_sec_drop is wc.n_sec_drop
    return (rp, rc, rs, rsec), (gp, gc, gs, gsec), added


@pytest.mark.cuda
@pytest.mark.parametrize("ring", hot_kernels.EVENT_RINGS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,k", hot_kernels.EVENT_PHASE_WIDTHS,
                         ids=[f"{n}x{k}" for n, k in hot_kernels.EVENT_PHASE_WIDTHS])
def test_event_phase_kernel_matches_plain_on_the_card(card_sims, dtype, n, k, ring):
    sim = card_sims[dtype]
    name = hot_kernels.entry_point("event_phase", dtype)
    ref, got, added = _card_phase(sim, n, k, 50 + k, ring)
    assert added == {name: 1, hot_kernels.entry_point("compact_rows", dtype): 1}
    rec, fails = hot_kernels.compare_event_phase(name, ref, got)
    assert not fails, (fails, rec)
    assert rec["made"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_every_lanes_a_warp_instance_gives_the_same_bits(card_sims, dtype):
    sim = card_sims[dtype]
    name = hot_kernels.entry_point("event_phase", dtype)
    for n, k in ((4096, 1024), (4096, 1025), (65536, 4096), (65536, 4097), (65536, 16384)):
        outs = [_card_phase(sim, n, k, 70, "room", lanes=lanes)
                for lanes in (None,) + hot_kernels.EVENT_PHASE_LANES[dtype]]
        for ref, got, _ in outs:
            assert not hot_kernels.compare_event_phase(name, ref, got)[1], (n, k)
        base = outs[0][1]
        for _, got, _ in outs[1:]:
            assert not hot_kernels.compare_event_phase(name, base, got)[1]
            for f in hot_kernels.EVENT_PHASE_TOL:
                assert torch.equal(getattr(base[0], f), getattr(got[0], f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_event_phase_matches_plain_at_each_side_of_the_shape_edges(card_sims, dtype):
    """At each side of every edge of ``EVENT_PHASE_SHAPES`` the kernel runs
    the table's shape (``event_shape`` reads the library's) and matches its
    plain version."""
    sim = card_sims[dtype]
    name = hot_kernels.entry_point("event_phase", dtype)
    for ks in _shape_edges(dtype):
        for k in ks:
            shape = hot_kernels.event_shape(name, k)
            assert shape == hot_kernels.event_phase_shape(k, dtype), k
            ref, got, _ = _card_phase(sim, max(4 * k, 4096), k, 80 + k, "room")
            rec, fails = hot_kernels.compare_event_phase(name, ref, got)
            assert not fails, (k, shape, fails)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 4096, 65536])
def test_compact_kernel_matches_the_sort_on_the_card(n):
    _card()
    rng = np.random.default_rng(n + 1)
    for density in (0.0, 0.03, 0.5, 1.0):
        mask = torch.as_tensor(rng.random(n) < density, device="cuda")
        count = int(mask.sum())
        for k in sorted({1, max(1, count // 2), max(1, count), n // 8, n}):
            got = hot_kernels.compact(mask, k)
            want = engine.compact_idx(mask, k)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (density, k)
    # a mask that is a view at an odd offset: byte loads
    base = torch.as_tensor(rng.random(n + 3) < 0.3, device="cuda")
    mask = base[3:]
    for g, w in zip(hot_kernels.compact(mask, n // 8), engine.compact_idx(mask, n // 8)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_event_phase_refuses_fields_that_share_memory(card_sims):
    sim = card_sims[torch.float32]
    eng = sim.engine
    pool, sec, counters, den = hot_kernels.synthetic_event_pool(eng, 512, 256, 9, "room")
    sel, room, wedged = engine.event_set(pool, sec, 256)
    key = torch.tensor([1, 2], dtype=torch.int64, device="cuda")
    for bad in (dict(alive=pool.occupied), dict(bi=pool.alpha_absi), dict(w=pool.sec_w)):
        with pytest.raises(ValueError, match="shares memory"):
            hot_kernels.event_phase(pool._replace(**bad), counters, sel, room, wedged, den,
                                    sim.mc, sim.tables, key=key)


@pytest.mark.cuda
@pytest.mark.parametrize("reference", [False, True], ids=["shipped", "reference"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_graphed_block_equals_the_eager_one(dump, dtype, reference):
    """A wave and its cascade at pool 1,024, graphed and issued op by op on
    the same seed: the same state bit for bit (the spectrum to rtol 1e-6,
    float atomics), the same launches, with the event phase, the
    compaction and the ring's pack on the path and the parts they replace
    off it."""
    _card()
    out = {}
    for graphed in (True, False):
        cfg = (profiles.reference_config(pool=1024, dtype=dtype, stall_steps=2000) if reference
               else profiles.bench_config(pool=1024, dtype=dtype))
        sim = driver.Simulation(dump, photon_n=300, mass_unit=4e19, device="cuda", config=cfg,
                                emit_chunk=1024, warmup=0, graphed=graphed, seed=5)
        hot_kernels.reset_launches()
        spec, stats = sim.run()
        out[graphed] = (spec, stats, engine.state_tensors(sim.state), dict(hot_kernels.launches))
    (sg, tg, xg, lg), (se, te, xe, le) = out[True], out[False]
    assert all(torch.equal(a, b) or (a.is_floating_point() and torch.equal(
        a.view(torch.int64 if a.element_size() == 8 else torch.int32),
        b.view(torch.int64 if b.element_size() == 8 else torch.int32))) for a, b in zip(xg, xe))
    np.testing.assert_allclose(sg, se, rtol=1e-6, atol=0.0)
    # the loop's own launches: the exit test at each run's entry and at the
    # end of each block; the gated sweep in each block (eager) or each of a
    # replay's blocks
    k, runs = engine.GRAPH_BODIES, tg["engine_runs"]
    record = hot_kernels.entry_point("record_phase", dtype)
    rec_g, rec_e = lg.pop(record), le.pop(record)
    assert lg.pop("exit_test") == le.pop("exit_test") == runs + te["bodies"]
    assert rec_g - rec_e == k * tg["replays"] - te["bodies"]
    assert lg == le and tg["hot_iters"] == te["hot_iters"] > 0
    assert tg["bodies"] == te["bodies"] == tg["full_phases"] and te["replays"] == 0
    assert lg[hot_kernels.entry_point("event_phase", dtype)] == tg["full_phases"]
    assert lg[hot_kernels.entry_point("compact_rows", dtype)] == tg["full_phases"]
    assert lg["compact"] >= 2 * tg["full_phases"] + tg["light_phases"]
    sweep, rec, free = (hot_kernels.RECORD_SWEEP, hot_kernels.RECORD_RECORD,
                        hot_kernels.RECORD_FREE)
    kernels = sum(f * (hot_kernels.record_launches(sweep) + hot_kernels.record_launches(
                  rec | free)) + li * hot_kernels.record_launches(sweep | rec | free)
                  + fl * hot_kernels.record_launches(rec)
                  for _, f, li, fl in te["engine_phases"])
    assert rec_e == kernels
    assert kernels >= 2 * tg["full_phases"] + tg["light_phases"]
    for off in ("row_gather", "event_fluid", "scatter_event"):
        assert lg[hot_kernels.entry_point(off, dtype)] == 0, off
