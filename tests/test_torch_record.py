"""The phases' record, frees and refill as kernels (``csrc/record.cu``,
``hot_kernels.record_phase``; refill's sources in ``csrc/fresh_init.cu``,
``hot_kernels.refill_fresh``).

* CPU: ``engine.record_phase_plain`` (the poison sweep, the record and the
  frees, composed) is bit for bit the code it replaced (the engine's
  ``_poison_sweep``, ``spectrum_add`` and the frees of
  ``_record_free_refill``, kept here as ``_record_before``) on seeded pools
  (``hot_kernels.synthetic_record``: more pending lanes than the width,
  poisoned lanes, NaN energies, lanes holding events, lanes out of the
  bins, stalled lanes, lanes that escape on their crossing step), in
  float32 and float64, both semantics, the birth trace on and off, every
  stage alone and together; the Python model of the kernels' tiles
  (``record_tiles``: the tiles' counts, each block's ranks, its counters,
  the last block's sum, the ratchet and the capture with the pad's
  values) equals the plain version; ``hot_kernels.refill_fresh`` on the CPU
  is refill's slots through ``engine.refill_sources_plain`` followed by
  ``engine.init_fresh_plain``, bit for bit; the engine's phases run
  through the wrappers.
* On the card (``cuda`` tests, ``python -m pytest --noconftest -m cuda
  tests/test_torch_record.py``): the record kernel against the plain
  version at the path's widths (``hot_kernels.RECORD_WIDTHS``: 65,536 x
  16,384 and 12,288, 4,096 and 512 lanes, each also cut below its pending
  lanes) in both dtypes (``hot_kernels.compare_record``: the flags, the
  counters, the ratchet and the capture bit for bit; the spectrum and
  w_stall within the slack of their sums' order, the atomics'), in place,
  every stage alone; a NaN tau_scatt (refill's sources and the track
  start against their plain versions: ``tests/test_torch_fresh_init.py``);
  the compaction of the clear lanes; the
  record, the compaction and the refill captured in a CUDA graph and
  replayed twice, each replay the eager launches' result.
"""

import numpy as np
import pytest
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.models import torus
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

TILE = 1024  # csrc/record.cu TILE: a block's lanes
MODES = {"light": (True, True, True), "sweep": (True, False, False),
         "full": (False, True, True), "flush": (False, True, False)}


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return str(path)


@pytest.fixture(scope="module")
def cpu_sim(dump):
    return driver.Simulation(dump, photon_n=100, mass_unit=4e19, device="cpu",
                             config=profiles.bench_config(pool=512, dtype=torch.float64),
                             emit_chunk=256, warmup=0)


def _record_before(p, spec, counters, width, mc, cfg, sweep, record, free):
    """The engine's sweep, record and frees before they became one kernel
    (``Engine._poison_sweep``, ``Engine.spectrum_add`` and the frees of
    ``Engine._record_free_refill``), verbatim but for ``self``."""
    take_cols, put_cols, isnan4 = engine.take_cols, engine.put_cols, engine.isnan4
    if sweep:
        poison = p.occupied & (isnan4(p.x) | isnan4(p.k) | torch.isnan(p.w))
        p = p._replace(
            alive=p.alive & ~poison, occupied=p.occupied & ~poison,
            record_pending=p.record_pending & ~poison, at_event=p.at_event & ~poison,
            ev_pending=p.ev_pending & ~poison)
    occ0, rec0 = p.occupied, p.record_pending
    if record:
        dt = cfg.dtype
        bad = p.record_pending & (torch.isnan(p.w) | torch.isnan(p.e))
        rec = p.record_pending & ~bad & ~p.ev_pending
        valid, gi, sidx = hot_kernels.compact(rec, width)
        (x2g, x3g, w, e, nsc, nsc0_g, x1ig, x2ig, tabs_g, tsc_g, ne0_g,
         te0_g, b0_g, e0_g, occ_g, rp_g) = take_cols(
            gi, [p.x[2], p.x[3], p.w, p.e, p.n_scatt, p.nsc0, p.x1i, p.x2i,
                 p.tau_abs, p.tau_scatt, p.n_e_0, p.theta_e_0, p.b_0,
                 p.e_0, p.occupied, p.record_pending])
        dx2 = (mc.x_stop[2] - mc.x_start[2]) / (2.0 * consts.N_TH_BINS)
        mid = 0.5 * (mc.x_start[2] + mc.x_stop[2])
        ix2 = torch.where(x2g < mid, torch.floor(x2g / dx2),
                          torch.floor((mc.x_stop[2] - x2g) / dx2)).to(torch.int64)
        l_e = torch.log(torch.clamp(e, min=1e-30))
        i_e = torch.floor((l_e - consts.spectrum.L_E_0) / consts.spectrum.D_L_E
                          + 2.5).to(torch.int64) - 2
        in_bins = ((ix2 >= 0) & (ix2 < consts.N_TH_BINS) & (i_e >= 0)
                   & (i_e < consts.N_E_BINS))
        ok = valid & in_bins
        idx = torch.where(ok, ix2 * consts.N_E_BINS + i_e, engine.DUMP_BIN)
        we = w * e
        vals = torch.stack([
            w, we, torch.ones_like(w), nsc.to(dt), w * x1ig, w * x2ig * x2ig,
            w * x3g * x3g, w * tabs_g, w * tsc_g, w * ne0_g, w * te0_g, w * b0_g,
            w * e0_g, we * we, (nsc0_g > 0).to(dt), nsc0_g.to(dt)], dim=-1)
        vals = torch.where(ok[:, None], vals, 0.0)
        spec = spec.index_add(0, idx, vals)
        if cfg.trace_birth:
            bcols = take_cols(gi, [*p.bx, *p.bk, p.bw])
            tvals = torch.where(valid, tsc_g, -1.0)
            am = torch.argmax(tvals).reshape(1)
            better = tvals.index_select(0, am)[0] > counters.max_tau_scatt
            birth = torch.stack(bcols).index_select(1, am)[:, 0]

            def sel(new, cur):
                return torch.where(better, new, cur)

            counters = counters._replace(
                mt_bx=sel(birth[0:4], counters.mt_bx), mt_bk=sel(birth[4:8], counters.mt_bk),
                mt_bw=sel(birth[8], counters.mt_bw),
                mt_nsc0=sel(nsc0_g.index_select(0, am)[0].to(torch.int64), counters.mt_nsc0))
        counters = counters._replace(
            n_recorded=counters.n_recorded + ok.sum(),
            n_scatt_rec=counters.n_scatt_rec + torch.where(ok, nsc, 0).sum(),
            max_tau_scatt=torch.maximum(
                counters.max_tau_scatt,
                torch.amax(torch.where(valid, tsc_g, 0.0))),
        )
        occ_n, rp_n = put_cols(sidx, [(p.occupied, occ_g & ~valid),
                                      (p.record_pending, rp_g & ~valid)])
        p = p._replace(occupied=occ_n & ~bad, record_pending=rp_n & ~bad,
                       ev_pending=p.ev_pending & ~bad)
    if free:
        p = p._replace(occupied=p.occupied & (p.alive | p.record_pending | p.ev_pending))
        freed = occ0 & ~p.occupied
        stalled = (freed & (p.n_step > cfg.stall_steps)
                   & ~(rec0 & ~p.record_pending))
        counters = counters._replace(
            n_retired=counters.n_retired + freed.sum(),
            n_steps_retired=counters.n_steps_retired
            + torch.where(freed, p.n_step, 0).sum(),
            n_stall=counters.n_stall + stalled.sum(),
            w_stall=counters.w_stall + torch.where(stalled, p.w, 0.0).sum(),
        )
    return p, spec, counters


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and bool(hot_kernels._same_bits(a, b).all())


def _assert_same(got, want):
    for f in engine.Pool._fields:
        assert _same(getattr(got[0], f), getattr(want[0], f)), f
    assert _same(got[1], want[1])
    for f in engine.Counters._fields:
        assert _same(getattr(got[2], f), getattr(want[2], f)), f


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("reference", [False, True], ids=["shipped", "reference"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_record_phase_plain_is_the_code_it_replaced(cpu_sim, dtype, reference, trace, mode):
    sweep, record, free = MODES[mode]
    for n, k, seed in ((4096, 512, 1), (4096, 4096, 2), (512, 64, 3), (512, 512, 4)):
        pool, spec, counters, cfg = hot_kernels.synthetic_record(
            cpu_sim.mc, n, k, seed, dtype, "cpu", reference=reference, trace_birth=trace)
        want = _record_before(pool, spec, counters, k, cpu_sim.mc, cfg, sweep, record, free)
        got = engine.record_phase_plain(pool, spec, counters, k, cpu_sim.mc, cfg, sweep=sweep,
                                        record=record, free=free)
        _assert_same(got, want)
        wrapped = hot_kernels.record_phase(pool, spec, counters, k, cpu_sim.mc, cfg,
                                           sweep=sweep, record=record, free=free)
        _assert_same(wrapped, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_the_pools_hold_every_kind_of_lane(cpu_sim, dtype):
    """The synthetic pools reach what the checks need: more pending lanes
    than a cut width, poisoned and bad lanes, lanes holding an event,
    recorded lanes out of the bins, stalled lanes, lanes that escape on
    their crossing step (recorded, past the cap, not stalled), a capture."""
    mc = cpu_sim.mc
    pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, 4096, 512, 1, dtype, "cpu")
    p0 = engine.poison_sweep_plain(pool)
    assert int((pool.occupied & ~p0.occupied).sum()) > 0
    rec = p0.record_pending & ~p0.ev_pending & ~torch.isnan(p0.w) & ~torch.isnan(p0.e)
    assert int(rec.sum()) > 512 and int((p0.record_pending & p0.ev_pending).sum()) > 0
    assert int((p0.record_pending & torch.isnan(p0.e)).sum()) > 0
    p, _, c = engine.record_phase_plain(pool, spec, counters, 512, mc, cfg)
    recorded = p0.record_pending & ~p.record_pending & ~torch.isnan(p0.e) & ~torch.isnan(p0.w)
    assert int(recorded.sum()) == 512 > int(c.n_recorded - counters.n_recorded) > 0
    assert int(c.n_stall - counters.n_stall) > 0
    assert int((recorded & (p0.n_step > cfg.stall_steps)).sum()) > 0
    assert not torch.equal(c.mt_bx, counters.mt_bx)
    assert bool(c.max_tau_scatt > counters.max_tau_scatt)
    nan = hot_kernels.synthetic_record(mc, 512, 512, 5, dtype, "cpu", nan_tau=True)
    assert bool(torch.isnan(engine.record_phase_plain(*nan[:3], 512, mc, nan[3])[2]
                            .max_tau_scatt))


def record_tiles(pool, spec, counters, width, mc, cfg, sweep=True, record=True, free=True):
    """The Python model of ``record_phase`` on the card: blocks of ``TILE``
    lanes; the sweep; each tile's rec count; each block's ranks from the
    counts of the tiles before it, its records (the spectrum's adds a block
    at a time), frees and counters; the last block's sum and ``finish``
    (the ratchet against the K slots' amax, 0 on the pad; the capture at
    the first lane of the largest valid tau_scatt, or at lane n - 1 with -1
    where the pad wins; none where a valid tau_scatt is NaN).  Returns
    (pool, spec, counters)."""
    n, dt = pool.w.shape[0], pool.w.dtype
    p = engine.clone_pool(pool)
    spec = spec.clone()
    if sweep:
        p = engine.poison_sweep_plain(p)
    occ0, rp0 = p.occupied.clone(), p.record_pending.clone()
    bad = record & rp0 & (torch.isnan(p.w) | torch.isnan(p.e))
    rec = record & rp0 & ~bad & ~p.ev_pending
    blocks = -(-n // TILE)
    counts = [int(rec[b * TILE:(b + 1) * TILE].sum()) for b in range(blocks)]
    parts = []
    occ, rp, evp = occ0.clone(), rp0.clone(), p.ev_pending.clone()
    for b in range(blocks):
        lanes = torch.arange(b * TILE, min(n, (b + 1) * TILE))
        r = rec[lanes]
        rank = sum(counts[:b]) + torch.cumsum(r.to(torch.int64), 0) - 1
        valid = lanes[r & (rank < width)]
        n_ok = n_nsc = 0
        if valid.numel():  # the block's records: its lanes' adds, in lane order
            one = engine.Pool(*(tuple(t[valid] for t in v) if isinstance(v, tuple) else v[valid]
                                for v in p))
            spec, cc, _ = engine.spectrum_add_plain(
                spec, engine.init_counters(-np.inf, dt, "cpu"),
                one._replace(record_pending=torch.ones_like(one.occupied),
                             ev_pending=torch.zeros_like(one.occupied)), valid.numel(), mc)
            n_ok, n_nsc = int(cc.n_recorded), int(cc.n_scatt_rec)
        occ[valid], rp[valid] = False, False
        tsc = p.tau_scatt[valid]
        fin = ~torch.isnan(tsc)
        tmax, tlane = -np.inf, 1 << 31
        if bool(fin.any()):
            m = tsc[fin].max()
            tmax, tlane = m, int(valid[fin][tsc[fin] == m][0])
        parts.append(dict(n_ok=n_ok, n_nsc=n_nsc, n_valid=valid.numel(), tmax=tmax,
                          tlane=tlane, tnan=bool((~fin).any())))
    occ &= ~bad
    rp &= ~bad
    evp &= ~bad
    out = counters
    if free:
        occ &= p.alive | rp | evp
        freed = occ0 & ~occ
        stalled = freed & (p.n_step > cfg.stall_steps) & ~(rp0 & ~rp)
        out = out._replace(n_retired=out.n_retired + freed.sum(),
                           n_steps_retired=out.n_steps_retired + p.n_step[freed].sum(),
                           n_stall=out.n_stall + stalled.sum(),
                           w_stall=out.w_stall + p.w[stalled].sum())
    if record:
        nv = sum(q["n_valid"] for q in parts)
        tnan = any(q["tnan"] for q in parts)
        tmax, tlane = -np.inf, 1 << 31
        for q in parts:  # the first lane of the largest, over the blocks
            if q["tmax"] > tmax or (q["tmax"] == tmax and q["tlane"] < tlane):
                tmax, tlane = q["tmax"], q["tlane"]
        old = counters.max_tau_scatt
        tmax = torch.as_tensor(tmax, dtype=dt)
        at, lane = tmax, tlane
        if nv < width and (nv == 0 or bool(tmax < -1.0)):
            at, lane = torch.tensor(-1.0, dtype=dt), n - 1
        amax = torch.clamp(tmax, min=0.0) if nv < width else tmax
        if tnan:
            amax = torch.tensor(float("nan"), dtype=dt)
        if cfg.trace_birth and not tnan and bool(at > old):
            out = out._replace(
                mt_bx=torch.stack([x[lane] for x in p.bx]),
                mt_bk=torch.stack([x[lane] for x in p.bk]), mt_bw=p.bw[lane],
                mt_nsc0=p.nsc0[lane].to(torch.int64))
        out = out._replace(
            n_recorded=out.n_recorded + sum(q["n_ok"] for q in parts),
            n_scatt_rec=out.n_scatt_rec + sum(q["n_nsc"] for q in parts),
            max_tau_scatt=torch.maximum(old, amax))
    return p._replace(occupied=occ, record_pending=rp, ev_pending=evp), spec, out


@pytest.mark.parametrize("nan_tau", [False, True], ids=["finite", "nan_tau"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n,k", [(4096, 512), (4096, 4096), (3000, 1500), (512, 64),
                                 (512, 512), (700, 700)])
def test_the_kernels_tiles_equal_the_plain_version(cpu_sim, n, k, mode, nan_tau):
    sweep, record, free = MODES[mode]
    pool, spec, counters, cfg = hot_kernels.synthetic_record(
        cpu_sim.mc, n, k, n + k, torch.float64, "cpu", nan_tau=nan_tau)
    want = engine.record_phase_plain(pool, spec, counters, k, cpu_sim.mc, cfg, sweep=sweep,
                                     record=record, free=free)
    got = record_tiles(pool, spec, counters, k, cpu_sim.mc, cfg, sweep, record, free)
    rec, fails = hot_kernels.compare_record(pool, spec, counters, want, got)
    assert not fails, (fails, rec)


def test_the_ratchets_pad_and_capture_edges(cpu_sim):
    """A batch with no pending lane (the K slots all pad: the ratchet meets
    0, the capture reads -1 at lane n - 1) and one whose pending lanes all
    lie below the ratchet: the model and the plain version agree."""
    mc = cpu_sim.mc
    pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, 2048, 300, 9, torch.float64,
                                                             "cpu")
    cases = {"none": pool._replace(record_pending=torch.zeros_like(pool.record_pending)),
             "below": pool._replace(tau_scatt=pool.tau_scatt * 1e-6)}
    out = {}
    for name, p in cases.items():
        for old in (counters.max_tau_scatt, torch.tensor(-2.0).double()):
            c = counters._replace(max_tau_scatt=old)
            want = engine.record_phase_plain(p, spec, c, 300, mc, cfg)
            got = record_tiles(p, spec, c, 300, mc, cfg)
            assert not hot_kernels.compare_record(p, spec, c, want, got)[1], name
            out[name, float(old)] = want[2]
    none = out["none", -2.0]  # every slot a pad: 0 and -1 (lane n - 1) pass -2
    assert bool(none.max_tau_scatt == 0.0) and bool(none.mt_bw == pool.bw[-1])
    assert torch.equal(out["below", float(counters.max_tau_scatt)].mt_bx, counters.mt_bx)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("reference", [False, True], ids=["shipped", "reference"])
def test_refill_fresh_is_refill_then_the_start(dump, reference, trace):
    """``hot_kernels.refill_fresh`` on the CPU equals refill's slots
    (``Engine.refill_slots``) through ``engine.refill_sources_plain``
    followed by ``engine.init_fresh_plain`` bit for bit (every pool field,
    the ring, the backlog position, the counters), on a pool with free
    lanes beyond the slots, a partly filled ring and a backlog that runs
    out; ``refill_sources_plain`` on the synthetic refill's slots gives the
    sources ``synthetic_fresh`` made."""
    cfg = (profiles.reference_config(pool=512, dtype=torch.float64) if reference
           else profiles.bench_config(pool=512, dtype=torch.float64))
    cfg = cfg._replace(refill_k=384, sec_cap=96, trace_birth=trace)
    sim = driver.Simulation(dump, photon_n=100, mass_unit=4e19, config=cfg, device="cpu",
                            emit_chunk=256, warmup=0)
    eng = sim.engine
    sim.plan()
    rng = np.random.default_rng(7)
    backlog = sim.emit_rows(0, 256)
    ring = sim.emit_rows(256, 96).flip(0).contiguous()
    state = eng.fresh_state()
    occupied = torch.as_tensor(rng.random(512) < 0.3)
    pool = state.pool._replace(occupied=occupied, w=torch.as_tensor(rng.uniform(1, 2, 512)))
    sec = state.sec._replace(rows=ring, count=torch.tensor(40))
    pos, counters = torch.tensor(3), state.counters._replace(n_created=torch.tensor(5))
    den = eng._bias_den(counters)
    for n_valid in (250, torch.tensor(120)):
        slots = eng.refill_slots(sec, pool.occupied, backlog, pos, n_valid)
        s1, p1, c1, load = engine.refill_sources_plain(slots, counters)
        want = engine.init_fresh_plain(pool, load, den, eng.mc, eng.tables, eng.cfg)
        got, s2, p2, c2 = hot_kernels.refill_fresh(pool, slots, counters, den, eng.mc,
                                                   eng.tables, eng.cfg, eng._fresh_ticket)
        for f in engine.Pool._fields:
            assert _same(getattr(got, f), getattr(want, f)), f
        assert _same(tuple(s2), tuple(s1)) and _same(p2, p1) and _same(tuple(c2), tuple(c1))
        assert int(c2.n_created) > 5 and int(s2.count) < 40
    for k in (512, 4096):
        p, slots, c, den, fcfg = hot_kernels.synthetic_refill(sim.mc, k, k, 30 + k,
                                                              torch.float64, "cpu")
        _, _, _, load = engine.refill_sources_plain(slots, c)
        ref = hot_kernels.synthetic_fresh(sim.mc, k, k, 30 + k, torch.float64, "cpu")[1]
        assert all(_same(a, b) for a, b in zip(load, ref))  # the rows hold NaNs


def test_the_phases_run_through_the_wrappers(cpu_sim, monkeypatch):
    """A light phase is one record (sweep, record, frees), one compaction of
    the free lanes and one refill; a full phase adds the sweep's own call
    before its event set."""
    sim, eng = cpu_sim, cpu_sim.engine
    sim.plan()
    backlog = sim.emit_rows(0, 1024)
    names = ("record_phase", "compact", "refill_fresh", "event_phase")
    calls = {name: [] for name in names}
    for name in names:
        fn = getattr(hot_kernels, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name].append({k: kw[k] for k in ("sweep", "record", "free", "invert")
                                 if k in kw})
            return _fn(*a, **kw)

        monkeypatch.setattr(hot_kernels, name, counted)
    state = eng.periodic_phase(eng.fresh_state(), backlog)
    assert calls["record_phase"] == [dict(sweep=True, record=False, free=False),
                                     dict(sweep=False, record=True, free=True)]
    assert calls["compact"] == [{}, dict(invert=True)]
    assert len(calls["refill_fresh"]) == len(calls["event_phase"]) == 1
    for v in calls.values():
        v.clear()
    eng.light_phase(state, backlog)
    assert calls == {"record_phase": [dict(sweep=True, record=True, free=True)],
                     "compact": [dict(invert=True)], "refill_fresh": [{}], "event_phase": []}


def test_the_ema_marks_are_copies(cpu_sim):
    """The full phase's EMA marks are tensors of their own: the record adds
    to n_recorded and n_scatt_rec in place on the card."""
    sim, eng = cpu_sim, cpu_sim.engine
    sim.plan()
    state = eng.periodic_phase(eng.fresh_state(), sim.emit_rows(0, 512))
    c = state.counters
    assert c.ema_rec_mark.data_ptr() != c.n_recorded.data_ptr()
    assert c.ema_scatt_mark.data_ptr() != c.n_scatt_rec.data_ptr()


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


def _kernel_record(pool, spec, counters, k, mc, cfg, **mode):
    work = hot_kernels.clone_record(pool, spec, counters)
    ticket = hot_kernels.record_ticket("cuda")
    before = dict(hot_kernels.launches)
    got = hot_kernels.record_phase(*work, k, mc, cfg, ticket, **mode)
    torch.cuda.synchronize()
    name = hot_kernels.entry_point("record_phase", pool.w.dtype)
    mode = sum(bit for stage, bit in (("sweep", hot_kernels.RECORD_SWEEP),
                                      ("record", hot_kernels.RECORD_RECORD),
                                      ("free", hot_kernels.RECORD_FREE))
               if mode.get(stage, True))
    ranks = mode & (hot_kernels.RECORD_SWEEP | hot_kernels.RECORD_RECORD)
    kernels = 2 if pool.w.shape[0] > 1024 and mode & ~hot_kernels.RECORD_SWEEP and ranks else 1
    assert hot_kernels.record_launches(pool.w.shape[0], mode) == kernels
    assert hot_kernels.launches[name] == before[name] + kernels
    assert sum(hot_kernels.launches.values()) == sum(before.values()) + kernels
    assert got[0] is work[0] and got[1] is work[1] and got[2] is work[2]
    assert all(a is b for a, b in zip(hot_kernels._flat(got[0]._asdict()).values(),
                                      hot_kernels._flat(work[0]._asdict()).values()))
    assert int(ticket) == 0
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n,k", hot_kernels.RECORD_WIDTHS,
                         ids=[f"{n}x{k}" for n, k in hot_kernels.RECORD_WIDTHS])
def test_record_phase_matches_plain_on_the_card(card_sims, n, k, dtype, trace):
    mc = card_sims[dtype].mc
    pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, n, k, n + k, dtype, "cuda",
                                                             trace_birth=trace)
    for mode in MODES.values():
        sweep, record, free = mode
        want = engine.record_phase_plain(pool, spec, counters, k, mc, cfg, sweep=sweep,
                                         record=record, free=free)
        got = _kernel_record(pool, spec, counters, k, mc, cfg, sweep=sweep, record=record,
                             free=free)
        rec, fails = hot_kernels.compare_record(pool, spec, counters, want, got)
        assert not fails, (mode, fails, rec)
        if mode == MODES["light"]:
            assert rec["recorded"] > 0 and rec["freed"] > 0 and rec["stalled"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [512, 65536])
def test_a_nan_tau_scatt_on_the_card(card_sims, n, dtype):
    mc = card_sims[dtype].mc
    pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, n, n // 4, 77, dtype, "cuda",
                                                             nan_tau=True)
    want = engine.record_phase_plain(pool, spec, counters, n // 4, mc, cfg)
    got = _kernel_record(pool, spec, counters, n // 4, mc, cfg)
    assert bool(torch.isnan(want[2].max_tau_scatt))
    assert not hot_kernels.compare_record(pool, spec, counters, want, got)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 4096, 4097, 65536])
def test_compact_of_the_clear_lanes_on_the_card(n):
    _card()
    rng = np.random.default_rng(n)
    for density in (0.0, 0.3, 0.9, 1.0):
        mask = torch.as_tensor(rng.random(n) < density, device="cuda")
        for k in (1, n // 8, n):
            got = hot_kernels.compact(mask, k, invert=True)
            want = engine.compact_idx(~mask, k)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (density, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_the_record_and_refill_replay_from_a_graph(card_sims, dtype):
    """A light phase's three calls (the record, the compaction of the free
    lanes, the refill) captured in one CUDA graph and replayed twice on the
    same inputs (restored between the replays) give the eager launches'
    result: every flag, counter (w_stall too: the blocks' sums in a fixed
    order) and pool field bit for bit, the spectrum within its sums' slack;
    both tickets back at zero."""
    import gc

    sim = card_sims[dtype]
    n, k = 65536, 12288
    pool, spec, counters, cfg = hot_kernels.synthetic_record(sim.mc, n, k, 123, dtype, "cuda",
                                                             trace_birth=True)
    _, slots, _, den, fcfg = hot_kernels.synthetic_refill(sim.mc, n, k, 321, dtype, "cuda",
                                                          trace_birth=True)
    cfg = fcfg._replace(stall_steps=cfg.stall_steps)
    work = hot_kernels.clone_record(pool, spec, counters)
    wsec = engine.SecBuf(slots.sec.rows, slots.sec.count.clone())
    wpos = slots.backlog_pos.clone()
    tickets = hot_kernels.record_ticket("cuda"), hot_kernels.fresh_ticket("cuda")

    def phase():
        p, s, c = hot_kernels.record_phase(*work, k, sim.mc, cfg, tickets[0])
        valid, _, sidx = hot_kernels.compact(p.occupied, k, invert=True)
        sl = slots._replace(valid=valid, sidx=sidx, sec=wsec, backlog_pos=wpos)
        hot_kernels.refill_fresh(p, sl, c, den, sim.mc, sim.tables, cfg, tickets[1])

    def restore():
        for dst, src in zip(engine.state_tensors(engine.State(work[0], work[1], work[2], wsec,
                                                              wpos, 0)),
                            engine.state_tensors(engine.State(pool, spec, counters, slots.sec,
                                                              slots.backlog_pos, 0))):
            dst.copy_(src)

    def snap():
        return [t.clone() for t in engine.state_tensors(
            engine.State(work[0], work[1], work[2], wsec, wpos, 0))]

    phase()
    torch.cuda.synchronize()
    eager = snap()
    restore()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        phase()
    torch.cuda.current_stream().wait_stream(stream)
    restore()
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            phase()
    finally:
        gc.enable()
    spec_at = sum(len(v) if isinstance(v, tuple) else 1 for v in pool)
    adds = (eager[spec_at][:, 2:3] - spec[:, 2:3]).round()
    slack = 2.0 * hot_kernels.sum_slack(spec, eager[spec_at], adds)
    for _ in range(2):
        restore()
        graph.replay()
        torch.cuda.synchronize()
        got = snap()
        assert not bool(tickets[0].any()) and not bool(tickets[1].any())
        for j, (a, b) in enumerate(zip(got, eager, strict=True)):
            if j == spec_at:  # both the atomics' sums
                assert bool((torch.abs(a - b) <= slack).all())
            else:
                assert bool(hot_kernels._same_bits(a, b).all()), j
