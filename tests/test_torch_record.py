"""The phases' record, frees and refill as kernels (``csrc/record.cu``,
``hot_kernels.record_phase``; refill's sources in ``csrc/fresh_init.cu``,
``hot_kernels.refill_fresh``), and the bias's terms the record writes.

* CPU: ``engine.record_phase_plain`` (the poison sweep, the record and the
  frees, composed) is bit for bit the code it replaced (the engine's
  ``_poison_sweep``, ``spectrum_add`` and the frees of
  ``_record_free_refill``, kept here as ``_record_before``) on seeded pools
  (``hot_kernels.synthetic_record``: more pending lanes than the width,
  poisoned lanes, NaN energies, lanes holding events, lanes out of the
  bins, stalled lanes, lanes that escape on their crossing step), in
  float32 and float64, both semantics, the birth trace on and off, every
  stage alone and together; ``engine.bias_terms_plain`` is bit for bit the
  bias's denominator, scale and EMA fold it replaced (``_bias_before``),
  shipped, reference and frozen; the Python model of the kernel
  (``record_tiles``: one launch, the tiles' ranks by the decoupled
  look-back in a random schedule, each warp's adds merged by row, each
  block's counters, the last block's sum, the ratchet and the capture with
  the pad's values, the EMA fold and the terms) equals the plain version;
  after a full and a light phase from a JAX state the
  engine's bias terms are the JAX engine's; ``hot_kernels.refill_fresh``
  on the CPU is refill's slots through ``engine.refill_sources_plain``
  followed by ``engine.init_fresh_plain``, bit for bit; the engine's
  phases run through the wrappers.
* On the card (``cuda`` tests, ``python -m pytest --noconftest -m cuda
  tests/test_torch_record.py``): the record kernel against the plain
  version at the path's widths (``hot_kernels.RECORD_WIDTHS``: 65,536 x
  16,384, 12,288 and 65,536 (the closing flush), 4,096 and 512 lanes,
  each also cut below its pending lanes) and at widths no tile divides, in both dtypes
  (``hot_kernels.compare_record``: the flags, the counters, the ratchet,
  the capture, the fold and the terms bit for bit; the spectrum and
  w_stall within the slack of their sums' order), one launch a call (the
  kernels ``torch.profiler`` traces, not only the wrapper's count), in
  place, the scratch at rest after every call and graph replay, every
  stage alone; a NaN tau_scatt; the terms in both semantics and under the
  frozen bias, and an engine's phases leaving its terms the plain ones
  (refill's sources and the track start against their plain versions:
  ``tests/test_torch_fresh_init.py``); the compaction of the clear lanes;
  the record, the compaction and the refill captured in a CUDA graph and
  replayed, each replay the eager launches' result.
"""

import functools
import math

import numpy as np
import pytest
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.models import torus
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

ONE_TILE = 1024  # csrc/record.cu ONE_TILE: the one block's lanes
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


def _kernel_terms(counters, rec, nsc, max_tau, bias_norm, dt, reference, fold):
    """The record's last block's fold and terms (``csrc/record.cu``
    bias_finish), operation by operation on 0-d tensors of ``dt``: the
    folded counters and ``engine.BiasTerms``."""
    def c(v):
        return torch.tensor(v, dtype=dt)

    avg0 = avg1 = counters.avg_ema
    out = counters
    if fold:
        d_s = (nsc - counters.ema_scatt_mark).to(dt)
        d_r = (rec - counters.ema_rec_mark).to(dt)
        a = c(engine.BIAS_EMA) if bool(d_r > 0.0) else c(0.0)
        t1, t2 = (c(1.0) - a) * avg0, a * d_s
        avg1 = t1 + t2 / (d_r if bool(d_r > 1.0) else c(1.0))
        out = counters._replace(avg_ema=avg1, ema_scatt_mark=nsc.clone(),
                                ema_rec_mark=rec.clone())

    def den(avg):
        if reference:
            avg = nsc.to(dt) / (rec.to(dt) + c(1.0))
        return c(bias_norm) * (max_tau * (avg + c(2.0)))

    d = den(avg1)
    return out, engine.BiasTerms(den(avg0), d, (c(1.0) / d) * c(100.0))


def _look_back(counts, rng):
    """Each tile's rec lanes before it, by the decoupled look-back: the
    tiles' blocks, scheduled in a random order, each publish their count,
    then read their predecessors' status words 128 at a time (four a
    lane), nearest first, waiting while any of the 128 is unpublished,
    until one holds an inclusive prefix, then publish their own."""
    status = [None] * len(counts)  # None, ("agg", count) or ("incl", prefix)
    before, waiting = {}, set(range(len(counts)))
    while waiting:
        b = int(rng.choice(sorted(waiting)))
        if status[b] is None:
            status[b] = ("incl", counts[0]) if b == 0 else ("agg", counts[b])
            if b == 0:
                before[b] = 0
                waiting.discard(b)
            continue
        acc, top = 0, b - 1
        while True:
            window = [status[q] if q >= 0 else ("incl", 0) for q in range(top, top - 128, -1)]
            if any(w is None for w in window):
                break  # waits: another block runs first
            near = next((j for j, w in enumerate(window) if w[0] == "incl"), None)
            acc += sum(w[1] for w in window[:128 if near is None else near + 1])
            if near is not None:
                before[b] = acc
                status[b] = ("incl", acc + counts[b])
                waiting.discard(b)
                break
            top -= 128
    return [before[b] for b in range(len(counts))]


@pytest.mark.parametrize("tiles", [1, 2, 127, 128, 129, 300])
def test_the_look_back_gives_every_tiles_prefix(tiles):
    """The look-back's model (:func:`_look_back`) gives each tile the rec
    lanes of the tiles before it under every schedule drawn, across one
    window of status words and several."""
    rng = np.random.default_rng(tiles)
    for _ in range(5):
        counts = [int(c) for c in rng.integers(0, 40, tiles)]
        assert _look_back(counts, rng) == [sum(counts[:b]) for b in range(tiles)]


def record_tiles(pool, spec, counters, width, mc, cfg, sweep=True, record=True, free=True,
                 fold=False, seed=0):
    """The Python model of ``record_phase`` on the card: one block up to
    ``ONE_TILE`` lanes, else blocks of ``hot_kernels.RECORD_TILE`` lanes;
    the sweep; each
    tile's rec count and the lanes before it by the decoupled look-back
    (:func:`_look_back`, blocks in an order drawn from ``seed``); each
    block's ranks, its records (the spectrum's adds merged in each warp's
    round: a warp of 32 threads of 4 lanes, one lane a thread a round, the
    lanes of one row summed in lane order and added once), frees and
    counters; the last block's sum and ``finish`` (the ratchet against the
    K slots' amax, 0 on the pad; the capture at the first lane of the
    largest valid tau_scatt, or at lane n - 1 with -1 where the pad wins;
    none where a valid tau_scatt is NaN), the fold and the bias's terms
    (:func:`_kernel_terms`); the sweep alone takes the terms as it finds
    the counters.  Returns ((pool, spec, counters), ``engine.BiasTerms``)."""
    n, dt = pool.w.shape[0], pool.w.dtype
    p = engine.clone_pool(pool)
    spec = spec.clone()
    if sweep:
        p = engine.poison_sweep_plain(p)
    terms = functools.partial(_kernel_terms, bias_norm=mc.bias_norm, dt=dt,
                              reference=cfg.reference, fold=fold)
    if not (record or free):
        return (p, spec, counters), terms(counters, counters.n_recorded, counters.n_scatt_rec,
                                          counters.max_tau_scatt)[1]
    occ0, rp0 = p.occupied.clone(), p.record_pending.clone()
    bad = record & rp0 & (torch.isnan(p.w) | torch.isnan(p.e))
    rec = record & rp0 & ~bad & ~p.ev_pending
    size = n if n <= ONE_TILE else hot_kernels.RECORD_TILE
    blocks = -(-n // size)
    counts = [int(rec[b * size:(b + 1) * size].sum()) for b in range(blocks)]
    before = _look_back(counts, np.random.default_rng(seed))
    assert before == [sum(counts[:b]) for b in range(blocks)]
    # every lane's bins and channels, as the plain version's operations
    dx2 = (mc.x_stop[2] - mc.x_start[2]) / (2.0 * consts.N_TH_BINS)
    mid = 0.5 * (mc.x_start[2] + mc.x_stop[2])
    x2 = p.x[2]
    ix2 = torch.where(x2 < mid, torch.floor(x2 / dx2),
                      torch.floor((mc.x_stop[2] - x2) / dx2)).to(torch.int64)
    i_e = torch.floor((torch.log(torch.clamp(p.e, min=1e-30)) - consts.spectrum.L_E_0)
                      / consts.spectrum.D_L_E + 2.5).to(torch.int64) - 2
    in_bins = (ix2 >= 0) & (ix2 < consts.N_TH_BINS) & (i_e >= 0) & (i_e < consts.N_E_BINS)
    w, we = p.w, p.w * p.e
    vals = torch.stack([
        w, we, torch.ones_like(w), p.n_scatt.to(dt), w * p.x1i, w * p.x2i * p.x2i,
        w * p.x[3] * p.x[3], w * p.tau_abs, w * p.tau_scatt, w * p.n_e_0, w * p.theta_e_0,
        w * p.b_0, w * p.e_0, we * we, (p.nsc0 > 0).to(dt), p.nsc0.to(dt)], dim=-1)
    parts = []
    occ, rp, evp = occ0.clone(), rp0.clone(), p.ev_pending.clone()
    for b in range(blocks):
        lanes = torch.arange(b * size, min(n, (b + 1) * size))
        r = rec[lanes]
        rank = before[b] + torch.cumsum(r.to(torch.int64), 0) - 1
        valid = lanes[r & (rank < width)]
        ok = torch.zeros(n, dtype=torch.bool)
        ok[valid] = in_bins[valid]
        row = torch.where(ok, ix2 * consts.N_E_BINS + i_e, -1)
        for wbase in range(b * size, min(n, (b + 1) * size), 32 * 4):
            for j in range(4):  # a round: thread t's lane wbase + 4 t + j
                group = {}
                for lane in range(wbase + j, min(n, wbase + 128), 4):
                    if int(row[lane]) >= 0:
                        group.setdefault(int(row[lane]), []).append(lane)
                for rw, members in group.items():
                    acc = vals[members[0]]
                    for m in members[1:]:
                        acc = acc + vals[m]
                    spec[rw] += acc
        occ[valid], rp[valid] = False, False
        tsc = p.tau_scatt[valid]
        fin = ~torch.isnan(tsc)
        tmax, tlane = -np.inf, 1 << 31
        if bool(fin.any()):
            m = tsc[fin].max()
            tmax, tlane = m, int(valid[fin][tsc[fin] == m][0])
        parts.append(dict(n_ok=int(ok.sum()), n_nsc=int(p.n_scatt[ok].sum()),
                          n_valid=valid.numel(), tmax=tmax, tlane=tlane,
                          tnan=bool((~fin).any())))
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
    out, bias = terms(out, out.n_recorded, out.n_scatt_rec, out.max_tau_scatt)
    return (p._replace(occupied=occ, record_pending=rp, ev_pending=evp), spec, out), bias


@pytest.mark.parametrize("nan_tau", [False, True], ids=["finite", "nan_tau"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n,k", [(4096, 512), (4096, 4096), (3000, 1500), (512, 64),
                                 (512, 512), (700, 700)])
def test_the_kernels_tiles_equal_the_plain_version(cpu_sim, n, k, mode, nan_tau):
    """The model of the kernel (:func:`record_tiles`) against the plain
    record and its terms, in one block and in tiles (widths that no tile
    divides too), both semantics, the full phase's mode also with the EMA fold."""
    sweep, record, free = MODES[mode]
    for reference in (False, True):
        pool, spec, counters, cfg = hot_kernels.synthetic_record(
            cpu_sim.mc, n, k, n + k, torch.float64, "cpu", reference=reference,
            nan_tau=nan_tau)
        for fold in (False, True) if mode == "full" and not reference else (False,):
            want, want_terms = hot_kernels.record_plain(
                pool, spec, counters, k, cpu_sim.mc, cfg, fold=fold, sweep=sweep,
                record=record, free=free)
            got, got_terms = record_tiles(pool, spec, counters, k, cpu_sim.mc, cfg, sweep,
                                          record, free, fold=fold, seed=n)
            rec, fails = hot_kernels.compare_record(pool, spec, counters, want, got,
                                                    terms=(want_terms, got_terms))
            assert not fails, (reference, fold, fails, rec)


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
            got = record_tiles(p, spec, c, 300, mc, cfg)[0]
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


def _bias_before(counters, bias_norm, dt, reference, fixed):
    """The engine's bias terms and EMA fold before the record's last block
    took them (``Engine._bias_denom``, ``_bias_den``, ``_bias_scale`` and
    the fold of ``Engine.periodic_phase``), verbatim but for ``self``:
    (den, scale, the folded counters)."""
    if fixed is not None:
        denom = fixed
    else:
        if reference:
            avg = counters.n_scatt_rec.to(dt) / (counters.n_recorded.to(dt) + 1.0)
        else:
            avg = counters.avg_ema
        denom = counters.max_tau_scatt * (avg + 2.0)
    den = bias_norm * denom
    d_s = (counters.n_scatt_rec - counters.ema_scatt_mark).to(dt)
    d_r = (counters.n_recorded - counters.ema_rec_mark).to(dt)
    a = torch.where(d_r > 0.0, engine.BIAS_EMA, 0.0).to(dt)
    folded = counters._replace(
        avg_ema=(1.0 - a) * counters.avg_ema + a * d_s / torch.clamp(d_r, min=1.0),
        ema_scatt_mark=counters.n_scatt_rec.clone(),
        ema_rec_mark=counters.n_recorded.clone())
    return den, (100.0 / den).to(dt), folded


BIAS_CASES = [(sem, dt) for sem in ("shipped", "reference", "frozen")
              for dt in (torch.float32, torch.float64)]


@pytest.mark.parametrize("semantics,dtype", BIAS_CASES,
                         ids=[f"{s}-{str(d)[6:]}" for s, d in BIAS_CASES])
def test_bias_terms_plain_is_the_code_it_replaced(cpu_sim, semantics, dtype):
    """``engine.bias_terms_plain`` (and the engine's ``_bias_den`` and
    ``_bias_scale``, which call it) is bit for bit the engine's bias terms
    and EMA fold before they moved into the record (:func:`_bias_before`),
    on seeded counters (windows with no record, one, many; a ratchet at 0),
    the refill's denominator the one before the fold, the event phase's
    after it."""
    reference, frozen = semantics == "reference", semantics == "frozen"
    cfg = (profiles.reference_config if reference else profiles.bench_config)(
        pool=256, dtype=dtype)._replace(**(dict(bias_fixed_tau=0.0025, bias_fixed_avg=2.6)
                                          if frozen else {}))
    eng = engine.Engine(cpu_sim.mc, cfg, cpu_sim.engine.tables, "cpu", torch.Generator())
    fixed = eng._bias_fixed
    assert (fixed is not None) == frozen and (eng._bias_out is None) == frozen
    rng = np.random.default_rng(23)
    scales = set()
    for j in range(40):
        rec, nsc = int(rng.integers(0, 5000)), int(rng.integers(0, 20000))
        c = engine.init_counters(0.0 if j == 0 else float(rng.exponential(0.5)), dtype, "cpu")
        c = c._replace(n_recorded=torch.tensor(rec), n_scatt_rec=torch.tensor(nsc),
                       avg_ema=torch.tensor(rng.uniform(0.0, 4.0), dtype=dtype),
                       ema_rec_mark=torch.tensor(rec - (j % 3 if j < 6 else
                                                        int(rng.integers(0, 300)))),
                       ema_scatt_mark=torch.tensor(nsc - int(rng.integers(0, 900))))
        den, scale, folded = _bias_before(c, cpu_sim.mc.bias_norm, dtype, reference, fixed)
        for fold in (False, True):
            out, terms = engine.bias_terms_plain(c, cpu_sim.mc.bias_norm, dtype, reference,
                                                 fold=fold, fixed=fixed)
            want_f = folded if fold else c
            for f in engine.Counters._fields:
                assert _same(getattr(out, f), getattr(want_f, f)), (j, fold, f)
            after = den if fixed is not None else _bias_before(
                want_f, cpu_sim.mc.bias_norm, dtype, reference, None)[0]
            assert _same(terms.refill_den, den) and _same(terms.event_den, after), (j, fold)
            assert _same(terms.scale, (100.0 / after).to(dtype)), (j, fold)
        assert _same(eng._bias_den(c), den) and _same(eng._bias_scale(c), scale), j
        scales.add(float(scale))
    assert len(scales) == 1 if frozen else len(scales) > 30
    if frozen:  # the engine's terms hold the constants
        assert _same(eng._bias.scale, scale) and _same(eng._bias.event_den, den)


def test_the_wrapper_writes_the_terms_only_where_given(cpu_sim):
    """On the CPU ``hot_kernels.record_phase`` copies the plain terms into
    the ``bias`` it is given (the sweep alone too, from the counters as it
    finds them), folds the EMA only under ``fold``, and writes nothing
    without ``bias``; the fold needs the record."""
    mc = cpu_sim.mc
    pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, 2048, 300, 8, torch.float32,
                                                             "cpu")
    for mode, fold in ((MODES["sweep"], False), (MODES["full"], True), (MODES["light"], False),
                       (MODES["flush"], False)):
        sweep, record, free = mode
        want, want_terms = hot_kernels.record_plain(pool, spec, counters, 300, mc, cfg,
                                                    fold=fold, sweep=sweep, record=record,
                                                    free=free)
        bias = hot_kernels.record_bias(torch.float32, "cpu")
        got = hot_kernels.record_phase(pool, spec, counters, 300, mc, cfg, sweep=sweep,
                                       record=record, free=free, fold=fold, bias=bias)
        assert not hot_kernels.compare_record(pool, spec, counters, want, got,
                                              terms=(want_terms, bias))[1], mode
        moved = not torch.equal(got[2].avg_ema, counters.avg_ema)
        assert moved == fold and bool(got[2].ema_rec_mark == got[2].n_recorded) == fold
        kept = hot_kernels.record_bias(torch.float32, "cpu")
        hot_kernels.record_phase(pool, spec, counters, 300, mc, cfg, sweep=sweep,
                                 record=record, free=free, bias=None)
        assert all(bool(torch.isnan(t)) for t in kept)
    with pytest.raises(ValueError, match="fold"):
        hot_kernels.record_phase(pool, spec, counters, 300, mc, cfg, record=False, fold=True)


@pytest.fixture(scope="module", params=["shipped", "reference", "frozen"])
def jax_phases(request, dump):
    """A JAX engine of one semantics (float64, 256 lanes; "frozen": the
    shipped profile with the bias frozen), its jitted full and light
    phases, a state that went through two light phases from a fresh one
    and then had 100 of its 128 loaded lanes made escaped (pending a
    record, not alive, seeded tau_scatt and n_scatt) and its counters
    seeded, a backlog; the port's engine of the same config on the same
    tables."""
    import jax
    import jax.numpy as jnp
    from jax import random

    from grmonty_tpu.transport import driver as jdriver
    from grmonty_tpu.transport import engine as jengine

    from grmonty_tpu_torch import convert
    from grmonty_tpu_torch.models import harm
    from grmonty_tpu_torch.ops import fluid

    semantics = request.param
    n = 256
    physics = convert._REFERENCE if semantics == "reference" else convert._SHIPPED
    frozen = dict(bias_fixed_tau=0.0025, bias_fixed_avg=2.6) if semantics == "frozen" else {}
    jcfg = jengine.EngineConfig(
        n_pool=n, m_period=16, sec_cap=4 * n, ev_k=n // 4, refill_k=n // 2, light_k=n // 4,
        refill_period=4, dtype=jnp.float64,
        **({} if semantics == "reference" else {"grow_cap": 8.0}), **physics, **frozen)
    jsim = jdriver.Simulation(dump, photon_n=2000, mass_unit=4e19, config=jcfg,
                              cdf_sampler=True, emit_stride=True, warmup=0)
    backlog = jnp.asarray(np.array(jsim.emit_packed(jsim.plan(), 0, 4 * n)))
    light = jax.jit(jsim.engine["light_phase"])
    state = jsim.engine["fresh_state"](random.PRNGKey(3))
    state = light(light(state, backlog), backlog)
    rng = np.random.default_rng(17)
    p, c = state.pool, state.counters
    occupied = np.flatnonzero(np.asarray(p.occupied))
    assert occupied.size == 2 * (n // 4)
    esc = np.zeros(n, bool)
    esc[rng.choice(occupied, 100, replace=False)] = True
    tau = np.where(esc, rng.exponential(0.02, n), np.asarray(p.tau_scatt))
    nsc = np.where(esc, rng.integers(0, 6, n), np.asarray(p.n_scatt)).astype(np.int32)
    state = state._replace(
        pool=p._replace(record_pending=jnp.asarray(esc),
                        alive=jnp.asarray(np.asarray(p.alive) & ~esc),
                        tau_scatt=jnp.asarray(tau), n_scatt=jnp.asarray(nsc)),
        counters=c._replace(n_recorded=jnp.asarray(40, c.n_recorded.dtype),
                            n_scatt_rec=jnp.asarray(90, c.n_scatt_rec.dtype),
                            avg_ema=jnp.asarray(1.7, jnp.float64),
                            ema_rec_mark=jnp.asarray(30, c.ema_rec_mark.dtype),
                            ema_scatt_mark=jnp.asarray(70, c.ema_scatt_mark.dtype),
                            max_tau_scatt=jnp.asarray(float(np.quantile(tau[esc], 0.5)),
                                                      jnp.float64)))
    mc = fluid.make_model_consts(harm.read_dump(dump, 4e19))
    port = engine.Engine(mc, convert.from_jax_config(jcfg),
                         convert.from_jax_engine_tables(jsim._engine_tabs), torch.device("cpu"),
                         torch.Generator())
    return dict(full=jax.jit(jsim.engine["periodic_phase"]), light=light, state=state,
                backlog=backlog, port=port, jcfg=jcfg, bias_norm=float(jsim.mc.bias_norm))


def _jax_terms(jp, before, after):
    """The JAX engine's denominators and scale (grmonty_tpu/transport/
    engine.py:1226-1250, :1443-1445) in numpy float64, from its counters
    ``before`` and ``after`` a phase: the refill's at the counters after
    the record with the EMA from before the fold (:2462-2475), the event
    phase's and the scale after it."""
    cfg = jp["jcfg"]

    def den(c, avg_ema):
        if cfg.bias_fixed_tau > 0.0:
            return jp["bias_norm"] * (cfg.bias_fixed_tau * (cfg.bias_fixed_avg + 2.0))
        if cfg.bias_ema > 0.0:
            avg = float(avg_ema)
        else:
            avg = float(c.n_scatt_rec) / (float(c.n_recorded) + 1.0)
        return jp["bias_norm"] * (float(c.max_tau_scatt) * (avg + 2.0))

    event = den(after, after.avg_ema)
    return den(after, before.avg_ema), event, 100.0 / event


def test_the_bias_terms_after_the_phases_are_jaxs(jax_phases):
    """A seeded state goes through one full phase and then one light phase
    in JAX and, converted (``convert.from_jax_state``), in the port: after
    each, the port's counters agree with JAX's and the engine's bias terms
    hold the denominators and the scale that the JAX engine computes from
    its own counters, to rtol 1e-10 (``test_torch_fresh_init.py``'s
    light-phase comparison)."""
    from grmonty_tpu_torch import convert

    jp, port = jax_phases, jax_phases["port"]
    backlog = torch.as_tensor(np.array(jp["backlog"]))
    s0 = jp["state"]
    s1 = jp["full"](s0, jp["backlog"])
    s2 = jp["light"](s1, jp["backlog"])
    moved = []
    for phase, src, dst in ((port.periodic_phase, s0, s1), (port.light_phase, s1, s2)):
        got = phase(convert.from_jax_state(src), backlog)
        want = convert.from_jax_state(dst)
        for f in engine.Counters._fields:
            np.testing.assert_allclose(getattr(got.counters, f).numpy(),
                                       getattr(want.counters, f).numpy(), rtol=1e-10,
                                       atol=0.0, err_msg=f)
        terms = _jax_terms(jp, src.counters, dst.counters)
        for f, g, w in zip(engine.BiasTerms._fields, port._bias, terms, strict=True):
            np.testing.assert_allclose(float(g), w, rtol=1e-10, atol=0.0, err_msg=f)
        moved.append(int(got.counters.n_recorded) - int(convert.from_jax_state(src)
                                                         .counters.n_recorded))
    # both phases recorded; the full one's width ran out
    assert moved[0] == port.ev_k and moved[1] > 0, moved


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


def _kernel_record(pool, spec, counters, k, mc, cfg, bias=None, **mode):
    """One kernel call on copies of the inputs: one launch, in place, the
    scratch back at rest."""
    n = pool.w.shape[0]
    work = hot_kernels.clone_record(pool, spec, counters)
    ticket = hot_kernels.record_ticket("cuda", n)
    before = dict(hot_kernels.launches)
    got = hot_kernels.record_phase(*work, k, mc, cfg, ticket, bias=bias, **mode)
    torch.cuda.synchronize()
    name = hot_kernels.entry_point("record_phase", pool.w.dtype)
    bits = sum(bit for stage, bit in (("sweep", hot_kernels.RECORD_SWEEP),
                                      ("record", hot_kernels.RECORD_RECORD),
                                      ("free", hot_kernels.RECORD_FREE))
               if mode.get(stage, True))
    assert hot_kernels.record_launches(bits) == 1
    assert hot_kernels.launches[name] == before[name] + 1
    assert sum(hot_kernels.launches.values()) == sum(before.values()) + 1
    assert got[0] is work[0] and got[1] is work[1] and got[2] is work[2]
    assert all(a is b for a, b in zip(hot_kernels._flat(got[0]._asdict()).values(),
                                      hot_kernels._flat(work[0]._asdict()).values()))
    assert hot_kernels.record_at_rest(ticket, n)
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
        fold = mode == MODES["full"]
        want, want_terms = hot_kernels.record_plain(pool, spec, counters, k, mc, cfg,
                                                    fold=fold, sweep=sweep, record=record,
                                                    free=free)
        bias = hot_kernels.record_bias(dtype, "cuda")
        got = _kernel_record(pool, spec, counters, k, mc, cfg, bias=bias, sweep=sweep,
                             record=record, free=free, fold=fold)
        rec, fails = hot_kernels.compare_record(pool, spec, counters, want, got,
                                                terms=(want_terms, bias))
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
    want, want_terms = hot_kernels.record_plain(pool, spec, counters, n // 4, mc, cfg)
    bias = hot_kernels.record_bias(dtype, "cuda")
    got = _kernel_record(pool, spec, counters, n // 4, mc, cfg, bias=bias)
    assert bool(torch.isnan(want[2].max_tau_scatt))
    assert not hot_kernels.compare_record(pool, spec, counters, want, got,
                                          terms=(want_terms, bias))[1]


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
    the record's scratch at rest (its ticket, tile counter and status
    words at zero) and the refill's ticket at zero after each of three
    replays, each replay also writing the bias's terms of the plain
    version."""
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
    tickets = hot_kernels.record_ticket("cuda", n), hot_kernels.fresh_ticket("cuda")
    bias = hot_kernels.record_bias(dtype, "cuda")
    want_terms = hot_kernels.record_plain(pool, spec, counters, k, sim.mc, cfg)[1]

    def phase():
        p, s, c = hot_kernels.record_phase(*work, k, sim.mc, cfg, tickets[0], bias=bias)
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
    for _ in range(3):
        restore()
        for t in bias:
            t.fill_(math.nan)
        graph.replay()
        torch.cuda.synchronize()
        got = snap()
        assert hot_kernels.record_at_rest(tickets[0], n) and not bool(tickets[1].any())
        assert all(bool(hot_kernels._same_bits(a, b)) for a, b in zip(bias, want_terms))
        for j, (a, b) in enumerate(zip(got, eager, strict=True)):
            if j == spec_at:  # both the atomics' sums
                assert bool((torch.abs(a - b) <= slack).all())
            else:
                assert bool(hot_kernels._same_bits(a, b).all()), j


# the widths that are no multiple of a tile (nor of a thread's four lanes)
ODD_WIDTHS = ((3000, 1500), (700, 700), (1025, 1025), (4097, 1000), (65535, 9000))


def _traced_record_kernels(fn):
    """The record's kernels the card ran during ``fn``, counted in
    ``torch.profiler``'s trace of the device (not the wrapper's declared
    count)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "record_phase_kernel" in e.name())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_one_launch_a_call_at_every_width(card_sims, dtype):
    """Every mode (the full phase's with the fold) at every
    ``RECORD_WIDTHS`` entry and at widths no tile divides: one launch a
    call, by the wrapper's count and by the kernels ``torch.profiler``
    traces on the card, the plain version's result and terms, the scratch
    at rest."""
    mc = card_sims[dtype].mc
    calls = []

    def run():
        for n, k in hot_kernels.RECORD_WIDTHS + ODD_WIDTHS:
            pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, n, k, 3 * n + k,
                                                                     dtype, "cuda")
            for label, (sweep, record, free) in MODES.items():
                fold = label == "full"
                want, want_terms = hot_kernels.record_plain(pool, spec, counters, k, mc, cfg,
                                                            fold=fold, sweep=sweep,
                                                            record=record, free=free)
                bias = hot_kernels.record_bias(dtype, "cuda")
                got = _kernel_record(pool, spec, counters, k, mc, cfg, bias=bias, sweep=sweep,
                                     record=record, free=free, fold=fold)
                calls.append((n, k, label))
                rec, fails = hot_kernels.compare_record(pool, spec, counters, want, got,
                                                        terms=(want_terms, bias))
                assert not fails, (n, k, label, fails, rec)

    traced = _traced_record_kernels(run)
    assert len(calls) == len(hot_kernels.RECORD_WIDTHS + ODD_WIDTHS) * len(MODES)
    assert traced == len(calls), (traced, len(calls))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 3000])
def test_the_scratch_rests_after_a_call_and_three_replays(card_sims, n):
    """The record's scratch (the ticket, the tile counter, the tiles'
    status words) is at zero after an eager call and after each of three
    replays of a graph of two calls (the sweep alone, then the light
    phase's), and each replay gives the eager calls' flags and counters."""
    import gc

    mc = card_sims[torch.float32].mc
    pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, n, n // 5, 5 * n,
                                                             torch.float32, "cuda")
    work = hot_kernels.clone_record(pool, spec, counters)
    ticket = hot_kernels.record_ticket("cuda", n)
    bias = hot_kernels.record_bias(torch.float32, "cuda")

    def calls():
        hot_kernels.record_phase(*work, n // 5, mc, cfg, ticket, sweep=True, record=False,
                                 free=False, bias=bias)
        hot_kernels.record_phase(*work, n // 5, mc, cfg, ticket, bias=bias)

    def restore():
        for dst, src in zip(hot_kernels._flat({**work[0]._asdict(), **work[2]._asdict()})
                            .values(),
                            hot_kernels._flat({**pool._asdict(), **counters._asdict()})
                            .values()):
            dst.copy_(src)

    calls()
    torch.cuda.synchronize()
    assert hot_kernels.record_at_rest(ticket, n)
    eager = [t.clone() for t in hot_kernels._flat({**work[0]._asdict(),
                                                   **work[2]._asdict()}).values()]
    eager_terms = [t.clone() for t in bias]
    restore()
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            calls()
    finally:
        gc.enable()
    for _ in range(3):
        restore()
        graph.replay()
        torch.cuda.synchronize()
        assert hot_kernels.record_at_rest(ticket, n)
        got = hot_kernels._flat({**work[0]._asdict(), **work[2]._asdict()})
        for (f, a), b in zip(got.items(), eager):
            if f != "w_stall":
                assert bool(hot_kernels._same_bits(a, b).all()), f
        assert all(bool(hot_kernels._same_bits(a, b)) for a, b in zip(bias, eager_terms))


@pytest.mark.cuda
@pytest.mark.parametrize("semantics", ["shipped", "reference", "frozen"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_the_bias_terms_are_the_plain_terms_on_the_card(card_sims, dtype, semantics):
    """The terms the record's last block writes are bit for bit
    ``engine.bias_terms_plain``'s in every mode (the sweep alone's from the
    counters as it finds them, the full phase's around its EMA fold), in
    either semantics; under the frozen bias an engine passes no terms and
    its buffers keep the constants; an engine's phases leave its buffers
    the plain terms of the counters they leave."""
    sim = card_sims[dtype]
    mc = sim.mc
    for n, k in ((65536, 16384), (4096, 512), (512, 512)):
        pool, spec, counters, cfg = hot_kernels.synthetic_record(
            mc, n, k, 7 * n + k, dtype, "cuda", reference=semantics == "reference")
        for label, (sweep, record, free) in MODES.items():
            fold = label == "full" and semantics != "reference"
            want, want_terms = hot_kernels.record_plain(pool, spec, counters, k, mc, cfg,
                                                        fold=fold, sweep=sweep, record=record,
                                                        free=free)
            bias = hot_kernels.record_bias(dtype, "cuda")
            got = _kernel_record(pool, spec, counters, k, mc, cfg,
                                 bias=None if semantics == "frozen" else bias, sweep=sweep,
                                 record=record, free=free, fold=fold)
            terms = None if semantics == "frozen" else (want_terms, bias)
            assert not hot_kernels.compare_record(pool, spec, counters, want, got,
                                                  terms=terms)[1], (n, label)
            if semantics == "frozen":
                assert all(bool(torch.isnan(t)) for t in bias)
    make = profiles.reference_config if semantics == "reference" else profiles.bench_config
    ecfg = make(pool=1024, dtype=dtype)._replace(
        **(dict(bias_fixed_tau=0.0025, bias_fixed_avg=2.6) if semantics == "frozen" else {}))
    eng = engine.Engine(mc, ecfg, sim.engine.tables, "cuda", torch.Generator("cuda"),
                        graphed=False)
    sim.plan()
    rows = sim.emit_rows(0, 1024).to(dtype)
    state = eng.fresh_state()
    fixed = [t.clone() for t in eng._bias]
    after = 0  # rounds run since the first record
    for _ in range(400):
        state = eng.periodic_phase(state, rows)
        for _ in range(4):
            state = eng.hot_step(state)
        state = eng.light_phase(state, rows)
        want = eng._bias_terms(state.counters)[1]
        for f, a, b in zip(engine.BiasTerms._fields, eng._bias, want):
            assert a.dtype == b.dtype and bool(hot_kernels._same_bits(a, b)), f
        after += int(state.counters.n_recorded) > 0
        if after == 3:
            break
    assert after == 3
    if semantics == "frozen":
        assert all(bool(hot_kernels._same_bits(a, b)) for a, b in zip(eng._bias, fixed))


GATED_WIDTHS = ((65536, 16384), (4096, 512), (1024, 1024), (512, 512))


@pytest.mark.cuda
@pytest.mark.parametrize("reference", [False, True], ids=["shipped", "reference"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_the_gated_sweep_on_the_card(card_sims, dtype, reference):
    """A block's first launch, the sweep gated on go (``record_phase``'s
    ``go``): with go clear no byte of the pool, the spectrum, the counters
    or the terms changes; with go set it is the ungated sweep bit for bit,
    terms included.  Captured with a conditional handle ahead of a node on
    it (one add to a count), each replay sets the node's condition from go:
    with go clear the node does not run and the handle is left at 0."""
    mc = card_sims[dtype].mc
    dev = torch.device("cuda")
    for n, k in GATED_WIDTHS:
        pool, spec, counters, cfg = hot_kernels.synthetic_record(mc, n, k, 3 * n + k, dtype,
                                                                 "cuda", reference=reference)
        want_bias = hot_kernels.record_bias(dtype, "cuda")
        want = _kernel_record(pool, spec, counters, k, mc, cfg, bias=want_bias, sweep=True,
                              record=False, free=False)
        for go in (False, True):
            bias = hot_kernels.record_bias(dtype, "cuda")
            g = torch.tensor(go, device=dev)
            got = _kernel_record(pool, spec, counters, k, mc, cfg, bias=bias, sweep=True,
                                 record=False, free=False, go=g)
            _assert_same(got, want if go else (pool, spec, counters))
            for a, b in zip(bias, want_bias if go else hot_kernels.record_bias(dtype, "cuda")):
                assert _same(a, b), (n, go)
        # in a graph, ahead of an IF node on the handle it sets
        work = hot_kernels.clone_record(pool, spec, counters)
        first = hot_kernels.clone_record(pool, spec, counters)
        bias = hot_kernels.record_bias(dtype, "cuda")
        ticket = hot_kernels.record_ticket("cuda", n)
        g = torch.zeros((), dtype=torch.bool, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        capture, stream = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        mem, graph = torch.cuda.MemPool(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            handle = hot_kernels.exit_handle(dev)
            hot_kernels.record_phase(*work, k, mc, cfg, ticket, sweep=True, record=False,
                                     free=False, bias=bias, go=g, handle=handle)
            hot_kernels.exit_guard(handle, lambda: count.add_(1), stream, mem)
        for go in (False, True):
            g.fill_(go)
            count.zero_()
            for dst, src in zip(engine.pool_tensors(work[0]) + [work[1], *work[2]],
                                engine.pool_tensors(first[0]) + [first[1], *first[2]]):
                dst.copy_(src)
            for t in bias:
                t.fill_(math.nan)
            graph.replay()
            torch.cuda.synchronize()
            assert int(count) == int(go), (n, go)
            _assert_same(work, want if go else first)
            assert hot_kernels.record_at_rest(ticket, n)
