"""The engine's block as one capturable unit (CPU; on the card, the graph).

``Engine.run`` runs each block (the full phase, the hot steps, each light
phase and its hot steps) on a state of the engine's own, with a static
backlog buffer and the valid rows' count on the device, and ends it by
copying its outputs into that state in place; on the card the block is one
CUDA graph, replayed once per block.  On the 64x32 torus at pool 256, in
both semantics and both dtypes:

* identity: over two waves of three blocks each (the hand-off between
  them) and a cascade stage of one, ``Engine.run`` leaves the state bit for bit where the loop that
  issued the phases one by one on the caller's tensors (:func:`loop_run`,
  the run before the block was captured) leaves it, and draws the same
  numbers from the generator;
* the padded backlog: the second wave is shorter than the buffer, whose
  rows past ``n_valid`` hold the first wave's photons and are never loaded;
* no host sync: a block runs with ``Tensor.item``, ``tolist``,
  ``__bool__``, ``__int__``, ``__float__`` and ``torch.tensor`` patched to
  raise (the CPU's stand-in for capturable; the plain scatter event alone
  is let through: it checks its rejection loops on the host every few
  rounds, where the card runs them in one kernel);
* bookkeeping: a run whose blocks are replayed from a stand-in graph,
  which passes no Python counter, and credited from what one block adds
  counts the launches (each wrapper call counted as its entry point's
  launch, as on the card), the phases and the hot iterations of the eager
  run.

The card tests (marker ``cuda``) hold the graphed run against the eager one
on the card (pool, ring and counters bit for bit, the spectrum to rtol
1e-6, which sums with float atomics there; one drawing hot-step launch a
run of hot steps, its steps the hot iterations) and check that the capture
leaves the run's state, the generator and the counts as it found them.
"""

import contextlib
import gc
import types

import pytest
import torch

from grmonty_tpu_torch.models import torus
from grmonty_tpu_torch.ops import scattering
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

POOL = 256
WAVES = (150, 100)  # the second wave is shorter than the buffer: padded
M_PERIOD = 8
BLOCKS = 3  # blocks a run (engine.MAX_OUTER cut to BLOCKS * M_PERIOD); a
#   cascade stage (64 hot iterations a block) runs one
CASES = [(ref, dt) for ref in (False, True) for dt in (torch.float32, torch.float64)]
IDS = [f"{'reference' if ref else 'shipped'}-{str(dt)[6:]}" for ref, dt in CASES]
# The bias frozen (its denominator a constant tensor of the engine's) and
# the birth-state trace on (its capture selects a lane on the device).
FROZEN = dict(bias_fixed_tau=0.0025, bias_fixed_avg=2.6, trace_birth=True)
OPTIONS = [(ref, dt, {}) for ref, dt in CASES] + [(False, torch.float32, FROZEN),
                                                  (True, torch.float64, FROZEN)]
OPTION_IDS = IDS + [f"{IDS[0]}-frozen-traced", f"{IDS[3]}-frozen-traced"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Pools of a few hundred lanes: intra-op threads only add overhead, and
    the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _blocks_a_run(monkeypatch):
    """Every run ends after BLOCKS blocks (no exit occupancy is reached)."""
    monkeypatch.setattr(engine, "MAX_OUTER", BLOCKS * M_PERIOD)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return str(path)


def _cfg(reference, dtype, options=None):
    """The path's widths at POOL lanes; a ring of 32 rows, so that the
    secondaries leave free lanes for the second wave."""
    make = profiles.reference_config if reference else profiles.bench_config
    return make(pool=POOL, dtype=dtype)._replace(m_period=M_PERIOD, sec_cap=32,
                                                 stall_steps=2000, **(options or {}))


def _sim(dump, reference, dtype, device="cpu", graphed=None, options=None):
    return driver.Simulation(dump, photon_n=600, mass_unit=4.0e18, seed=123,
                             config=_cfg(reference, dtype, options), device=device,
                             warmup=0, tail_stall_steps=2000, graphed=graphed)


def loop_run(eng, state, backlog_rows, tail_exit=None, n_valid=None):
    """The run before its block was captured: the phases issued one by one
    on the caller's tensors, a fresh backlog tensor and a Python ``n_valid``
    (the exit condition read once a block, the final flush)."""
    te = eng.cfg.tail_exit if tail_exit is None else tail_exit
    nv = backlog_rows.shape[0] if n_valid is None else n_valid
    it0 = state.it
    while state.it - it0 < engine.MAX_OUTER:
        occ, pos, sec = torch.stack([state.pool.occupied.sum(), state.backlog_pos,
                                     state.sec.count]).tolist()
        if not (occ > te or pos < nv or sec > 0):
            break
        state = eng.periodic_phase(state, backlog_rows, nv)
        for bi_, nb in enumerate(eng.blocks):
            if bi_:
                state = eng.light_phase(state, backlog_rows, nv)
            for _ in range(nb):
                state = eng.hot_step(state)
    spec, counters, p = state.spec, state.counters, state.pool
    while bool((p.record_pending & ~p.ev_pending).any()):
        spec, counters, p = eng.spectrum_add(spec, counters, p)
    return state._replace(pool=p, spec=spec, counters=counters)


def _rows(sim):
    sim.plan()
    starts = [0, WAVES[0]]
    return [sim.emit_rows(s, n) for s, n in zip(starts, WAVES)]


def _scenario(sim, rows, run):
    """Two waves through the wave engine (its buffer sized for the first, so
    the second is padded), then one cascade stage; returns the three states
    and the generator's state after."""
    eng = sim.engine
    eng.reserve_backlog(max(WAVES))
    state, out = eng.fresh_state(), []
    for backlog in rows:
        state = run(eng, state._replace(backlog_pos=torch.zeros_like(state.backlog_pos)),
                    backlog, tail_exit=0)
        out.append(state)
    small, _ = driver.tail_gather(state.pool, POOL)
    tstate = engine.State(pool=small, spec=state.spec, counters=state.counters,
                          sec=state.sec, backlog_pos=torch.zeros_like(state.backlog_pos), it=0)
    empty = torch.zeros((1, engine.ROW_WIDTH), dtype=sim.cfg.dtype, device=sim.device)
    out.append(run(sim._tail_engine(POOL, 0), tstate, empty, n_valid=0))
    return out, sim.gen.get_state()


def _bits(t):
    if t.is_floating_point():
        return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)
    return t


def _assert_same(got, want, what, spec_rtol=None):
    names = list(driver._flat_state(want))
    for name, g, w in zip(names, engine.state_tensors(got), engine.state_tensors(want),
                          strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what}: {name}"
        if name == "spec" and spec_rtol is not None:
            torch.testing.assert_close(g, w, rtol=spec_rtol, atol=0.0, msg=f"{what}: spec")
        else:
            assert torch.equal(_bits(g), _bits(w)), f"{what}: {name} differs"
    assert got.it == want.it, f"{what}: it {got.it} != {want.it}"


@pytest.mark.parametrize("reference,dtype,options", OPTIONS, ids=OPTION_IDS)
def test_block_leaves_the_state_where_the_loop_does(dump, reference, dtype, options):
    sim = _sim(dump, reference, dtype, options=options)
    rows = _rows(sim)
    g0 = sim.gen.get_state()
    got, gen_got = _scenario(sim, rows, lambda eng, *a, **kw: eng.run(*a, **kw))
    sim.gen.set_state(g0)
    want, gen_want = _scenario(sim, rows, loop_run)
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"run {i}")
    assert torch.equal(gen_got, gen_want)
    # the waves ran their blocks and took photons from both backlogs; the
    # stage ran its block
    assert [s.it for s in got] == [BLOCKS * M_PERIOD, 2 * BLOCKS * M_PERIOD, 64]
    created = [int(s.counters.n_created) for s in got]
    assert 0 < created[0] < created[1] == created[2], created


@pytest.mark.parametrize("reference,dtype", CASES, ids=IDS)
def test_rows_past_n_valid_are_never_loaded(dump, reference, dtype):
    """The buffer's rows past ``n_valid`` hold photons (the first wave's,
    then rows of a third emission written there on purpose): a run of the
    second wave loads exactly its own rows and ends where the loop does on
    the second wave's tensor alone."""
    sim = _sim(dump, reference, dtype)
    rows = _rows(sim)
    extra = sim.emit_rows(sum(WAVES), WAVES[0])
    eng = sim.engine
    eng.reserve_backlog(max(WAVES))
    g0 = sim.gen.get_state()
    state = eng.fresh_state()
    eng._load(state, rows[1], WAVES[1])
    eng._backlog[WAVES[1]:] = extra[WAVES[1]:]
    got = eng.run(state, rows[1], tail_exit=0)
    assert torch.equal(eng._backlog[WAVES[1]:], extra[WAVES[1]:])
    sim.gen.set_state(g0)
    want = loop_run(eng, eng.fresh_state(), rows[1], tail_exit=0)
    _assert_same(got, want, "padded wave")
    assert 0 < int(got.counters.n_created) == int(got.backlog_pos) <= WAVES[1]


BANNED = ((torch.Tensor, "item"), (torch.Tensor, "tolist"), (torch.Tensor, "__bool__"),
          (torch.Tensor, "__int__"), (torch.Tensor, "__float__"), (torch, "tensor"))


@contextlib.contextmanager
def _patched(table):
    saved = [(owner, name, getattr(owner, name)) for owner, name in BANNED]
    for owner, name, _ in saved:
        setattr(owner, name, table[name])
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


@pytest.mark.parametrize("reference,dtype,options", OPTIONS, ids=OPTION_IDS)
def test_block_reads_nothing_on_the_host(dump, reference, dtype, options, monkeypatch):
    sim = _sim(dump, reference, dtype, options=options)
    rows = _rows(sim)
    eng = sim.engine
    state = eng.fresh_state()
    eng._load(state, rows[0], WAVES[0])
    originals = {name: getattr(owner, name) for owner, name in BANNED}

    def refuse(name):
        def refused(*a, **kw):
            raise AssertionError(f"the block called {name}: a host read")
        return refused

    event = scattering.scatter_event_c

    def plain_event(*a, **kw):  # the card runs its loops in one kernel
        with _patched(originals):
            return event(*a, **kw)

    monkeypatch.setattr(scattering, "scatter_event_c", plain_event)
    before = engine.clone_state(eng._state)
    with _patched({name: refuse(name) for _, name in BANNED}):
        eng._body()
        eng._body()
    assert int(eng._state.counters.ls_iters) == 2 * sim.cfg.m_period
    assert int(eng._state.counters.n_created) > int(before.counters.n_created)


def _counting_wrappers(monkeypatch, cfg):
    """Count each kernel wrapper's call as one launch of its entry point, as
    the wrappers count on the card (the plain path counts nothing)."""
    dt, ref = cfg.dtype, cfg.reference
    for wrapper, kernel in (("hot_step", "hot_step"), ("row_gather", "row_gather"),
                            ("event_fluid", "event_fluid"), ("scatter_event", "scatter_event"),
                            ("refill_fresh", "fresh_init"), ("event_phase", "event_phase"),
                            ("compact", "compact"), ("compact_rows", "compact_rows"),
                            ("record_phase", "record_phase"), ("exit_test", "exit_test")):
        name = kernel if kernel == "exit_test" else hot_kernels.entry_point(kernel, dt, ref)
        fn = getattr(hot_kernels, wrapper)

        def counted(*a, _fn=fn, _name=name, **kw):
            hot_kernels.launches[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(hot_kernels, wrapper, counted)


@pytest.mark.parametrize("reference,dtype", CASES, ids=IDS)
def test_replayed_blocks_count_what_the_eager_run_counts(dump, reference, dtype, monkeypatch):
    sim = _sim(dump, reference, dtype)
    rows = _rows(sim)
    _counting_wrappers(monkeypatch, sim.cfg)
    eng = sim.engine
    g0 = sim.gen.get_state()

    def counted_run(setup):
        hot_kernels.reset_launches()
        state = eng.fresh_state()
        setup(state)
        out = eng.run(state, rows[0], tail_exit=0)
        return out, dict(hot_kernels.launches), dict(eng.phases)

    want, launches, phases = counted_run(lambda state: None)

    def stand_in(state):
        """A graph that replays its blocks, each its sweep gated on the exit
        word's go and the rest of it (which ends with the exit test) where
        go is set, and passes no Python counter; the credit is one block's
        rest and the replay's gated sweeps, taken as the capture takes them
        (the generator and the state then restored).  The stand-in
        generator's offset moves a whole graph's draws a replay, as a
        registered generator's does on the card."""
        g = sim.gen.get_state()
        eng._load(state, rows[0], WAVES[0])
        eng._counting(lambda: eng._sweep(eng._one))
        body = eng._counting(eng._rest)
        sweeps = eng._counting(lambda: eng._guarded(lambda go, fn: None))
        sim.gen.set_state(g)
        eng.graphed = True
        eng._gen_step = STEP
        eng._gen_offset = lambda: offset[0]
        eng._set_gen_offset = lambda o: offset.__setitem__(0, o)
        eng._credit = (body, sweeps)

        def replay():
            offset[0] += eng.graph_bodies * STEP
            eng._counting(lambda: eng._guarded(lambda go, fn: fn() if bool(go) else None))

        eng._graph = types.SimpleNamespace(replay=replay)

    STEP, offset = 4, [0]
    sim.gen.set_state(g0)
    try:
        got, launches_g, phases_g = counted_run(stand_in)
    finally:
        eng.graphed, eng._graph = False, None
        del eng._gen_offset, eng._set_gen_offset
    _assert_same(got, want, "replayed")
    blocks, k = want.it // M_PERIOD, eng.graph_bodies
    # the run stops at the cap, whose word the host reads while one more
    # replay, which runs no block, is queued
    assert eng.bodies == blocks == BLOCKS and eng.skipped == 1
    assert eng.replays == -(-blocks // k) + 1
    assert offset[0] == blocks * STEP
    # every launch and phase as the eager run's, but the sweeps: one a
    # block there, one in each of a replay's blocks here, whether or not
    # the block runs; the exit test at the run's entry and at the end of
    # each block, the closing flush one record
    record = hot_kernels.entry_point("record_phase", dtype)
    assert launches.pop("exit_test") == launches_g.pop("exit_test") == 1 + blocks
    assert launches_g.pop(record) - launches.pop(record) == k * eng.replays - blocks
    assert launches_g == launches and phases_g == phases
    assert eng._credit[1] == ({("launches", record): k}, {})
    assert phases == {"full": blocks, "light": blocks * (len(eng.blocks) - 1)}
    assert launches[hot_kernels.entry_point("hot_step", dtype, reference)] == want.it
    assert got.it == want.it
    assert int(got.counters.ls_iters) == int(want.counters.ls_iters) > 0


# -- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the graph replays the CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("reference,dtype,options", OPTIONS, ids=OPTION_IDS)
def test_graphed_run_equals_the_eager_run_on_the_card(dump, reference, dtype, options):
    _card()
    outs = {}
    for graphed in (True, False):
        sim = _sim(dump, reference, dtype, device="cuda", graphed=graphed, options=options)
        rows = _rows(sim)
        hot_kernels.reset_launches()
        out, gen = _scenario(sim, rows, lambda eng, *a, **kw: eng.run(*a, **kw))
        engines = [sim.engine, *sim._tail_engines.values()]
        outs[graphed] = (out, gen, {**hot_kernels.launches, **{
            f"{k}.steps": v for k, v in hot_kernels.run_steps.items()}},
                         [dict(e.phases) for e in engines],
                         [(e.replays, e.bodies, e.skipped) for e in engines])
    (got, gen_g, launches_g, phases_g, runs_g), (want, gen_e, launches_e, phases_e, runs_e) = (
        outs[True], outs[False])
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_same(g, w, f"run {i}", spec_rtol=1e-6)
    assert torch.equal(gen_g, gen_e)
    replays, bodies, skipped = (sum(r[j] for r in runs_g) for j in range(3))
    # three runs (two waves, a stage): the exit test at each entry and at
    # the end of each block; the gated sweep in each of a replay's blocks
    # (graphed) or in each block (eager)
    record = hot_kernels.entry_point("record_phase", dtype)
    assert launches_e.pop("exit_test") == launches_g.pop("exit_test") == 3 + bodies
    assert (launches_g.pop(record) - launches_e.pop(record)
            == replays * engine.GRAPH_BODIES - bodies)
    assert launches_g == launches_e and phases_g == phases_e
    assert bodies == sum(r[1] for r in runs_e) == sum(p["full"] for p in phases_g) > 0
    assert skipped == 3 and sum(r[0] + r[2] for r in runs_e) == 0
    # one drawing launch a run of hot steps (a full or light phase's), its
    # steps the hot iterations: the second wave's state counts on from the
    # first's, the stage's from 0
    draw = hot_kernels.entry_point("hot_step", dtype, reference, draw=True)
    assert launches_g[draw] == sum(p["full"] + p["light"] for p in phases_g)
    assert launches_g[f"{draw}.steps"] == got[1].it + got[2].it


@pytest.mark.cuda
def test_capture_holds_the_collector_off(dump, monkeypatch):
    """The garbage collector is off while a block is captured, and on again
    after: a graph of another engine left in a reference cycle and collected
    inside the capture would be destroyed there and invalidate it."""
    _card()
    sim = _sim(dump, False, torch.float32, device="cuda")
    rows = _rows(sim)
    seen = []
    rest = engine.Engine._rest

    def watched(self):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        rest(self)

    monkeypatch.setattr(engine.Engine, "_rest", watched)
    assert gc.isenabled()
    sim.engine.run(sim.engine.fresh_state(), rows[0], tail_exit=0)
    assert seen == [False] * sim.engine.graph_bodies and gc.isenabled()


@pytest.mark.cuda
def test_capture_leaves_state_generator_and_counts_as_found(dump):
    _card()
    sim = _sim(dump, False, torch.float32, device="cuda")
    rows = _rows(sim)
    eng = sim.engine
    eng.reserve_backlog(max(WAVES))
    state = eng.run(eng.fresh_state(), rows[0], tail_exit=0)  # lanes occupied
    eng._graph = None  # capture again, from this state
    g0 = sim.gen.get_state()
    launches0, phases0 = dict(hot_kernels.launches), dict(eng.phases)
    before = engine.clone_state(state)
    secs = eng.capture(state, rows[1], WAVES[1])
    assert secs > 0.0 and eng._graph is not None
    assert torch.equal(sim.gen.get_state(), g0)
    assert dict(hot_kernels.launches) == launches0 and dict(eng.phases) == phases0
    _assert_same(eng._state._replace(it=before.it), before, "the engine's copy after the capture")
    _assert_same(state, before, "the caller's state after the capture")
    assert eng._credit[0][1] == {"full": 1, "light": len(eng.blocks) - 1}
    k = eng.graph_bodies
    assert eng._credit[1] == ({("launches", "record_phase"): k}, {})
