"""The engine run's loop of blocks: the exit test on the device and the host
one replay ahead of the word it reads.

``Engine.run`` takes the JAX engine's ``lax.while_loop`` ``cond`` as a
device computation (``hot_kernels.exit_test``; the plain version
``engine.exit_test_plain``) at the run's entry and at the end of every
block.  On the card a graph replay holds its blocks, each under a
conditional node whose condition the block's gated sweep sets from the
word's ``go``, and the host issues replay n + 1 before it waits on replay
n's word (``engine.pipelined_loop``); ``graphed=False`` and the CPU read
the word after each block (``engine.host_loop``).

On the CPU:

* the plain exit test against the JAX ``cond`` formula evaluated with
  ``jnp`` on JAX states, converted by ``convert.from_jax_state``, built from
  a numpy seed, at the edges ``occ == tail_exit``, ``pos == n_valid``,
  ``sec == 0`` and the cap on the run's iterations;
* the pipelined scheduler against the plain host loop on a fake engine
  (runs of 0, 1 and many blocks, and the cap) at 1, 2 and 4 blocks a
  replay: the run's iterations, the credited launches and phases, the words
  read and the progress log, the generator's offset after the rewind, and
  exactly one replay that runs no block.

On the card (marker ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_run_loop.py``): the graphed run at 2 and 4 blocks a
replay bit for bit the eager run in both semantics and dtypes, a replay
issued by hand after a run changes no byte, a run whose exit holds at its
entry runs no block, the kernel bit for bit its plain version at
65,536, 4,096, 1,024 and 512 lanes at each edge (both values of go at each
width).
"""

import logging

import numpy as np
import pytest
import torch

from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

N_SUPER = 8


def _word(bodies=0):
    w = torch.zeros(engine.EXIT_WORD, dtype=torch.int64)
    w[3] = bodies
    return w


# (lanes, occupied, tail_exit, backlog_pos, n_valid, sec, bodies, max_outer)
EDGES = [
    (64, 10, 10, 5, 5, 0, 0, 40),  # occ == te, pos == nv, sec == 0: stop
    (64, 11, 10, 5, 5, 0, 0, 40),  # occ > te
    (64, 10, 10, 4, 5, 0, 0, 40),  # pos < nv
    (64, 10, 10, 5, 5, 1, 0, 40),  # sec > 0
    (64, 0, 0, 0, 0, 0, 0, 40),  # an empty run
    (64, 64, 0, 0, 9, 3, 4, 40),  # the last block under the cap (4 * 8 < 40)
    (64, 64, 0, 0, 9, 3, 5, 40),  # at the cap (5 * 8 == 40)
    (64, 64, 0, 0, 9, 3, 6, 40),  # past it
    (512, 300, 512, 20, 10, 0, 0, engine.MAX_OUTER),  # pos past nv, te at the pool
]


def _jax_state(n, occupied, pos, sec, it):
    import jax.numpy as jnp
    from jax import random

    from grmonty_tpu.transport import engine as jengine

    p = jengine.empty_pool(n, jnp.float64, detached_events=True)
    secbuf = jengine.empty_secbuf(8, jnp.float64)
    return jengine.State(
        pool=p._replace(occupied=jnp.asarray(occupied)),
        spec=jnp.zeros((jengine.N_BINS + 1, jengine.N_SPEC_CHAN), jnp.float64),
        counters=jengine.init_counters(0.0, jnp.float64),
        sec=secbuf._replace(count=jnp.asarray(sec, jnp.int32)),
        backlog_pos=jnp.asarray(pos, jnp.int32), key=random.PRNGKey(0),
        it=jnp.asarray(it, jnp.int32))


@pytest.mark.parametrize("edge", EDGES, ids=[f"edge{i}" for i in range(len(EDGES))])
def test_exit_test_plain_is_the_jax_cond(edge):
    """The JAX run's ``cond`` (grmonty_tpu/transport/engine.py, ``run``) on
    the state a run reaches after ``bodies`` blocks of N_SUPER iterations
    from it = 0, against the port's exit test on that state converted."""
    jnp = pytest.importorskip("jax.numpy")
    from grmonty_tpu_torch import convert

    n, n_occ, te, pos, nv, sec, bodies, max_outer = edge
    rng = np.random.default_rng(n * 1000 + n_occ + bodies)
    occupied = np.zeros(n, bool)
    occupied[rng.choice(n, n_occ, replace=False)] = True
    jstate = _jax_state(n, occupied, pos, sec, bodies * N_SUPER)
    # the JAX engine's cond, its formula as written there
    want = bool(((jnp.sum(jstate.pool.occupied) > te) | (jstate.backlog_pos < nv)
                 | (jstate.sec.count > 0)) & (jstate.it < max_outer))
    state = convert.from_jax_state(jstate)
    word, go = _word(bodies), torch.ones((), dtype=torch.bool)
    before = dict(hot_kernels.launches)
    out = hot_kernels.exit_test(
        state.pool.occupied, state.backlog_pos, state.sec.count,
        torch.tensor(nv, dtype=torch.int64), torch.tensor(te, dtype=torch.int64), word, go,
        N_SUPER, max_outer)
    assert hot_kernels.launches == before  # the plain version: no launch
    assert out[0] is word and out[1] is go
    assert bool(go) == want
    assert word.tolist() == [n_occ, pos, sec, bodies + want, int(want)]


# -- the scheduler ------------------------------------------------------------

class FakeRun:
    """A fake engine's run: ``n`` lanes, ``occ0`` of them occupied, a backlog
    of ``nv`` rows and ``sec0`` queued secondaries; each block retires two
    lanes, loads up to three rows and takes one secondary into free lanes,
    draws ``STEP`` from the generator and ends with the exit test
    (``engine.exit_test_plain``); the launches and phases are counted as
    the wrappers count them on the card."""

    STEP = 4

    def __init__(self, occ0, nv, sec0, te, max_outer, n=64):
        self.occ = torch.zeros(n, dtype=torch.bool)
        self.occ[:occ0] = True
        self.pos = torch.zeros((), dtype=torch.int64)
        self.nv, self.te = (torch.tensor(v, dtype=torch.int64) for v in (nv, te))
        self.sec = torch.tensor(sec0, dtype=torch.int64)
        self.word, self.go = _word(), torch.zeros((), dtype=torch.bool)
        self.max_outer, self.offset = max_outer, 0
        self.launches = {"body": 0, "exit_test": 0, "sweep": 0}
        self.phases = {"full": 0, "light": 0}

    def test(self):
        engine.exit_test_plain(self.occ, self.pos, self.sec, self.nv, self.te, self.word,
                               self.go, N_SUPER, self.max_outer)
        self.launches["exit_test"] += 1

    def read(self):
        return engine.ExitWord(*self.word.tolist())

    def body(self, draw=True):
        if draw:
            self.offset += self.STEP
        self.launches["body"] += 1
        self.phases["full"] += 1
        self.phases["light"] += 2
        on = torch.nonzero(self.occ).flatten()[:2]
        self.occ[on] = False
        take = min(3, int(self.nv - self.pos))
        free = torch.nonzero(~self.occ).flatten()
        self.occ[free[:take]] = True
        self.pos += take
        if int(self.sec) > 0:
            self.sec -= 1
            self.occ[torch.nonzero(~self.occ).flatten()[:1]] = True
        self.test()

    def state(self):
        return self.occ.clone(), int(self.pos), int(self.sec)


# (occupied, n_valid, secondaries, tail_exit, max_outer): blocks the run runs
RUNS = {"none": (3, 0, 0, 4, engine.MAX_OUTER), "one": (5, 0, 0, 3, engine.MAX_OUTER),
        "many": (20, 30, 5, 0, engine.MAX_OUTER), "cap": (20, 30, 5, 0, 7 * N_SUPER)}


def _host(spec, caplog):
    fake = FakeRun(*spec)
    words = []
    caplog.clear()
    fake.test()

    def body():
        words.append(fake.read())
        fake.body()

    out = engine.host_loop(fake.read(), body, fake.read, N_SUPER)
    words.append(out.word)
    return fake, out, words, [r.getMessage() for r in caplog.records]


def _pipelined(spec, k, caplog):
    """The graphed run's loop: a launch is a replay of k blocks, each its
    gated sweep, then the block where the word's go is set, then the copy
    of the word; the replay passes no Python counter (what it ran is
    credited by engine.run_credit), and advances the generator by the
    whole graph's draws."""
    fake = FakeRun(*spec)
    caplog.clear()
    fake.test()
    counts = dict(fake.launches), dict(fake.phases)
    base = fake.offset
    read = []

    def launch():
        fake.offset += k * FakeRun.STEP
        for _ in range(k):
            fake.launches["sweep"] += 1
            if bool(fake.go):
                fake.body(draw=False)
        return fake.word.clone()

    def read_word(handle):
        read.append(engine.ExitWord(*handle.tolist()))
        return read[-1]

    out = engine.pipelined_loop(fake.word.clone(), launch, read_word, N_SUPER)
    fake.launches, fake.phases = counts  # the replays counted nothing
    launched, phased = engine.run_credit(({"body": 1, "exit_test": 1}, {"full": 1, "light": 2}),
                                         ({"sweep": k}, {}), out.word.bodies, out.replays)
    for d, add in ((fake.launches, launched), (fake.phases, phased)):
        for name, v in add.items():
            d[name] += v
    fake.offset = engine.rewound_offset(fake.offset, base, FakeRun.STEP, k, out.replays,
                                        out.word.bodies)
    return fake, out, read, [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("run", list(RUNS))
def test_pipelined_loop_runs_what_the_host_loop_runs(run, k, caplog, monkeypatch):
    monkeypatch.setattr(engine, "PROGRESS_ITERS", 2 * N_SUPER)
    caplog.set_level(logging.INFO, logger=engine.__name__)
    spec = RUNS[run]
    host, out_h, words_h, log_h = _host(spec, caplog)
    pipe, out_p, words_p, log_p = _pipelined(spec, k, caplog)
    bodies = out_h.word.bodies
    assert bodies == {"none": 0, "one": 1, "cap": 7}.get(run, bodies) and bodies >= 0
    if run == "many":
        assert 7 < bodies < 40
    assert out_p.word == out_h.word and out_p.word.go == 0
    # the state, the iterations, the blocks' launches and phases, the
    # generator: the host loop's
    a, b = host.state(), pipe.state()
    assert torch.equal(a[0], b[0]) and a[1:] == b[1:]
    assert pipe.phases == host.phases == {"full": bodies, "light": 2 * bodies}
    assert pipe.launches["body"] == host.launches["body"] == bodies
    assert pipe.offset == host.offset == bodies * FakeRun.STEP
    # the exit tests: the entry's, then one at the end of each block; the
    # sweeps: k a replay; one replay past the exit, which ran no block
    assert host.launches["exit_test"] == pipe.launches["exit_test"] == 1 + bodies
    assert pipe.launches["sweep"] == k * out_p.replays
    assert out_p.skipped == 1 and out_p.replays == -(-bodies // k) + 1
    # the words read: the host loop's at every k-th block, its last among
    # them; the progress log the host loop's where k = 1
    assert words_p == [w for w in words_h if (w.bodies - w.go) % k == 0 or not w.go]
    if k == 1:
        assert log_p == log_h
    if run in ("many", "cap"):
        assert log_h and all("engine run:" in m for m in log_h)


def test_rewound_offset_refuses_a_generator_that_moved_otherwise():
    assert engine.rewound_offset(100 + 3 * 2 * 4, 100, 4, 2, 3, 5) == 120
    with pytest.raises(RuntimeError, match="generator moved"):
        engine.rewound_offset(100 + 3 * 2 * 4 + 4, 100, 4, 2, 3, 5)


# -- on the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the exit test's kernel and the graph's "
                    "conditional nodes run only there")


POOL = 256
WAVE = 150
CASES = [(ref, dt) for ref in (False, True) for dt in (torch.float32, torch.float64)]
IDS = [f"{'reference' if ref else 'shipped'}-{str(dt)[6:]}" for ref, dt in CASES]


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    from grmonty_tpu_torch.models import torus

    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return str(path)


def _sim(dump, reference, dtype, graphed):
    make = profiles.reference_config if reference else profiles.bench_config
    cfg = make(pool=POOL, dtype=dtype)._replace(m_period=8, sec_cap=32, stall_steps=2000)
    return driver.Simulation(dump, photon_n=600, mass_unit=4.0e18, seed=123, config=cfg,
                             device="cuda", warmup=0, tail_stall_steps=2000, graphed=graphed)


def _bits(t):
    if t.is_floating_point():
        return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)
    return t


def _two_runs(sim):
    """A wave run until at most half the pool is occupied, then a cascade
    stage's run on what is left."""
    sim.plan()
    rows = sim.emit_rows(0, WAVE)
    eng = sim.engine
    eng.reserve_backlog(WAVE)
    out = [eng.run(eng.fresh_state(), rows, tail_exit=POOL // 2)]
    small, _ = driver.tail_gather(out[0].pool, POOL)
    tstate = engine.State(pool=small, spec=out[0].spec, counters=out[0].counters,
                          sec=out[0].sec, backlog_pos=torch.zeros_like(out[0].backlog_pos),
                          it=0)
    empty = torch.zeros((1, engine.ROW_WIDTH), dtype=sim.cfg.dtype, device=sim.device)
    stage = sim._tail_engine(POOL, 0)
    out.append(stage.run(tstate, empty, n_valid=0))
    return out, [eng, stage]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("reference,dtype", CASES, ids=IDS)
def test_graphed_loop_equals_the_host_loop_on_the_card(dump, reference, dtype, k,
                                                       monkeypatch):
    _card()
    monkeypatch.setattr(engine, "GRAPH_BODIES", k)
    runs = {}
    for graphed in (True, False):
        sim = _sim(dump, reference, dtype, graphed)
        hot_kernels.reset_launches()
        out, engines = _two_runs(sim)
        torch.cuda.synchronize()
        runs[graphed] = (out, sim.gen.get_state(), dict(hot_kernels.launches),
                         [dict(e.phases) for e in engines],
                         [(e.replays, e.bodies, e.skipped) for e in engines])
    (got, gen_g, launches_g, phases_g, counts_g), (want, gen_e, launches_e, phases_e,
                                                   counts_e) = runs[True], runs[False]
    names = list(driver._flat_state(want[0]))
    for i, (g, w) in enumerate(zip(got, want)):
        for name, a, b in zip(names, engine.state_tensors(g), engine.state_tensors(w),
                              strict=True):
            if name == "spec":  # float atomics sum it
                torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)
            else:
                assert torch.equal(_bits(a), _bits(b)), f"run {i}: {name}"
        assert g.it == w.it > 0
    assert torch.equal(gen_g, gen_e)
    replays, bodies, skipped = (sum(c[j] for c in counts_g) for j in range(3))
    assert bodies == sum(c[1] for c in counts_e) == sum(p["full"] for p in phases_g)
    assert skipped == 2 and all(c[0] == -(-c[1] // k) + 1 for c in counts_g)
    # the exit test at each run's entry and at the end of each block; the
    # gated sweep in each of a replay's k blocks (graphed)
    record = hot_kernels.entry_point("record_phase", dtype)
    assert launches_e.pop("exit_test") == launches_g.pop("exit_test") == 2 + bodies
    assert launches_g.pop(record) - launches_e.pop(record) == k * replays - bodies
    assert launches_g == launches_e and phases_g == phases_e


@pytest.mark.cuda
def test_a_replay_after_the_run_changes_no_byte(dump):
    _card()
    sim = _sim(dump, False, torch.float32, True)
    out, (eng, _) = _two_runs(sim)
    torch.cuda.synchronize()
    before = [t.clone() for t in engine.state_tensors(eng._state)]
    word, backlog = eng._exit_word.clone(), eng._backlog.clone()
    assert word[4] == 0 and int(word[3]) == eng.bodies > 0
    eng._replay()
    torch.cuda.synchronize()
    for a, b in zip(engine.state_tensors(eng._state), before, strict=True):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(eng._exit_word, word) and torch.equal(eng._backlog, backlog)


@pytest.mark.cuda
def test_a_run_whose_exit_holds_at_entry_runs_no_block(dump):
    _card()
    sim = _sim(dump, True, torch.float32, True)
    eng = sim.engine
    eng.reserve_backlog(WAVE)
    sim.plan()
    rows = sim.emit_rows(0, WAVE)
    eng.run(eng.fresh_state(), rows, tail_exit=0)  # captured, lanes drained
    state = eng.fresh_state()
    g0 = sim.gen.get_state()
    hot_kernels.reset_launches()
    out = eng.run(state, rows, tail_exit=0, n_valid=0)
    torch.cuda.synchronize()
    assert (eng.replays, eng.bodies, eng.skipped) == (1, 0, 1)
    assert out.it == 0 and eng.phases == {"full": 0, "light": 0}
    assert torch.equal(sim.gen.get_state(), g0)
    # the entry test, the skipped replay's gated sweeps, the closing flush
    assert {k: v for k, v in hot_kernels.launches.items() if v} == {
        "exit_test": 1, "record_phase": eng.graph_bodies + 1}
    for a, b in zip(engine.state_tensors(out), engine.state_tensors(state), strict=True):
        assert torch.equal(_bits(a), _bits(b))


def _kernel_edges(count):
    """(tail_exit, backlog_pos, n_valid, sec, bodies, max_outer) for a mask
    of ``count`` set lanes at N_SUPER: every term false; each term true
    alone under the cap (5 * 8 < 48); all true at the cap (6 * 8 == 48)
    and past it."""
    return ((count, 3, 3, 0, 0, engine.MAX_OUTER), (count - 1, 3, 3, 0, 5, 48),
            (count, 2, 3, 0, 5, 48), (count, 3, 3, 1, 5, 48), (count - 1, 0, 9, 4, 6, 48),
            (count, 0, 9, 4, 7, 48))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 4096, 1024, 512])
def test_exit_test_kernel_equals_its_plain_version(n):
    _card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(n)
    gos = set()
    for density in (0.0, 0.003, 0.5, 1.0):
        for shift in (0, 1, 7, 15):  # the mask's unaligned head and tail
            base = torch.as_tensor(rng.random(n + 16) < density, device=dev)
            occ = base[shift:shift + n]
            for te, pos, nv, sec, bodies, cap in _kernel_edges(int(occ.sum())):
                scal = [torch.tensor(v, dtype=torch.int64, device=dev)
                        for v in (pos, sec, nv, te)]
                outs = []
                for fn in (hot_kernels.exit_test, engine.exit_test_plain):
                    word = torch.full((engine.EXIT_WORD,), -5, dtype=torch.int64, device=dev)
                    word[3] = bodies
                    go = torch.zeros((), dtype=torch.bool, device=dev)
                    fn(occ, scal[0], scal[1], scal[2], scal[3], word, go, N_SUPER, cap)
                    outs.append((word.tolist(), bool(go)))
                assert outs[0] == outs[1], (n, density, shift, te, pos, nv, sec, bodies)
                gos.add(outs[1][1])
    assert gos == {False, True}
