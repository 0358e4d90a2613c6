"""The pool's compaction spread over the card's SMs (``hot_kernels.compact``,
``csrc/compact.cu``'s mask mode: 4 KB tiles over the blocks, every block
counting the whole mask), and the ring's pack spread the same way
(``hot_kernels.compact_rows``, rows mode: tiles of 128 slots, the last
block to take the ticket updating the count; one block up to 512).

* CPU: the Python model of the launch's partition
  (``compact_tiles``: each block's tile, its ranks and its
  share of the pad) at the tile edges: no set lane, k of them, set lanes in
  the last tile only, at both tiles' edges, N not a multiple of the tile;
  the tiles equal ``engine.compact_idx`` and the JAX sort, every slot
  written by exactly one block.
* On the card (``cuda`` tests, ``python -m pytest --noconftest -m cuda
  tests/test_torch_compact.py``): the kernel bit for bit the sort at the
  path's widths (65,536 lanes, k = 12,288, 16,384 and 32,768) and at the
  tile edges, a mask view at an odd byte offset included; the event set's
  ``compact`` and ``event_phase`` captured in one CUDA graph and replayed
  twice on the same inputs give the same bits as each other and as the
  eager launches.  JAX is imported inside the CPU tests, so the card tests
  run where JAX is missing.
* The pack, CPU: the Python model of its tiles and count update
  (``compact_rows_tiles``) against ``engine.pack_rows_plain`` at the tile
  edges and at no room, some room and ample room, every kept row written
  by one block and no other ring row touched.  On the card: the kernel bit
  for bit the plain pack at K = 1, 256, 511, 512, 4,096, 16,384, 16,385 and
  32,768 in both dtypes (every threads-a-block instance), and a CUDA
  graph of it replayed twice (the ticket back at zero each time).
"""

import numpy as np
import pytest
import torch

from grmonty_tpu_torch.models import torus
from grmonty_tpu_torch.ops import draws
from grmonty_tpu_torch.transport import driver, engine, hot_kernels, profiles

TILE = hot_kernels.COMPACT_TILE


def compact_tiles(mask, k):
    """The Python model of ``compact``'s mask mode on the card: blocks of
    ``TILE`` lanes, each counting the set lanes before its tile and in all,
    writing its tile's set lanes of rank below ``k`` at their ranks and its
    share of the pad [total, k) by a grid stride of 256 slots a block (one
    block up to a tile).  Returns (valid, gi, sidx) and the block that wrote
    each slot (-1 for none); raises where two blocks write one slot."""
    m = mask.to(torch.bool).cpu()
    n = m.shape[0]
    blocks = -(-n // TILE)
    valid = torch.zeros(k, dtype=torch.bool)
    gi = torch.full((k,), -1, dtype=torch.int64)
    sidx = torch.full((k,), -1, dtype=torch.int64)
    writer = torch.full((k,), -1, dtype=torch.int64)
    total = int(m.sum())
    slot = torch.arange(k)

    def claim(at, b):
        if bool((writer[at] >= 0).any()):
            raise AssertionError(f"block {b}: a slot of {at.tolist()[:4]}... written twice")
        writer[at] = b

    for b in range(blocks):
        lo, hi = b * TILE, min(n, (b + 1) * TILE)
        base = int(m[:lo].sum())
        lanes = torch.nonzero(m[lo:hi]).flatten() + lo
        keep = max(0, min(lanes.numel(), k - base))
        at = slot[base:base + keep]
        claim(at, b)
        valid[at], gi[at], sidx[at] = True, lanes[:keep], lanes[:keep]
        q = slot[total:]
        pad = q[((q - total) % (blocks * 256)) // 256 == b]
        claim(pad, b)
        valid[pad], gi[pad], sidx[pad] = False, n - 1, n
    return valid, gi, sidx, writer


def _mask(n, case, seed):
    """A seeded (n,) bool mask of one tile-edge ``case``."""
    rng = np.random.default_rng(seed)
    m = np.zeros(n, bool)
    if case == "dense":
        m = rng.random(n) < 0.7
    elif case == "sparse":
        m = rng.random(n) < 0.02
    elif case == "last_tile":
        lo = (n - 1) // TILE * TILE
        m[lo:] = rng.random(n - lo) < 0.5
        m[n - 1] = True
    elif case == "tile_ends":
        m[TILE - 1::TILE] = True
        m[TILE::TILE] = True
        m[n - 1] = True
    elif case != "none":
        raise ValueError(case)
    return m


def _ks(n, count):
    """k below, at and above the set count, the tile's edges and n."""
    return sorted({k for k in (1, count // 2, count, count + 1, TILE - 1, TILE, TILE + 1, n)
                   if 1 <= k <= n})


def _jax_compact(mask, k):
    import jax
    import jax.numpy as jnp

    n = mask.shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (n,), 0)
    idx = jax.lax.sort(jnp.where(jnp.asarray(mask), lane, n))[:k]
    valid = idx < n
    return valid, jnp.minimum(idx, n - 1), jnp.where(valid, idx, n)


CASES = ("none", "sparse", "dense", "last_tile", "tile_ends")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n", [512, TILE, TILE + 1, 12345, 65536])
def test_the_tiles_equal_the_sort_at_the_tile_edges(n, case):
    mask = _mask(n, case, n)
    count = int(mask.sum())
    for k in _ks(n, count):
        valid, gi, sidx, writer = compact_tiles(torch.as_tensor(mask), k)
        assert bool((writer >= 0).all()), (k, "a slot no block writes")
        want = engine.compact_idx(torch.as_tensor(mask), k)
        for g, w, name in zip((valid, gi, sidx), want, ("valid", "gi", "sidx")):
            assert torch.equal(g, w), (k, name)
    j = _jax_compact(mask, min(n, count + 3))
    got = hot_kernels.compact(torch.as_tensor(mask), min(n, count + 3))
    for g, w in zip(got, j):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def test_each_block_writes_its_own_tile_and_share_of_the_pad():
    n, k = 3 * TILE + 5, 3 * TILE
    mask = _mask(n, "sparse", 4)
    _, _, _, writer = compact_tiles(torch.as_tensor(mask), k)
    total = int(mask.sum())
    before = np.concatenate([[0], np.cumsum([mask[b * TILE:(b + 1) * TILE].sum()
                                             for b in range(4)])])
    for b in range(4):  # the set lanes' slots by tile
        assert bool((writer[before[b]:before[b + 1]] == b).all())
    blocks = -(-n // TILE)
    pad = torch.arange(total, k)
    assert torch.equal(writer[total:], ((pad - total) % (256 * blocks)) // 256)


def compact_rows_tiles(stage, sec, counters, threads=128):
    """The Python model of ``compact_rows`` on the card: blocks of
    ``threads`` slots, each counting the flags before its tile and in all,
    the kept rows min(total, room) of the ring's room, each block writing
    its tile's flagged rows of rank below that at count + rank; the last
    block sets the count and n_sec_drop.  Returns (ring rows, count,
    n_sec_drop, the block that wrote each ring row or -1); raises where two
    blocks write one row."""
    make = stage.make.cpu()
    k, cap = make.shape[0], sec.rows.shape[0]
    c0 = int(sec.count)
    room = max(cap - c0, 0)
    total = int(make.sum())
    kept = min(total, room)
    rows = sec.rows.cpu().clone()
    writer = torch.full((cap,), -1, dtype=torch.int64)
    for b in range(-(-k // threads)):
        lo, hi = b * threads, min(k, (b + 1) * threads)
        base = int(make[:lo].sum())
        slots = torch.nonzero(make[lo:hi]).flatten() + lo
        keep = min(slots.numel(), max(kept - base, 0))
        at = c0 + base + torch.arange(keep)
        if bool((writer[at] >= 0).any()):
            raise AssertionError(f"block {b}: a ring row written twice")
        writer[at] = b
        rows[at] = stage.rows.cpu()[slots[:keep]]
    return rows, c0 + kept, int(counters.n_sec_drop) + total - kept, writer


ROWS_KS = (1, 127, 128, 129, 511, 512, 513, 4096, 16385)


@pytest.mark.parametrize("threads", [128, 256, 512])
@pytest.mark.parametrize("k", ROWS_KS)
def test_the_packs_tiles_equal_the_plain_pack(k, threads):
    """Every room case: none, one row, part of the flagged rows, all of them
    and more; flags at the tiles' edges, in the last tile only and
    everywhere."""
    edges = [j for j in range(k) if j % threads in (0, threads - 1)] + [k - 1]
    for made in (0, max(1, k // 3), k, sorted(set(edges)), [k - 1]):
        count = made if isinstance(made, int) else len(made)
        for room in sorted({0, 1, count // 2, max(0, count - 1), count, count + 5}):
            stage, sec, counters = hot_kernels.synthetic_rows(k, made, room, torch.float64,
                                                              "cpu", 7)
            rows, c, drop, writer = compact_rows_tiles(stage, sec, counters, threads)
            rsec, rc = engine.pack_rows_plain(stage, sec, counters)
            assert torch.equal(rows, rsec.rows), (made, room)
            assert c == int(rsec.count) and drop == int(rc.n_sec_drop), (made, room)
            kept = min(count, room)
            c0 = int(sec.count)
            assert bool((writer[c0:c0 + kept] >= 0).all()), (made, room)
            assert int((writer >= 0).sum()) == kept, (made, room)


def test_a_wedged_ring_drops_every_row_and_writes_none():
    stage, sec, counters = hot_kernels.synthetic_rows(4096, 1500, 0, torch.float32, "cpu", 9)
    rows, c, drop, writer = compact_rows_tiles(stage, sec, counters)
    assert torch.equal(rows, sec.rows) and c == int(sec.count)
    assert drop == int(counters.n_sec_drop) + 1500 and not bool((writer >= 0).any())
    # a count past the capacity (no room) drops them too, as the plain pack
    over = engine.SecBuf(sec.rows, sec.count + 5)
    rsec, rc = engine.pack_rows_plain(stage, over, counters)
    rows, c, drop, _ = compact_rows_tiles(stage, over, counters)
    assert torch.equal(rows, rsec.rows) and c == int(rsec.count) == int(over.count)
    assert drop == int(rc.n_sec_drop)


def test_on_the_cpu_the_pack_is_the_plain_pack():
    stage, sec, counters = hot_kernels.synthetic_rows(512, 200, 150, torch.float32, "cpu", 11)
    got = hot_kernels.compact_rows(stage, sec, counters)
    want = engine.pack_rows_plain(stage, sec, counters)
    assert torch.equal(got[0].rows, want[0].rows) and torch.equal(got[0].count, want[0].count)
    assert torch.equal(got[1].n_sec_drop, want[1].n_sec_drop)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")


def _equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want, strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [12288, 16384, 32768])
def test_compact_at_the_path_widths_on_the_card(k):
    _card()
    rng = np.random.default_rng(k)
    for density in (0.0, 0.02, 0.1, 0.25, 0.3, 0.5, 1.0):
        mask = torch.as_tensor(rng.random(65536) < density, device="cuda")
        assert _equal(hot_kernels.compact(mask, k), engine.compact_idx(mask, k)), density


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, TILE, TILE + 1, 12345, 65535, 65536])
def test_compact_at_the_tile_edges_on_the_card(n):
    _card()
    for case in CASES:
        mask = torch.as_tensor(_mask(n, case, n + 1), device="cuda")
        for k in _ks(n, int(mask.sum())):
            assert _equal(hot_kernels.compact(mask, k), engine.compact_idx(mask, k)), (case, k)
        # the same mask as a view at an odd byte offset: byte loads
        base = torch.zeros(n + 3, dtype=torch.bool, device="cuda")
        base[3:] = mask
        view = base[3:]
        k = max(1, min(n, int(mask.sum()) + 7))
        assert _equal(hot_kernels.compact(view, k), engine.compact_idx(mask, k)), case


@pytest.fixture(scope="module")
def card_sims(tmp_path_factory):
    _card()
    path = tmp_path_factory.mktemp("dumps") / "torus_dump"
    torus.write_torus_dump(str(path), n1=64, n2=32)
    return {dt: driver.Simulation(str(path), photon_n=100, mass_unit=4e19, device="cuda",
                                  config=profiles.bench_config(pool=1024, dtype=dt),
                                  emit_chunk=256, warmup=0)
            for dt in (torch.float32, torch.float64)}


def _fields(pool):
    return [t for t in hot_kernels._flat(pool._asdict()).values() if t is not None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_compact_and_event_phase_replay_from_a_graph(card_sims, dtype):
    """The event set's compaction and the event phase captured in one CUDA
    graph, replayed twice on the same pool (restored between the replays),
    give the same bits as each other and as the eager launches, which are
    the plain phase's on the same key."""
    import gc

    sim = card_sims[dtype]
    eng = sim.engine
    n, k = 65536, 16384
    pool, sec, counters, den = hot_kernels.synthetic_event_pool(eng, n, k, 91, "room")
    key = torch.tensor([0x5EED, 0xFACE], dtype=torch.int64, device="cuda")
    work = engine.clone_pool(pool)
    wc = engine.Counters(*(t.clone() for t in counters))

    def block():
        sel, room, wedged = engine.event_set(work, sec, k)
        _, _, stage = hot_kernels.event_phase(work, wc, sel, room, wedged, den, eng.mc,
                                              eng.tables, key=key)
        return sel, stage

    def restore():
        for dst, src in zip(_fields(work), _fields(pool), strict=True):
            dst.copy_(src)
        for dst, src in zip(wc, counters, strict=True):
            dst.copy_(src)

    def snap(out):
        sel, stage = out
        return [t.clone() for t in (*sel, stage.make, stage.rows[stage.make], *_fields(work),
                                    *wc)]

    eager = snap(block())
    sel, room, wedged = engine.event_set(pool, sec, k)
    rp, rc, rs = engine.event_phase_plain(pool, counters, sel, room, wedged, den, eng.mc,
                                          eng.tables, draws.PhiloxDraws(key))
    for f in ("ev_tries", "alive", "occupied", "at_event", "ev_pending", "w"):
        assert bool(hot_kernels._same_bits(getattr(work, f), getattr(rp, f)).all()), f
    assert torch.equal(eager[3], rs.make) and torch.equal(wc.n_ev_soft, rc.n_ev_soft)
    restore()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        block()  # warm-up on a side stream, as a capture wants
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = block()
    finally:
        gc.enable()
    replays = []
    for _ in range(2):
        restore()
        graph.replay()
        torch.cuda.synchronize()
        replays.append(snap(out))
    for a, b, c in zip(replays[0], replays[1], eager, strict=True):
        assert bool(hot_kernels._same_bits(a, b).all() & hot_kernels._same_bits(a, c).all())


def _pack_on_card(stage, sec, counters, ticket):
    wsec = engine.SecBuf(*(t.clone() for t in sec))
    wc = engine.Counters(*(t.clone() for t in counters))
    gsec, gc = hot_kernels.compact_rows(stage, wsec, wc, ticket)
    assert gsec.rows is wsec.rows and gc.n_sec_drop is wc.n_sec_drop
    return gsec, gc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("k", [1, 256, 511, 512, 4096, 16384, 16385, 32768])
def test_compact_rows_matches_the_plain_pack_on_the_card(k, dtype):
    """At each of the pack's shapes (one block of 128, 256 and 512 threads;
    128-slot tiles) and its edges, one ticket for every pack."""
    _card()
    name = hot_kernels.entry_point("compact_rows", dtype)
    ticket = hot_kernels.rows_ticket("cuda")
    for made in (0, 1, k // 3, (4 * k) // 5, k):
        for room in sorted({0, made // 2, made + 3}):
            stage, sec, counters = hot_kernels.synthetic_rows(k, made, room, dtype, "cuda", 13)
            rsec, rc = engine.pack_rows_plain(stage, sec, counters)
            before = hot_kernels.launches[name]
            gsec, gc = _pack_on_card(stage, sec, counters, ticket)
            torch.cuda.synchronize()
            assert hot_kernels.launches[name] == before + 1
            assert bool(hot_kernels._same_bits(gsec.rows, rsec.rows).all()), (made, room)
            assert torch.equal(gsec.count, rsec.count), (made, room)
            assert torch.equal(gc.n_sec_drop, rc.n_sec_drop), (made, room)
            assert int(ticket[0]) == 0, (made, room)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_compact_rows_replays_from_a_graph(dtype):
    """The pack captured in a CUDA graph and replayed twice on the same ring
    (its count and n_sec_drop restored between the replays) gives the plain
    pack's bits each time: the ticket is back at zero after every launch."""
    import gc

    _card()
    stage, sec, counters = hot_kernels.synthetic_rows(16384, 13000, 14000, dtype, "cuda", 17)
    rsec, rc = engine.pack_rows_plain(stage, sec, counters)
    work = engine.SecBuf(*(t.clone() for t in sec))
    wc = engine.Counters(*(t.clone() for t in counters))
    ticket = hot_kernels.rows_ticket("cuda")  # outside the capture

    def restore():
        work.rows.copy_(sec.rows)
        work.count.copy_(sec.count)
        wc.n_sec_drop.copy_(counters.n_sec_drop)

    restore()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        hot_kernels.compact_rows(stage, work, wc, ticket)  # warm-up on a side stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            hot_kernels.compact_rows(stage, work, wc, ticket)
    finally:
        gc.enable()
    for _ in range(2):
        restore()
        graph.replay()
        torch.cuda.synchronize()
        assert bool(hot_kernels._same_bits(work.rows, rsec.rows).all())
        assert torch.equal(work.count, rsec.count) and torch.equal(wc.n_sec_drop, rc.n_sec_drop)
        assert int(ticket[0]) == 0
