"""The pool's compaction spread over the card's SMs (``hot_kernels.compact``,
``csrc/compact.cu``'s mask mode: 4 KB tiles over the blocks, every block
counting the whole mask).

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
