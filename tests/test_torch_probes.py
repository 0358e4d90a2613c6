"""The port's gather probes against the JAX package's, on the CPU.

The JAX probes (``tools/probe_gather.py``, ``tools/probe_pallas_gather.py``,
``tools/probe_vmem_gather.py``) define their Pallas kernels inside
``main()``, so each kernel body and its ``pl.pallas_call`` are restated
below with the tool file's specs and run with ``interpret=True``.  The one
change: ``pallas_ds`` reads and writes its rows by ref indexing with
``pl.ds``, since this JAX has no ``pl.load``/``pl.store``.  On numpy-seeded
inputs the port's wrappers (their plain versions on CPU tensors, no launch
counted) must give the same row sums within ``hot_kernels.rowsum_slack``
(another summation order) and the same rows bitwise; each probe's
``experiments(device="cpu")`` callable must match its JAX expression.

JAX is imported inside a fixture, so that the kernel test, which needs no
JAX, also runs on the card:
``python -m pytest --noconftest -m cuda tests/test_torch_probes.py``.
"""

import types

import numpy as np
import pytest
import torch

from grmonty_tpu_torch.tools import chain_ms, probe_gather, probe_pallas_gather, probe_vmem_gather
from grmonty_tpu_torch.transport import hot_kernels

BLK = 128
EPS = 2.0 ** -23


@pytest.fixture(scope="module")
def px():
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    return types.SimpleNamespace(jax=jax, jnp=jnp, lax=lax, pl=pl, pltpu=pltpu)


def pallas_probe(px, name, table, idx, blk=BLK):
    """The JAX probe's Pallas function ``name`` on numpy ``table`` (z, w)
    and ``idx`` (n,), n a multiple of ``blk``, in interpret mode."""
    jax, jnp, lax, pl, pltpu = px.jax, px.jnp, px.lax, px.pl, px.pltpu
    z, w = table.shape
    n = idx.shape[0]
    dt = jnp.float32
    t, i = jnp.asarray(table), jnp.asarray(idx)
    vmem, smem = pltpu.VMEM, pltpu.SMEM

    def blocked_1d(kernel, out_w=None, idx_space=vmem, **kw):
        out_shape = (n,) if out_w is None else (n, out_w)
        out_block = (blk,) if out_w is None else (blk, out_w)
        return pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(out_shape, dt), grid=(n // blk,),
            in_specs=[pl.BlockSpec((blk,), lambda g: (g,), memory_space=idx_space),
                      pl.BlockSpec((z, w), lambda g: (0, 0), memory_space=vmem)],
            out_specs=pl.BlockSpec(out_block, lambda g: (g,) + (0,) * (out_w is not None),
                                   memory_space=vmem),
            interpret=True, **kw)(i, t)

    # tools/probe_gather.py:104 and tools/probe_vmem_gather.py:106
    def take_kernel(idx_ref, table_ref, out_ref):
        rows = jnp.take(table_ref[:], idx_ref[:], axis=0)
        out_ref[:] = jnp.sum(rows, axis=1)

    # tools/probe_gather.py:133
    def loop_kernel(idx_ref, table_ref, out_ref):
        def body(k, acc):
            row = table_ref[idx_ref[k], :]
            return acc.at[k].set(jnp.sum(row))
        out_ref[:] = lax.fori_loop(0, blk, body, jnp.zeros((blk,), dt))

    # tools/probe_pallas_gather.py:74 and :99
    def take2d_kernel(idx_ref, table_ref, out_ref):
        rows = jnp.take(table_ref[:], idx_ref[0, :], axis=0)
        out_ref[0, :] = jnp.sum(rows, axis=1)

    # tools/probe_pallas_gather.py:125
    def dsB_kernel(idx_ref, table_ref, out_ref, rows_ref):
        def body(k, _):
            rows_ref[pl.ds(k, 1), :] = table_ref[pl.ds(idx_ref[0, k], 1), :]
            return 0
        lax.fori_loop(0, blk, body, 0)
        out_ref[0, :] = jnp.sum(rows_ref[:], axis=1)

    # tools/probe_vmem_gather.py:142
    def taa_kernel(idx_ref, table_ref, out_ref):
        idx2 = lax.broadcast_in_dim(idx_ref[:], (blk, w), (0,))
        rows = jnp.take_along_axis(table_ref[:], idx2, axis=0)
        out_ref[:] = jnp.sum(rows, axis=1)

    # tools/probe_vmem_gather.py:178
    def ds_kernel(idx_ref, table_ref, out_ref):
        def body(k, _):
            r = table_ref[pl.ds(idx_ref[k], 1), :]
            out_ref[pl.ds(k, 1), :] = r
            return 0
        lax.fori_loop(0, blk, body, 0, unroll=8)

    def grid_2d(kernel, space, **kw):
        return pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((n // blk, blk), dt), grid=(n // blk,),
            in_specs=[pl.BlockSpec((1, blk), lambda g: (g, 0), memory_space=space),
                      pl.BlockSpec((z, w), lambda g: (0, 0), memory_space=vmem)],
            out_specs=pl.BlockSpec((1, blk), lambda g: (g, 0), memory_space=vmem),
            interpret=True, **kw)(i.reshape(n // blk, blk), t).reshape(n)

    vmem_limit = pltpu.CompilerParams(vmem_limit_bytes=z * w * 4 + 8 * blk * 4 + (1 << 20))
    if name == "pallas_gather":
        out = blocked_1d(take_kernel)
    elif name == "pallas_loop":
        out = blocked_1d(loop_kernel)
    elif name == "take1":
        out = pl.pallas_call(
            take2d_kernel, out_shape=jax.ShapeDtypeStruct((1, n), dt),
            in_specs=[pl.BlockSpec(memory_space=vmem), pl.BlockSpec(memory_space=vmem)],
            out_specs=pl.BlockSpec(memory_space=vmem),
            compiler_params=pltpu.CompilerParams(
                vmem_limit_bytes=int(z * w * 4 + n * w * 4 + (8 << 20))),
            interpret=True)(i.reshape(1, n), t)[0]
    elif name == "takeB":
        out = grid_2d(take2d_kernel, space=vmem)
    elif name == "dsB":
        out = grid_2d(dsB_kernel, space=smem, scratch_shapes=[pltpu.VMEM((blk, w), dt)])
    elif name == "pallas_take":
        out = blocked_1d(take_kernel, compiler_params=vmem_limit)
    elif name == "pallas_taa":
        out = blocked_1d(taa_kernel, compiler_params=vmem_limit)
    elif name == "pallas_ds":
        out = blocked_1d(ds_kernel, out_w=w, idx_space=smem)
    else:
        raise KeyError(name)
    return np.asarray(out)


# Each Pallas function and the port's counterpart (on the CPU, its plain
# version through the wrapper).
COUNTERPARTS = {
    "pallas_gather": lambda t, i: hot_kernels.gather_rowsum(t, i, "coop"),
    "pallas_loop": lambda t, i: hot_kernels.gather_rowsum(t, i, "rowloop"),
    "take1": lambda t, i: hot_kernels.gather_rowsum(t, i, "persistent"),
    "takeB": lambda t, i: hot_kernels.gather_rowsum(t, i, "coop"),
    "dsB": lambda t, i: hot_kernels.gather_rowsum(t, i, "smem", blk=BLK),
    "pallas_take": lambda t, i: hot_kernels.gather_rowsum(t, i, "coop"),
    "pallas_taa": lambda t, i: hot_kernels.gather_rowsum(t, i, "coop"),
    "pallas_ds": hot_kernels.row_gather_rowloop,
}


def assert_rowsums(got, ref, table, idx):
    """Row sums of ``table[idx]`` within ``rowsum_slack`` of ``ref``."""
    got = torch.tensor(np.asarray(got, np.float64))
    ref = torch.tensor(np.asarray(ref, np.float64))
    slack = hot_kernels.rowsum_slack(torch.as_tensor(table), torch.as_tensor(idx))
    assert got.shape == ref.shape == slack.shape
    assert bool((torch.abs(got - ref) <= slack).all()), float((torch.abs(got - ref) - slack).max())


def inputs(z, w, n, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((z, w)).astype(np.float32)
    idx = rng.integers(0, z - 1, n).astype(np.int32)
    idx[:2] = (0, z - 2)
    return table, idx


@pytest.mark.parametrize("name", sorted(COUNTERPARTS))
@pytest.mark.parametrize("z, w, n", [(256, 8, 512), (1024, 32, 1024), (256, 216, 512)])
def test_port_matches_pallas_probe(px, name, z, w, n):
    table, idx = inputs(z, w, n, z + w + n)
    ref = pallas_probe(px, name, table, idx)
    before = dict(hot_kernels.launches)
    got = COUNTERPARTS[name](torch.as_tensor(table), torch.as_tensor(idx))
    assert hot_kernels.launches == before
    assert got.dtype == torch.float32
    if name == "pallas_ds":
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        assert_rowsums(got, ref, table, idx)


@pytest.mark.parametrize("strategy", hot_kernels.ROWSUM_STRATEGIES + ("row_gather_rowloop",))
def test_ragged_edge_matches_numpy(strategy):
    """n = 1000 is a multiple of no block: the wrappers still give every row."""
    table, idx = inputs(1024, 32, 1000, 7)
    t, i = torch.as_tensor(table), torch.as_tensor(idx)
    if strategy == "row_gather_rowloop":
        np.testing.assert_array_equal(hot_kernels.row_gather_rowloop(t, i).numpy(), table[idx])
    else:
        got = hot_kernels.gather_rowsum(t, i, strategy, blk=BLK)
        assert tuple(got.shape) == (1000,)
        assert_rowsums(got, table[idx].astype(np.float64).sum(1), table, idx)


def test_gather_rowsum_rejects_an_unknown_strategy():
    table, idx = inputs(256, 8, 512, 1)
    with pytest.raises(ValueError, match="strategy"):
        hot_kernels.gather_rowsum(torch.as_tensor(table), torch.as_tensor(idx), "take")


def _close(got, ref, scale, terms):
    """|got - ref| <= terms * 2^-23 * scale, elementwise: ``scale`` is the
    expression on absolute values, which bounds the rounding of either
    order of ``terms`` float32 operations."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= terms * EPS * np.asarray(scale, np.float64))


def test_probe_gather_experiments_match_jax(px):
    jnp = px.jnp
    n, z, widths = 512, 1024, (8, 32, 216)
    data, fns = probe_gather.experiments("cpu", n=n, z=z, widths=widths,
                                         gen=np.random.default_rng(3))
    idx = data["idx"]
    assert idx.min() >= 0 and idx.max() < z - 2
    i, i_sorted = jnp.asarray(idx), jnp.asarray(data["idx_sorted"])

    def four(t, k):
        return (t[k] + t[k + 1] + t[jnp.minimum(k + 256, z - 1)]
                + t[jnp.minimum(k + 257, z - 1)]).sum(axis=1)

    def blend(rows):
        return rows[:, 0:8] * 0.3 + rows[:, 8:16] * 0.2 + rows[:, 16:24] * 0.4 + rows[:, 24:32] * 0.1

    c = jnp.linspace(0.1, 0.9, 8, dtype=jnp.float32)

    def blend_T(rows):
        p = blend(rows).T
        return p[0] + p[1] * p[2]

    # name: (JAX expression on the jnp arrays, terms); the same expression
    # on the arrays' absolute values gives the scale of its rounding
    expect = {f"torch_gather_w{w}": (lambda a, w=w: jnp.sum(a[f"table{w}"][i], axis=1), w)
              for w in widths}
    expect.update({
        "torch_gather_w216_n32k": (lambda a: jnp.sum(a["table216"][i[: n // 2]], axis=1), 216),
        "torch_gather_w32_sorted": (lambda a: jnp.sum(a["table32"][i_sorted], axis=1), 32),
        "torch_gather_4x_w8": (lambda a: four(a["table8"], i), 32),
        "relayout_n8_T": (lambda a: jnp.sum(a["m8"].T * 2.0, axis=1), n),
        "relayout_n32_T": (lambda a: jnp.sum(a["m32"].T * 2.0, axis=1), n),
        "gather_blend_rowmajor": (lambda a: blend(a["table32"][i]) @ c, 32),
        "gather_blend_T": (lambda a: blend_T(a["table32"][i]), 16),
    })
    arrays = {k: jnp.asarray(v) for k, v in data.items() if k.startswith(("table", "m"))}
    absolute = {k: jnp.abs(v) for k, v in arrays.items()}
    assert set(fns) == set(expect) | {"cuda_vmem_take", "cuda_vmem_looprow"}
    for name, (f, terms) in expect.items():
        _close(fns[name]().numpy(), f(arrays), f(absolute), terms)
    for name, pallas in (("cuda_vmem_take", "pallas_gather"), ("cuda_vmem_looprow", "pallas_loop")):
        assert_rowsums(fns[name](), pallas_probe(px, pallas, data["table32"], idx),
                       data["table32"], idx)


def test_probe_pallas_gather_experiments_match_jax(px):
    n, z = 1024, 1024
    data, ops = probe_pallas_gather.experiments("cpu", n, z, probe_pallas_gather.W, BLK,
                                                np.random.default_rng(4))
    table, idx = data["table"], data["idx"]
    assert table.shape == (z, 32) and idx.max() < z - 1
    assert set(ops) == {"take1", "takeB", "dsB"}
    for name, (op, base) in ops.items():
        assert_rowsums(op(base), pallas_probe(px, name, table, idx), table, idx)


def test_probe_vmem_gather_experiments_match_jax(px):
    jnp = px.jnp
    n, z, w = 512, 256, 216
    data, ops = probe_vmem_gather.experiments("cpu", n, z, w, np.random.default_rng(5))
    table, idx, idx_sorted = data["table"], data["idx"], data["idx_sorted"]
    assert idx.max() < z - 1
    t = jnp.asarray(table)
    expect = {"torch": np.asarray(jnp.sum(t[jnp.asarray(idx)], axis=1)),
              "torch_sorted": np.asarray(jnp.sum(t[jnp.asarray(idx_sorted)], axis=1)),
              "cuda_take": pallas_probe(px, "pallas_take", table, idx),
              "cuda_taa": pallas_probe(px, "pallas_taa", table, idx)}
    assert set(ops) == set(expect) | {"cuda_ds"}
    for name, ref in expect.items():
        op, base = ops[name]
        assert_rowsums(op(base), ref, table, idx_sorted if name == "torch_sorted" else idx)
    op, base = ops["cuda_ds"]
    np.testing.assert_array_equal(op(base).numpy(), pallas_probe(px, "pallas_ds", table, idx))


@pytest.mark.parametrize("strategy", hot_kernels.ROWSUM_STRATEGIES + ("row_gather_rowloop",))
def test_no_indices_give_an_empty_result(strategy):
    table, idx = inputs(256, 32, 8, 2)
    t, i = torch.as_tensor(table), torch.as_tensor(idx[:0])
    if strategy == "row_gather_rowloop":
        assert tuple(hot_kernels.row_gather_rowloop(t, i).shape) == (0, 32)
    else:
        assert tuple(hot_kernels.gather_rowsum(t, i, strategy, blk=BLK).shape) == (0,)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_row_copy_takes_rows_up_to_one_stage(device):
    """Rows of ROW_COPY_MAX_W floats are copied; a wider table raises a
    ValueError on either device (on the card, before any launch)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    w = hot_kernels.ROW_COPY_MAX_W
    rng = np.random.default_rng(5)
    wide = torch.as_tensor(rng.standard_normal((64, w + 4)).astype(np.float32), device=device)
    table = wide[:, :w].contiguous()
    idx = torch.as_tensor(np.array([63, 0, 5, 5], np.int32), device=device)
    assert torch.equal(hot_kernels.row_gather_rowloop(table, idx), table[idx.long()])
    with pytest.raises(ValueError, match="exceeds"):
        hot_kernels.row_gather_rowloop(wide, idx)


@pytest.mark.parametrize("w, rows", [(4, 32), (8, 16), (12, 16), (32, 4), (216, 1),
                                     (2064, 1)])
def test_rowloop_step_rows_follow_the_lanes_a_row(w, rows):
    """The rowloop walk's step: 32 / G rows side by side, G lanes a row the
    largest power of two at most 32 and at most w / 4, as coop's."""
    assert hot_kernels.rowloop_step_rows(w) == rows


@pytest.mark.parametrize("w, blk, rows", [(32, 256, 16), (32, 8192, 16), (32, 100, 16),
                                           (32, 10, 10), (32, 1, 1), (216, 8192, 2),
                                           (256, 256, 2), (4, 8192, 32), (512, 8192, 1)])
def test_smem_stage_rows_caps_blk_at_one_stage(w, blk, rows):
    """blk, the JAX probe's grid block, caps the rows of one warp's
    shared-memory stage and nothing else: at w = 32 blk 256 and 8192 give
    one plan."""
    assert hot_kernels.smem_stage_rows(w, blk) == rows
    assert rows * w <= hot_kernels.SMEM_STAGE_FLOATS and rows <= hot_kernels.SMEM_STAGE_ROWS


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_smem_takes_rows_up_to_one_stage_and_a_positive_blk(device):
    """Rows of SMEM_STAGE_FLOATS floats are summed; a wider row, or a blk
    that is not a positive int, raises a ValueError on either device (on
    the card, before any launch)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    w = hot_kernels.SMEM_STAGE_FLOATS
    rng = np.random.default_rng(6)
    wide = torch.as_tensor(rng.standard_normal((64, w + 4)).astype(np.float32), device=device)
    table = wide[:, :w].contiguous()
    idx = torch.as_tensor(np.array([63, 0, 5, 5], np.int32), device=device)
    before = hot_kernels.launches["gather_rowsum_smem"]
    got = hot_kernels.gather_rowsum(table, idx, "smem", blk=8192)
    diff = (got.double() - hot_kernels.plain_rowsum(table, idx).double()).abs()
    assert bool((diff <= hot_kernels.rowsum_slack(table, idx)).all())
    with pytest.raises(ValueError, match="W = "):
        hot_kernels.gather_rowsum(wide, idx, "smem", blk=8192)
    for blk in (0, -1, 2.5, "8"):
        with pytest.raises(ValueError, match="blk"):
            hot_kernels.gather_rowsum(table, idx, "smem", blk=blk)
    assert hot_kernels.launches["gather_rowsum_smem"] == before + (device == "cuda")


@pytest.mark.parametrize("probe", [probe_gather, probe_pallas_gather, probe_vmem_gather])
def test_probe_main_exits_2_without_a_card(probe, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        probe.main()
    assert exc.value.code == 2
    out, err = capsys.readouterr()
    assert out == "" and "no CUDA device" in err


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    dev = torch.device("cuda")
    for z, w, n in [(4096, 32, 1000), (65536, 32, 65536), (4096, 216, 1000), (4096, 8, 333)]:
        table_np, idx_np = inputs(z, w, n, z + w)
        idx_np[-1] = z - 1
        table, idx = torch.as_tensor(table_np, device=dev), torch.as_tensor(idx_np, device=dev)
        ref = hot_kernels.plain_rowsum(table, idx)
        slack = hot_kernels.rowsum_slack(table, idx)
        for strategy, blk in [("coop", 256), ("persistent", 256), ("rowloop", 256),
                              ("smem", 256), ("smem", 100), ("smem", 8192)]:
            name = f"gather_rowsum_{strategy}"
            before = hot_kernels.launches[name]
            got = hot_kernels.gather_rowsum(table, idx, strategy, blk=blk)
            torch.cuda.synchronize()
            assert hot_kernels.launches[name] == before + 1
            assert bool((torch.abs(got.double() - ref.double()) <= slack).all()), (name, z, w, n)
        rows = hot_kernels.row_gather_rowloop(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(rows, table[idx.long()]), ("row_gather_rowloop", z, w, n)

    # the chained timing captures a kernel launch into a CUDA graph
    table_np, idx_np = inputs(4096, 32, 4096, 9)
    table, idx = torch.as_tensor(table_np, device=dev), torch.as_tensor(idx_np, device=dev)
    for op in (lambda i: hot_kernels.gather_rowsum(table, i, "smem", blk=512),
               lambda i: hot_kernels.row_gather_rowloop(table, i)):
        ms = chain_ms(op, idx, 4096, 2, 6, reps=2)
        assert np.isfinite(ms)


# (w, kernel): every redesigned kernel at w = 4, 32, 216 and 256, and the
# rowloop walk also at w = 8 and past 2,048 floats (a row in 9 chunks)
EDGE_CASES = [(w, k) for w in (4, 32, 216, 256)
              for k in ("gather_rowsum_coop", "row_gather_rowloop", "gather_rowsum_smem",
                        "gather_rowsum_persistent", "gather_rowsum_rowloop")]
EDGE_CASES += [(w, "gather_rowsum_rowloop") for w in (8, 2064)]


@pytest.mark.cuda
@pytest.mark.parametrize("w, kernel", EDGE_CASES, ids=[f"{w}-{k}" for w, k in EDGE_CASES])
def test_redesigned_kernels_at_their_tile_edges_on_the_card(kernel, w):
    """The redesigned kernels at the row counts their tiling makes edges
    of: none, one, a warp's batch of 32 rows +-1 and 65,537 (a ragged last
    tile), and one tile +-1 of each: a row-copy stage (coop and the row
    copy), a shared-memory stage of smem at blk 1, 100, 256 and 8192 (every
    count at every blk), a pass of the persistent kernel's grid, a step of
    the rowloop walk (P rows; P - 1, P, P + 1) and its whole wave at one
    step a warp; indices 0 and Z - 1 and repeats included.  The row copy
    bitwise, the row sums within rowsum_slack; each launch adds exactly one
    to its count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    dev, z = torch.device("cuda"), 4096
    rng = np.random.default_rng(w)
    table = torch.as_tensor(rng.standard_normal((z, w)).astype(np.float32), device=dev)

    def counts(tile):
        return sorted({0, 1, 31, 33, tile - 1, tile, tile + 1, 65537})

    if kernel == "gather_rowsum_smem":
        runs = [(n, blk) for blk in (1, 100, 256, 8192)
                for n in counts(hot_kernels.smem_stage_rows(w, blk))]
    elif kernel == "gather_rowsum_persistent":
        runs = [(n, 256) for n in counts(hot_kernels.persistent_pass_rows(w))]
    elif kernel == "gather_rowsum_rowloop":
        p = hot_kernels.rowloop_step_rows(w)
        runs = [(n, 256) for n in sorted(set(counts(hot_kernels.rowloop_wave_rows(w)))
                                         | {p - 1, p, p + 1})]
    else:  # rows of one row-copy stage
        runs = [(n, 256) for n in counts(hot_kernels.ROW_COPY_MAX_W // w)]
    for n, blk in runs:
        idx_np = rng.integers(0, z, n).astype(np.int32)
        idx_np[:6] = (z - 1, 0, z - 1, 0, 7, 7)[:n]
        idx = torch.as_tensor(idx_np, device=dev)
        before = hot_kernels.launches[kernel]
        if kernel == "row_gather_rowloop":
            got = hot_kernels.row_gather_rowloop(table, idx)
            torch.cuda.synchronize()
            assert tuple(got.shape) == (n, w)
            assert torch.equal(got, table[idx.long()]), (w, n)
        else:
            got = hot_kernels.gather_rowsum(table, idx, kernel.removeprefix("gather_rowsum_"),
                                            blk=blk)
            torch.cuda.synchronize()
            assert tuple(got.shape) == (n,)
            diff = (got.double() - hot_kernels.plain_rowsum(table, idx).double()).abs()
            assert bool((diff <= hot_kernels.rowsum_slack(table, idx)).all()), (w, n, blk)
        assert hot_kernels.launches[kernel] == before + (n > 0)
