"""The hotcross sum of the float hot step split over a lane's group of G
threads (``csrc/physics.cuh``), modelled in torch on the CPU.

The fused hot step sums the (41, 31) Chebyshev surface in each variant's own
order, one thread a lane or G threads a lane:

- reference semantics, the plain order (``hotcross<true>``): u_j = sum_ix
  T_ix(tx) c[ix, j] as one fused multiply-add chain in ix order, then
  sum_j u_j T_j(ty) in j order; split by ``hotcross_cols<G>``: thread
  ``sub`` takes the 32 / G staged columns (31 and a zero pad) from
  sub * 32 / G, and every thread gathers u_0 ... u_30 from their threads in
  j order;
- the shipped profile, the row form (``hotcross<false>``): s_ix = sum_j
  c[ix, j] T_j(ty) in j order, then sum_ix T_ix(tx) s_ix in ix order;
  split by ``hotcross_rows<G>``: thread ``sub`` takes the rows sub,
  sub + G, ... (41 rows do not divide evenly: the first 41 % G threads one
  more; a thread past the last row reads it again and its product goes
  unused), and every thread adds the 41 products in ix order, each from its
  thread.

Each model does the kernel's float operations one by one in the type (the
products and sums rounded on their own, as ``-fmad=false`` builds them; the
fused multiply-add stands in as the product exact in float64 and one
rounding there, then to float32, or as a float64 product and sum), so that
for every G in 1, 2, 4, 8, in float32 and float64, the split must equal its
variant's serial order bit for bit on seeded (w, theta_e) over the table's
domain, beyond its clamps and at the cold and Thomson seams.  Each serial
order is held against the JAX package's ``grmonty_tpu/ops/cheb.py``
``hotcross_eval`` on the same inputs: float64 within rtol 1e-12; float32
(JAX with x64 off) within ``test_pallas_hot``'s rtol 1e-4 and atol 1e-6,
on sigma in units of the Thomson cross section.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grmonty_tpu.ops import cheb as jcheb
from grmonty_tpu_torch import consts
from grmonty_tpu_torch.ops import hotcross as hc_mod
from grmonty_tpu_torch.utils import cache, tables

NX, NY, PITCH = 41, 31, 32
GROUPS = (1, 2, 4, 8)
DTYPES = {"f32": torch.float32, "f64": torch.float64}
N = 2048


@pytest.fixture(scope="module")
def surface():
    """The fitted (41, 31) hotcross surface (float64) and seeded (w, theta_e)."""
    c = tables.fit_hotcross(cache.hotcross_table())
    rng = np.random.default_rng(2020)
    w = 10.0 ** rng.uniform(tables.HC_XLO - 2.0, tables.HC_XHI + 2.0, N)
    te = 10.0 ** rng.uniform(tables.HC_YLO - 1.0, tables.HC_YHI + 1.0, N)
    # the table's corners and the seams: the cold limit below theta_e 1e-4,
    # Thomson at w theta_e < 1e-6, the clamps' edges
    edge_w = [1e-12, 1e6, 1e-12, 1e6, 1e-3, 2e-6, 1e-6 / 0.5, 1e-30, 1e9, 0.3]
    edge_t = [1e-4, 1e4, 1e4, 1e-4, 0.5, 0.5, 0.5, 1.0, 1e-5, 1e-4 * (1 - 1e-6)]
    w[:len(edge_w)], te[:len(edge_t)] = edge_w, edge_t
    return c, w, te


def _cheb(t, n):
    """T_0 ... T_{n-1}(t) by the kernel's recurrence, (2 t) T_{k-1} - T_{k-2}."""
    ts = [torch.ones_like(t), t]
    for _ in range(n - 2):
        ts.append(2.0 * t * ts[-1] - ts[-2])
    return ts[:n]


def _fma(a, b, c):
    """The model's fused multiply-add: float32 operands' product is exact in
    float64, summed there and rounded to float32; float64 as a product and a
    sum."""
    if a.dtype == torch.float32:
        return (a.double() * b.double() + c.double()).float()
    return a * b + c


def _args(w, te, dt):
    """(tx, ty): the clamped log10 coordinates on [-1, 1], in ``dt``."""
    w, te = torch.as_tensor(w, dtype=dt), torch.as_tensor(te, dtype=dt)
    l_w = torch.clamp(torch.log10(torch.clamp(w, min=1e-30)), tables.HC_XLO, tables.HC_XHI)
    l_t = torch.clamp(torch.log10(torch.clamp(te, min=1e-30)), tables.HC_YLO, tables.HC_YHI)
    tx = (2.0 * l_w - (tables.HC_XHI + tables.HC_XLO)) / (tables.HC_XHI - tables.HC_XLO)
    ty = (2.0 * l_t - (tables.HC_YHI + tables.HC_YLO)) / (tables.HC_YHI - tables.HC_YLO)
    return tx, ty


def _staged(c, dt):
    """The staged surface: 41 rows of 32 values (31, then a zero pad)."""
    cs = torch.zeros((NX, PITCH), dtype=dt)
    cs[:, :NY] = torch.as_tensor(c, dtype=dt)
    return cs


def plain_order(cs, tx, ty):
    """hotcross<true>'s sum: u_j in ix order by fused multiply-adds, then j."""
    ts, by = _cheb(tx, NX), _cheb(ty, NY)
    u = [torch.zeros_like(tx) for _ in range(NY)]
    for ix in range(NX):
        for j in range(NY):
            u[j] = _fma(ts[ix], cs[ix, j], u[j])
    acc = torch.zeros_like(tx)
    for j in range(NY):
        acc = acc + u[j] * by[j]
    return acc


def row_form(cs, tx, ty):
    """hotcross<false>'s sum: each row's s_ix in j order, then T_ix s_ix in ix."""
    ts, by = _cheb(tx, NX), _cheb(ty, NY)
    acc = torch.zeros_like(tx)
    for ix in range(NX):
        s = torch.zeros_like(tx)
        for j in range(NY):
            s = s + cs[ix, j] * by[j]
        acc = acc + ts[ix] * s
    return acc


def cols_split(cs, tx, ty, g):
    """hotcross_cols<G>: thread ``sub``'s columns sub * 32 / G + q, then
    every thread gathers u_j from thread j // (32 / G), register j % (32 /
    G), in j order."""
    cols = PITCH // g
    ts, by = _cheb(tx, NX), _cheb(ty, NY)
    u = [[torch.zeros_like(tx) for _ in range(cols)] for _ in range(g)]
    for sub in range(g):
        for ix in range(NX):
            for q in range(cols):
                u[sub][q] = _fma(ts[ix], cs[ix, sub * cols + q], u[sub][q])
    acc = torch.zeros_like(tx)
    for j in range(NY):
        acc = acc + u[j // cols][j % cols] * by[j]
    return acc


def row_deal(g):
    """hotcross_rows<G>'s deal: (sub, r) -> the row it reads (clamped past
    the last) and whether the row is its own."""
    rows = -(-NX // g)
    return {(sub, r): (min(sub + r * g, NX - 1), sub + r * g < NX)
            for sub in range(g) for r in range(rows)}


def rows_split(cs, tx, ty, g):
    """hotcross_rows<G>: thread ``sub``'s products T_ix s_ix of its rows,
    then every thread adds product ix from thread ix % G, register ix // G,
    in ix order."""
    ts, by = _cheb(tx, NX), _cheb(ty, NY)
    p = {}
    for (sub, r), (ix, own) in row_deal(g).items():
        s = torch.zeros_like(tx)
        for j in range(NY):
            s = s + cs[ix, j] * by[j]
        p[sub, r] = (ts[ix] if own else torch.zeros_like(tx)) * s
    acc = torch.zeros_like(tx)
    for ix in range(NX):
        acc = acc + p[ix % g, ix // g]
    return acc


SERIAL = {"cols": plain_order, "rows": row_form}
SPLIT = {"cols": cols_split, "rows": rows_split}


def sigma(acc, w, te):
    """sigma_hot [cm^2] from the sum, as the kernel finishes it."""
    dt = acc.dtype
    w, te = torch.as_tensor(w, dtype=dt), torch.as_tensor(te, dtype=dt)
    interp = torch.exp(acc * 2.302585092994046)
    cold = hc_mod._hc_klein_nishina(w) * consts.SIGMA_THOMSON
    out = torch.where(te < 1.0e-4, cold, interp)
    return torch.where(w * te < 1.0e-6, torch.full_like(out, consts.SIGMA_THOMSON), out)


@pytest.fixture(scope="module")
def serial(surface):
    """Each variant's serial sum in each dtype: {(split, dtype name): acc}."""
    c, w, te = surface
    out = {}
    for dname, dt in DTYPES.items():
        cs, (tx, ty) = _staged(c, dt), _args(w, te, dt)
        for split, fn in SERIAL.items():
            out[split, dname] = fn(cs, tx, ty)
    return out


def test_row_deal_takes_every_row_once():
    """The uneven deal of 41 rows: every row is one thread's own exactly
    once, the first 41 % G threads hold one more, the reads stay inside."""
    for g in GROUPS:
        own = [ix for (ix, mine) in row_deal(g).values() if mine]
        assert sorted(own) == list(range(NX)), g
        per = [sum(mine for (s, _), (_, mine) in row_deal(g).items() if s == sub)
               for sub in range(g)]
        assert per == [NX // g + (sub < NX % g) for sub in range(g)], (g, per)
        assert all(0 <= ix < NX for ix, _ in row_deal(g).values())


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("split", ("cols", "rows"))
@pytest.mark.parametrize("dname", DTYPES)
def test_group_split_is_the_serial_order(surface, serial, dname, split, g):
    """The split over G threads gives its variant's serial sum bit for bit."""
    c, w, te = surface
    dt = DTYPES[dname]
    tx, ty = _args(w, te, dt)
    got = SPLIT[split](_staged(c, dt), tx, ty, g)
    want = serial[split, dname]
    assert got.dtype == dt
    differ = (got.view(torch.int32 if dt == torch.float32 else torch.int64)
              != want.view(torch.int32 if dt == torch.float32 else torch.int64))
    assert not bool(differ.any()), (f"{split} over {g} threads, {dname}: "
                                    f"{int(differ.sum())} lanes differ")


@pytest.mark.parametrize("split", ("cols", "rows"))
@pytest.mark.parametrize("dname", DTYPES)
def test_serial_order_matches_jax(surface, serial, dname, split):
    """Each variant's serial order, finished as the kernel finishes it,
    against JAX's ``hotcross_eval`` on the same inputs."""
    c, w, te = surface
    dt = DTYPES[dname]
    got = sigma(serial[split, dname], w, te).double().numpy()
    npdt = np.float32 if dt == torch.float32 else np.float64
    with jax.enable_x64(dt == torch.float64):
        ref = np.asarray(jcheb.hotcross_eval(jnp.asarray(w.astype(npdt)),
                                             jnp.asarray(te.astype(npdt)),
                                             jnp.asarray(c.astype(npdt)))).astype(np.float64)
    assert np.isfinite(got).all()
    if dt == torch.float64:
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0.0)
    else:
        np.testing.assert_allclose(got / consts.SIGMA_THOMSON, ref / consts.SIGMA_THOMSON,
                                   rtol=1e-4, atol=1e-6)
    # the surface, not only its clamps and seams, was reached
    assert (np.abs(np.log(got / consts.SIGMA_THOMSON)) > 1e-3).sum() > N // 4
    assert math.isfinite(float(got.sum()))
