"""The JAX package's tables and engine state, carried over into the port.

The port never imports JAX.  These functions take the JAX package's objects
as they are (``numpy.asarray`` reads a JAX array without importing JAX) and
return the port's tensors on ``device``, so the two implementations can be
run from the same state:

* :func:`from_jax_tables`: the JAX driver's ``Simulation._host``
  -> the port's per-dump table dict (``driver.build_host_tables`` layout);
* :func:`from_jax_engine_tables`: the JAX ``engine.EngineTables`` -> the
  port's (the Chebyshev coefficients and the two corner tables);
* :func:`from_jax_state`: an ``engine.State`` -> the port's ``State`` (the
  pool, the counters, the secondary ring and the spectrum; the JAX RNG key
  has no counterpart and is dropped).
"""

import numpy as np
import torch

from grmonty_tpu_torch.ops import fluid
from grmonty_tpu_torch.transport import engine


def _t(a, device, dtype=None):
    a = np.asarray(a)
    if dtype is None:
        return torch.as_tensor(a.copy(), device=device)
    return torch.as_tensor(a.copy(), device=device).to(dtype)


def from_jax_tables(host_dict, mc, nz=None, device="cpu", dtype=torch.float64):
    """The JAX driver's host table dict as the port's table dict.  ``nz``
    (the per-zone budgets, which the JAX driver keeps apart as
    ``Simulation.nz``) is taken from ``host_dict`` when it holds one."""
    h = host_dict
    fz = h["fluid_zone"]
    nz = h["nz"] if nz is None else nz
    f = lambda a: _t(a, device, dtype)  # noqa: E731
    return dict(
        prims=f(h["prims"]), f_t=f(h["f_t"]), k2_t=f(h["k2_t"]),
        zone_x=f(h["zone_x"]), g_cov_z=f(h["g_cov_z"]), g_con_z=f(h["g_con_z"]),
        g_det_z=f(h["g_det_z"]),
        fluid_zone=fluid.FluidState(
            n_e=f(fz.n_e), theta_e=f(fz.theta_e), b=f(fz.b), u_con=f(fz.u_con),
            u_cov=f(fz.u_cov), b_con=f(fz.b_con), b_cov=f(fz.b_cov)),
        weights=f(h["weights"]), nz=f(nz), dn_max=f(h["dn_max"]),
        e_con_z=f(h["e_con_z"]), e_cov_z=f(h["e_cov_z"]), derived11=f(h["derived11"]),
        nu_zone_map=_t(h["nu_zone_map"], device, torch.int64),
        nu_lnrho=_t(h["nu_lnrho"], device, torch.float32),
        nu_cdf=_t(h["nu_cdf"], device, torch.float32),
    )


def from_jax_engine_tables(tabs, dtype=torch.float64, device="cpu"):
    """The JAX engine's device tables as the port's ``EngineTables``."""
    return engine.EngineTables(
        hc_coeffs=_t(tabs.hc_coeffs, device, dtype),
        k2_coeffs=np.asarray(tabs.k2_coeffs, np.float64),
        corner_rows=_t(tabs.corner_rows, device, dtype),
        hot_tab=_t(tabs.hot_tab, device, dtype).contiguous())


_POOL_4 = ("x", "k", "dkdlam", "ev_x", "ev_k")
_POOL_INT = ("n_scatt", "nsc0", "n_step", "ev_tries")
_POOL_BOOL = ("ev_pending", "occupied", "alive", "interacting", "pend_push",
              "at_event", "record_pending")


def from_jax_pool(p, dtype, device="cpu"):
    """A JAX ``Pool`` (detached-events layout) as the port's ``Pool``."""
    out = {}
    for name in engine.Pool._fields:
        v = getattr(p, name)
        if name in _POOL_4:
            out[name] = tuple(_t(c, device, dtype) for c in v)
        elif name in _POOL_INT:
            out[name] = _t(v, device, torch.int32)
        elif name in _POOL_BOOL:
            out[name] = _t(v, device, torch.bool)
        else:
            out[name] = _t(v, device, dtype)
    return engine.Pool(**out)


def from_jax_counters(c, dtype, device="cpu"):
    """JAX ``Counters`` as the port's (the trace-birth fields are dropped)."""
    float_fields = ("max_tau_scatt", "avg_ema", "w_stall")
    return engine.Counters(**{
        name: _t(getattr(c, name), device, dtype if name in float_fields else torch.int64)
        for name in engine.Counters._fields})


def from_jax_state(state, dtype=torch.float64, device="cpu"):
    """A JAX ``engine.State`` as the port's ``State``."""
    return engine.State(
        pool=from_jax_pool(state.pool, dtype, device),
        spec=_t(state.spec, device, dtype),
        counters=from_jax_counters(state.counters, dtype, device),
        sec=engine.SecBuf(rows=_t(state.sec.rows, device, dtype),
                          count=_t(state.sec.count, device, torch.int64)),
        backlog_pos=_t(state.backlog_pos, device, torch.int64),
        it=int(np.asarray(state.it)),
    )
