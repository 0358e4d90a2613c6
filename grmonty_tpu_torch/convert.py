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
  pool, the counters, the secondary ring and the spectrum, the birth-state
  trace's fields included; the JAX RNG key has no counterpart and is
  dropped);
* :func:`from_jax_config`: an ``engine.EngineConfig`` at the shipped
  profile's physics or at reference semantics -> the port's.
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
_POOL_BIRTH = ("bx", "bk", "bw")
_POOL_INT = ("n_scatt", "nsc0", "n_step", "ev_tries")
_POOL_BOOL = ("ev_pending", "occupied", "alive", "interacting", "pend_push",
              "at_event", "record_pending")


def from_jax_pool(p, dtype, device="cpu"):
    """A JAX ``Pool`` as the port's ``Pool``.  Without detached events the
    JAX pool's shadow registers are empty; the port's are then zeros and
    ``ev_pending`` False.  The birth-state fields are carried as they are:
    with the trace off (JAX ``()`` and a (0,) ``bw``) each is the port's
    ``()``."""
    out = {}
    n = np.asarray(p.w).shape[0]
    for name in engine.Pool._fields:
        v = getattr(p, name)
        if name in _POOL_BIRTH:
            if name == "bw":
                out[name] = _t(v, device, dtype) if np.asarray(v).size else ()
            else:
                out[name] = tuple(_t(c, device, dtype) for c in v)
            continue
        if name in _POOL_4 and len(v) == 0:
            v = tuple(np.zeros(n) for _ in range(4))
        elif name in ("ev_w", "ev_pending") and np.asarray(v).size == 0:
            v = np.zeros(n, bool if name == "ev_pending" else np.float64)
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
    """JAX ``Counters`` as the port's, the birth-state capture (``mt_*``)
    included."""
    float_fields = ("max_tau_scatt", "avg_ema", "w_stall", "mt_bx", "mt_bk", "mt_bw")
    return engine.Counters(**{
        name: _t(getattr(c, name), device, dtype if name in float_fields else torch.int64)
        for name in engine.Counters._fields})


_SHIPPED = dict(fp_iters=engine.FP_ITERS, step_ctrl=engine.STEP_CTRL,
                grow_tau_cap=engine.GROW_TAU_CAP, bias_ema=engine.BIAS_EMA,
                detached_events=True, derived_fluid=True)
_REFERENCE = dict(fp_iters=engine.FP_ITERS, step_ctrl=0.0, grow_rate=2.0, grow_cap=1.0,
                  bias_ema=0.0, detached_events=False, derived_fluid=False)


def from_jax_config(cfg):
    """A JAX ``EngineConfig`` as the port's: its widths, and
    ``reference=True`` where its physics knobs hold reference semantics
    (the JAX defaults).  Raises where they hold neither that nor the
    shipped profile's physics, which the port has no switch for."""
    def holds(values):
        return all(getattr(cfg, k) == v for k, v in values.items())

    if holds(_REFERENCE):
        reference = True
    elif holds(_SHIPPED):
        reference = False
    else:
        raise ValueError("the port runs the shipped profile's physics or reference "
                         "semantics; this JAX EngineConfig holds neither")
    dtype = {np.dtype(np.float64): torch.float64,
             np.dtype(np.float32): torch.float32}[np.dtype(cfg.dtype)]
    return engine.EngineConfig(
        n_pool=cfg.n_pool, m_period=cfg.m_period, sec_cap=cfg.sec_cap,
        tail_exit=cfg.tail_exit, stall_steps=cfg.stall_steps, ev_k=cfg.ev_k,
        refill_k=cfg.refill_k, light_k=cfg.light_k, refill_period=cfg.refill_period,
        grow_cap=cfg.grow_cap, dtype=dtype, reference=reference,
        trace_birth=cfg.trace_birth)


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
