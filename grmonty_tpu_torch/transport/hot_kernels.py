"""The two hand-written CUDA kernels of the hot step, and their dispatch.

``csrc/hot_step.cu`` holds two kernels for Hopper (sm_90a):

* kernel A replaces the TPU kernel ``grmonty_tpu/transport/hotstep_pallas.py:104``
  (``kernel_a``, body ``engine.hot_phase_a``): the geodesic push, step
  control, stop test and cell index;
* kernel B replaces ``hotstep_pallas.py:152`` (``kernel_b``, body
  ``engine.hot_phase_b``) in its derived-fluid form, with the corner-row
  gather done inside the kernel.

Each thread runs one lane; the header of the ``.cu`` file says what bounds
each kernel on the card.

:func:`phase_a` and :func:`phase_b` take the plain versions' arguments.  On
CPU tensors they call the plain versions (``engine.hot_phase_a`` /
``engine.hot_phase_b``); on CUDA tensors they launch the kernel, or raise.
``launches`` counts kernel launches only.

Build: ``nvcc`` compiles ``csrc/*.cu`` into a shared library with a plain C
interface under ``build/grmonty_tpu_torch/`` (keyed by a hash of the
sources, built at first use) and ``ctypes`` loads it.
"""

import ctypes
import glob
import hashlib
import math
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.ops import geometry
from grmonty_tpu_torch.transport import engine
from grmonty_tpu_torch.utils import tables as tables_mod

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "grmonty_tpu_torch")
# No --use_fast_math (it folds the isfinite tests of the commit gate and the
# step controller); -fmad=false keeps each multiply and add rounded on its
# own, as the plain versions' separate tensor ops round them.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches on CUDA tensors, per kernel (the plain path counts nothing).
launches = {"hot_phase_a": 0, "hot_phase_b": 0}


def reset_launches():
    for name in launches:
        launches[name] = 0


# Pointer and scalar orders of the C structs APtrs/AScal/BPtrs/BScal.
_A_PTRS = ("x0 x1 x2 x3 k0 k1 k2 k3 d0 d1 d2 d3 e_0_s dl_shrink pend_dl "
           "pend_push at_event alive w record_pending u_roul alpha_scatti bi "
           "ox0 ox1 ox2 ox3 ok0 ok1 ok2 ok3 od0 od1 od2 od3 oe_0_s odl_shrink "
           "opend_dl opend_push oat_event oalive ow orecord_pending oseg ocommit "
           "omoving owas_pend oarrived ostopped oz ogrown").split()
_A_SCAL = ("a h_slope r_0 x_start1 x_start2 x_stop2 dx1 dx2 n1 n2 x1_min d_tau_k "
           "fp_iters weight_min shrink_floor grow_cap grow_tau_cap step_ctrl "
           "inv_dx1 inv_dx2 inv_e_tol inv_e_drift_tol").split()
_B_PTRS = ("rows z hc bias_scale x0 x1 x2 x3 k0 k1 k2 k3 d0 d1 d2 d3 e_0_s w "
           "alpha_scatti alpha_absi bi tau_abs tau_scatt interacting pend_dl "
           "pend_push sec_w n_step alive px0 px1 px2 px3 pk0 pk1 pk2 pk3 pd0 pd1 "
           "pd2 pd3 pe0s seg commit moving was_pend stopped u_x1 grown "
           "otau_over oentry_roll ox0 ox1 ox2 ox3 ok0 ok1 ok2 ok3 od0 od1 od2 od3 "
           "oe_0_s opend_dl osec_w opend_push ow otau_abs otau_scatt "
           "oalpha_scatti oalpha_absi obi ointeracting oalive on_step oa_scf "
           "oa_abf obf onu on_e ohc_clamp").split()
_B_SCAL_HEAD = ("x_start1 x_start2 x_stop1 x_stop2 dx1 dx2 n1 n2 b_unit d_tau_k "
                "weight_min stall_steps tau_cap hc_xlo hc_xhi hc_ylo "
                "hc_yhi k2_lo k2_hi inv_dx1 inv_dx2 inv_b_unit inv_hpl inv_mecc "
                "inv_hc_xdiff inv_hc_ydiff inv_k2_diff inv_cl inv_24 inv_2pimecl "
                "inv_weight_min inv_tp_over_te").split()
_K2_N = 25


class _Build:
    """The loaded library and how it was built (one per process)."""

    lib = None
    path = None
    seconds = 0.0
    log = ""


def build():
    """Compile ``csrc/*.cu`` if the hashed library is missing, load it, and
    return (library path, build seconds, nvcc/ptxas output)."""
    if _Build.lib is not None:
        return _Build.path, _Build.seconds, _Build.log
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR, f"hot_step_{h.hexdigest()[:16]}.so")
    t0 = time.monotonic()
    if not os.path.exists(path):
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
        _Build.log = proc.stdout + proc.stderr
    _Build.seconds = time.monotonic() - t0
    lib = ctypes.CDLL(path)
    for name in ("hot_phase_a", "hot_phase_b"):
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_double),
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for what in ("nptrs", "nscal"):
            getattr(lib, f"{name}_{what}").restype = ctypes.c_int
    expect = {"hot_phase_a": (len(_A_PTRS), len(_A_SCAL)),
              "hot_phase_b": (len(_B_PTRS), len(_B_SCAL_HEAD) + _K2_N)}
    for name, (np_, ns) in expect.items():
        got = (getattr(lib, f"{name}_nptrs")(), getattr(lib, f"{name}_nscal")())
        if got != (np_, ns):
            raise RuntimeError(f"{name}: library takes {got} pointers/scalars, "
                               f"the wrapper passes {(np_, ns)}")
    _Build.lib, _Build.path = lib, path
    return _Build.path, _Build.seconds, _Build.log


def _check(names, tensors, n, device):
    for name, t in zip(names, tensors):
        if t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")
        if t.dtype not in (torch.float32, torch.bool, torch.int32):
            raise TypeError(f"{name}: dtype {t.dtype} (the kernels take float32, bool, int32)")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous ({n},) tensor, got "
                             f"{tuple(t.shape)} stride {t.stride()}")


def _launch(name, ptr_tensors, scal, n, device):
    build()
    ptrs = (ctypes.c_void_p * len(ptr_tensors))(*[t.data_ptr() for t in ptr_tensors])
    sc = (ctypes.c_double * len(scal))(*[float(v) for v in scal])
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(_Build.lib, f"{name}_launch")(ptrs, sc, n, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    launches[name] += 1


_RECIP = {}


def _recip(c, device):
    """The float32 multiplier PyTorch uses for ``tensor / c`` on ``device``:
    on the card it divides a float32 tensor by a Python scalar as a multiply
    by the scalar's reciprocal.  Read from PyTorch itself, once per value,
    so the kernels round each such division exactly as the plain versions."""
    key = (float(c), str(device))
    if key not in _RECIP:
        one = torch.ones((), dtype=torch.float32, device=device)
        _RECIP[key] = float((one / float(c)).item())
    return _RECIP[key]


def _cuda_device(t):
    if t.device.type != "cuda":
        raise ValueError(f"hot-step kernels need CPU or CUDA tensors, got {t.device}")
    return t.device


def phase_a(x, k, dkdlam, e_0_s, dl_shrink, pend_dl, pend_push, at_event,
            alive, w, record_pending, u_roul, alpha_scatti, bi, mc, grow_cap):
    """Phase A of the hot step: the plain version on CPU tensors, kernel A
    on CUDA tensors.  Arguments and result as ``engine.hot_phase_a``."""
    if w.device.type == "cpu":
        return engine.hot_phase_a(
            x, k, dkdlam, e_0_s, dl_shrink, pend_dl, pend_push, at_event, alive, w,
            record_pending, u_roul, alpha_scatti, bi, mc, grow_cap)
    dev = _cuda_device(w)
    n = w.shape[0]
    ins = [*x, *k, *dkdlam, e_0_s, dl_shrink, pend_dl, pend_push, at_event, alive, w,
           record_pending, u_roul, alpha_scatti, bi]
    _check(_A_PTRS[:len(ins)], ins, n, dev)

    def f():
        return torch.empty(n, dtype=torch.float32, device=dev)

    def b():
        return torch.empty(n, dtype=torch.bool, device=dev)

    xo, ko, do = (f(), f(), f(), f()), (f(), f(), f(), f()), (f(), f(), f(), f())
    out = dict(e_0_s=f(), dl_shrink=f(), pend_dl=f(), pend_push=b(), at_event=b(),
               alive=b(), w=f(), record_pending=b(), seg=f(), commit=b(), moving=b(),
               was_pend=b(), arrived=b(), stopped=b(),
               z=torch.empty(n, dtype=torch.int32, device=dev), grown=b())
    outs = [*xo, *ko, *do] + list(out.values())
    scal = [mc.a, mc.h_slope, mc.r_0, mc.x_start[1], mc.x_start[2], mc.x_stop[2],
            mc.dx[1], mc.dx[2], mc.n1, mc.n2, mc.x1_min, mc.d_tau_k, engine.FP_ITERS,
            engine.WEIGHT_MIN, engine.SHRINK_FLOOR, grow_cap, engine.GROW_TAU_CAP,
            engine.STEP_CTRL]
    scal += [_recip(c, dev) for c in (mc.dx[1], mc.dx[2], consts.E_TOL, consts.E_DRIFT_TOL)]
    _launch("hot_phase_a", ins + outs, scal, n, dev)
    out.update(x=xo, k=ko, dkdlam=do)
    return out


def phase_b(tab, z, x, k, dkdlam, e_0_s, w, alpha_scatti, alpha_absi, bi,
            tau_abs, tau_scatt, interacting, pend_dl, pend_push, sec_w,
            n_step, alive, x_pre, k_pre, dk_pre, e0s_pre,
            seg, commit, moving, was_pend, stopped, u_x1, grown, bias_scale,
            mc, hc_coeffs, k2_coeffs, stall_steps):
    """Phase B of the hot step on the derived corner table ``tab`` (Z, 44)
    at cells ``z``: the plain version (``engine.hot_phase_b`` on
    ``tab[z]``) on CPU tensors, kernel B (gathering the rows itself) on
    CUDA tensors.  Result as ``engine.hot_phase_b``."""
    if w.device.type == "cpu":
        return engine.hot_phase_b(
            tab[z.to(torch.int64)], x, k, dkdlam, e_0_s, w, alpha_scatti, alpha_absi,
            bi, tau_abs, tau_scatt, interacting, pend_dl, pend_push, sec_w, n_step,
            alive, x_pre, k_pre, dk_pre, e0s_pre, seg, commit, moving, was_pend,
            stopped, u_x1, grown, bias_scale, mc, hc_coeffs, k2_coeffs, stall_steps)
    dev = _cuda_device(w)
    n = w.shape[0]
    if (tab.dtype != torch.float32 or tab.dim() != 2 or tab.shape[1] != 44
            or not tab.is_contiguous() or tab.device != dev or tab.data_ptr() % 16):
        raise ValueError("derived table: expected a contiguous, 16-byte aligned "
                         f"float32 (Z, 44) tensor on {dev}")
    if (hc_coeffs.dtype != torch.float32 or tuple(hc_coeffs.shape) != (41, 31)
            or not hc_coeffs.is_contiguous() or hc_coeffs.device != dev):
        raise ValueError(f"hotcross coefficients: expected float32 (41, 31) on {dev}")
    if (bias_scale.dtype != torch.float32 or bias_scale.numel() != 1
            or bias_scale.device != dev):
        raise ValueError(f"bias_scale: expected a float32 scalar tensor on {dev}")
    if len(k2_coeffs) != _K2_N:
        raise ValueError(f"k2 coefficients: expected {_K2_N}, got {len(k2_coeffs)}")
    lanes = [z, *x, *k, *dkdlam, e_0_s, w, alpha_scatti, alpha_absi, bi, tau_abs,
             tau_scatt, interacting, pend_dl, pend_push, sec_w, n_step, alive,
             *x_pre, *k_pre, *dk_pre, e0s_pre, seg, commit, moving, was_pend, stopped,
             u_x1, grown]
    _check(["z"] + _B_PTRS[4:4 + len(lanes) - 1], lanes, n, dev)

    def f():
        return torch.empty(n, dtype=torch.float32, device=dev)

    def b():
        return torch.empty(n, dtype=torch.bool, device=dev)

    xo, ko, do = (f(), f(), f(), f()), (f(), f(), f(), f()), (f(), f(), f(), f())
    head = dict(tau_over=b(), entry_roll=b())
    tail = dict(e_0_s=f(), pend_dl=f(), sec_w=f(), pend_push=b(), w=f(), tau_abs=f(),
                tau_scatt=f(), alpha_scatti=f(), alpha_absi=f(), bi=f(),
                interacting=b(), alive=b(),
                n_step=torch.empty(n, dtype=torch.int32, device=dev),
                a_scf=f(), a_abf=f(), bf=f(), nu=f(), n_e=f(), hc_clamp=b())
    ptrs = ([tab, z, hc_coeffs, bias_scale] + lanes[1:] + list(head.values())
            + [*xo, *ko, *do] + list(tail.values()))
    scal = [mc.x_start[1], mc.x_start[2], mc.x_stop[1], mc.x_stop[2], mc.dx[1],
            mc.dx[2], mc.n1, mc.n2, mc.b_unit, mc.d_tau_k, engine.WEIGHT_MIN, stall_steps,
            engine.GROW_TAU_CAP, tables_mod.HC_XLO, tables_mod.HC_XHI,
            tables_mod.HC_YLO, tables_mod.HC_YHI, tables_mod.K2_LO, tables_mod.K2_HI]
    scal += [_recip(c, dev) for c in (
        mc.dx[1], mc.dx[2], mc.b_unit, consts.HPL, consts.ME * consts.CL * consts.CL,
        tables_mod.HC_XHI - tables_mod.HC_XLO, tables_mod.HC_YHI - tables_mod.HC_YLO,
        tables_mod.K2_HI - tables_mod.K2_LO, consts.CL, 24.0,
        2.0 * math.pi * consts.ME * consts.CL, engine.WEIGHT_MIN, consts.TP_OVER_TE)]
    scal += list(np.asarray(k2_coeffs, np.float64))
    _launch("hot_phase_b", ptrs, scal, n, dev)
    return dict(**head, x=xo, k=ko, dkdlam=do, **tail)


# ---------------------------------------------------------------------------
# checks: synthetic lane states and the comparison contract
# ---------------------------------------------------------------------------

def synthetic_lanes(mc, n, seed, stall_steps):
    """Random per-lane hot-step inputs, float64 numpy, from ``seed``.

    Positions span the grid, the vacuum beyond it, the horizon and the
    escape radius; momenta get a consistent dk/dlambda and conserved
    energy, so most pushes commit.  Step factors, pend pushes, parked
    lanes, small weights with forced roulette wins, zero-opacity lanes
    (grown entry roll), large opacities (tau_over, absorption), scatter
    draws and step counts at the cap reach every branch of both phases.
    Returns a dict of (n,) arrays (4-vectors as 4-tuples) and the scalar
    ``bias_scale``."""
    weight_min = engine.WEIGHT_MIN
    rng = np.random.default_rng(seed)
    u = rng.random
    kind = u(n)
    x1 = rng.uniform(mc.x_start[1] + 0.02, mc.x_stop[1] + 0.6, n)
    x1 = np.where(kind < 0.05, rng.uniform(mc.x_start[1] - 0.02, mc.x1_min + 0.01, n), x1)
    x1 = np.where((kind >= 0.05) & (kind < 0.1),
                  rng.uniform(consts.X1_MAX - 0.02, consts.X1_MAX + 0.05, n), x1)
    x2 = rng.uniform(0.02, 0.98, n)
    x = (rng.uniform(0.0, 100.0, n), x1, x2, rng.uniform(0.0, 2.0 * np.pi, n))
    r = np.exp(x1)
    e = 10.0 ** rng.uniform(-9.0, -3.0, n)
    c = rng.uniform(-1.0, 1.0, (3, n))
    k = (e * (1.0 + 0.5 * u(n)), e * c[0] / r, e * c[1] / (np.pi * r), e * c[2] / r)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    conn = geometry.connection_c(t(x1), t(x2), mc.a, mc.h_slope)
    dk = tuple(v.numpy() for v in geometry.geodesic_rhs_c(conn, *map(t, k)))
    g00, g01, g03 = (v.numpy() for v in geometry.gcov_row0_c(
        t(x1), t(x2), mc.a, mc.h_slope, mc.r_0))
    e_0_s = -(k[0] * g00 + k[1] * g01 + k[3] * g03)

    floor = 2.0 ** (-consts.MAX_HALVING_DEPTH)
    dl_shrink = np.where(u(n) < 0.05, floor, 2.0 ** rng.uniform(-7.0, 3.0, n))
    pend_push = u(n) < 0.2
    dl_nom = geometry.step_size_c(t(x1), t(x2), t(k[1]), t(k[2]), t(k[3]),
                                  mc.x_stop[2]).numpy()
    pend_dl = np.where(pend_push, dl_nom * rng.uniform(0.1, 1.5, n), 0.0)
    vacuum = u(n) < 0.15
    alpha_scatti = np.where(vacuum, 0.0, 10.0 ** rng.uniform(-12.0, 2.0, n))
    alpha_absi = np.where(vacuum, 0.0, 10.0 ** rng.uniform(-12.0, 4.0, n))
    u_roul = np.where(u(n) < 0.02, 0.5e-4 * u(n), u(n))
    u_x1 = np.where(u(n) < 0.1, 1.0 - 1e-6 * u(n), u(n))
    n_step = np.where(u(n) < 0.05, stall_steps, rng.integers(0, stall_steps, n))
    return dict(
        x=x, k=k, dkdlam=dk, e_0_s=e_0_s, dl_shrink=dl_shrink,
        pend_dl=pend_dl, pend_push=pend_push, at_event=u(n) < 0.1,
        alive=u(n) < 0.93, w=weight_min * 10.0 ** rng.uniform(-1.0, 6.0, n),
        record_pending=u(n) < 0.05, u_roul=u_roul,
        alpha_scatti=alpha_scatti, alpha_absi=alpha_absi,
        bi=10.0 ** rng.uniform(0.0, 6.0, n), tau_abs=u(n), tau_scatt=u(n),
        interacting=u(n) < 0.5, sec_w=weight_min * 10.0 ** rng.uniform(0.0, 4.0, n),
        n_step=n_step.astype(np.int32), u_x1=u_x1,
        bias_scale=100.0 / (mc.bias_norm * mc.max_tau_scatt0 * 2.0),
    )


def _flat(out):
    """{name: tensor}, 4-tuples split into name0..name3."""
    flat = {}
    for name, v in out.items():
        if isinstance(v, tuple):
            flat.update({f"{name}{i}": c for i, c in enumerate(v)})
        else:
            flat[name] = v
    return flat


# What each kernel is held to against its plain version on the same inputs,
# on every lane.  Kernel A mirrors its plain version operation by operation
# (-fmad=false, the reciprocals of _recip), so it must equal it exactly.
# Kernel B sums the hotcross Chebyshev surface in another order than the
# plain version's matmul, so it is held to the Pallas-vs-XLA parity
# contract of tests/test_pallas_hot.py.
KERNEL_TOLERANCE = {
    "hot_phase_a": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
    "hot_phase_b": dict(rtol=1e-4, atol=1e-6, mask_frac=1e-3),
}


def compare(ref, got, rtol, atol, mask_frac):
    """Hold a phase's outputs ``got`` against ``ref`` (dicts as the phases
    return them) on every lane: each mask and integer field differs on at
    most ``mask_frac`` of the lanes, and each float field agrees to
    ``rtol``/``atol`` (NaN only where ``ref`` is NaN).  Returns
    (max_abs_err, max_rel_err, worst mask mismatch fraction, failures);
    the relative error is taken against max(|ref|, atol/rtol), or |ref|
    when rtol is 0."""
    ref, got = _flat(ref), _flat(got)
    worst = max_err = max_rel = 0.0
    fails = []
    for name, a in ref.items():
        b = got[name].to(a.device)
        if not a.dtype.is_floating_point:
            frac = float((a != b).double().mean())
            worst = max(worst, frac)
            if frac > mask_frac:
                fails.append(f"{name}: {frac:.2e} of lanes differ")
            continue
        a64, b64 = a.double(), b.double()
        both_nan = torch.isnan(a64) & torch.isnan(b64)
        diff = torch.nan_to_num(torch.where(both_nan, 0.0, torch.abs(a64 - b64)),
                                nan=math.inf)
        floor = atol / rtol if rtol > 0.0 else 0.0
        rel = torch.where(diff == 0.0, 0.0, diff / torch.clamp(torch.abs(a64), min=floor))
        if diff.numel():
            max_err = max(max_err, float(diff.max()))
            max_rel = max(max_rel, float(torch.nan_to_num(rel, nan=math.inf).max()))
        bad = ~(diff <= atol + rtol * torch.abs(a64))
        if bool(bad.any()):
            fails.append(f"{name}: {int(bad.sum())} lanes beyond rtol {rtol} atol {atol}")
    return max_err, max_rel, worst, fails
