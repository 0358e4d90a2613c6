"""The hand-written CUDA kernels of the hot step, and their dispatch.

``csrc/hot_step.cu`` holds the two phase kernels for Hopper (sm_90a), each
in two compile-time variants:

* kernel A replaces the TPU kernel ``grmonty_tpu/transport/hotstep_pallas.py:104``
  (``kernel_a``, body ``engine.hot_phase_a``): the geodesic push, step
  control, stop test and cell index.  ``hot_phase_a`` is the shipped
  profile's (proportional step control, grown-step optical-depth cap);
  ``hot_phase_a_ladder`` reference semantics (the halve/double ladder);
* kernel B replaces ``hotstep_pallas.py:152`` (``kernel_b``, body
  ``engine.hot_phase_b``): ``hot_phase_b`` blends the derived 44-wide
  corner rows, which it gathers itself; ``hot_phase_b_raw`` blends the raw
  32-wide rows that the row gather produced, through the metric pair.

``csrc/row_gather.cu`` replaces ``grmonty_tpu/ops/gather.py:63``
(``_gather_kernel``): ``out[n, :] = table[idx[n], :]``, the raw corner-row
gather of the reference hot step, the event phase and the fresh-lane init.

``csrc/gather_probe.cu`` replaces the eight Pallas kernels of the gather
probes under ``tools/``: :func:`gather_rowsum` (``table[idx].sum(1)`` by
four strategies) and :func:`row_gather_rowloop` (the row copy, one thread
per row); the probes that drive them are ``grmonty_tpu_torch/tools/``.

Each thread of a phase kernel runs one lane; the headers of the ``.cu``
files say what bounds each kernel on the card.

:func:`phase_a`, :func:`phase_b`, :func:`phase_b_raw`, :func:`row_gather`,
:func:`gather_rowsum` and :func:`row_gather_rowloop` take their plain
versions' arguments.  On CPU tensors they call the plain versions
(``engine.hot_phase_a`` / ``hot_phase_b`` / indexing); on CUDA tensors they
launch the kernel, or raise.  ``launches`` counts kernel launches only; a
launch captured into a CUDA graph counts once, its replays not at all.

Build: ``nvcc`` compiles each ``csrc/*.cu`` into its own shared library
with a plain C interface under ``build/grmonty_tpu_torch/`` (keyed by a
hash of the source and the flags, all sources at once in parallel, at
first use) and ``ctypes`` loads them.
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
launches = {"hot_phase_a": 0, "hot_phase_a_ladder": 0, "hot_phase_b": 0,
            "hot_phase_b_raw": 0, "row_gather": 0, "gather_rowsum_coop": 0,
            "gather_rowsum_persistent": 0, "gather_rowsum_rowloop": 0,
            "gather_rowsum_smem": 0, "row_gather_rowloop": 0}
# The strategies of gather_rowsum, each its own entry point gather_rowsum_<s>.
ROWSUM_STRATEGIES = ("coop", "persistent", "rowloop", "smem")


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
# Kernel B on raw rows: no cell index, entry roll, tau_over or detached
# outputs; its scalars are these, then kernel B's.
_B_RAW_PTRS = ("rows hc bias_scale x0 x1 x2 x3 k0 k1 k2 k3 d0 d1 d2 d3 e_0_s w "
               "alpha_scatti alpha_absi bi tau_abs tau_scatt interacting pend_dl "
               "pend_push sec_w n_step alive px0 px1 px2 px3 pk0 pk1 pk2 pk3 pd0 pd1 "
               "pd2 pd3 pe0s seg commit moving was_pend stopped u_x1 "
               "ox0 ox1 ox2 ox3 ok0 ok1 ok2 ok3 od0 od1 od2 od3 "
               "oe_0_s opend_dl osec_w opend_push ow otau_abs otau_scatt "
               "oalpha_scatti oalpha_absi obi ointeracting oalive on_step ohc_clamp").split()
_B_RAW_SCAL = "a h_slope r_0 n_e_unit theta_e_unit".split()
# (pointers, scalars) each entry point takes
_ABI = {"hot_phase_a": (len(_A_PTRS), len(_A_SCAL)),
        "hot_phase_a_ladder": (len(_A_PTRS), len(_A_SCAL)),
        "hot_phase_b": (len(_B_PTRS), len(_B_SCAL_HEAD) + _K2_N),
        "hot_phase_b_raw": (len(_B_RAW_PTRS), len(_B_RAW_SCAL) + len(_B_SCAL_HEAD) + _K2_N),
        "row_gather": (3, 1),
        **{f"gather_rowsum_{s}": (3, 2 if s == "smem" else 1) for s in ROWSUM_STRATEGIES},
        "row_gather_rowloop": (3, 1)}


class _Build:
    """The loaded libraries, their entry points and how they were built
    (one per process)."""

    fns = None  # kernel name -> ctypes function
    paths = []
    seconds = 0.0
    log = ""


def build():
    """Compile each ``csrc/*.cu`` whose hashed library is missing (one
    ``nvcc`` per source, all started together), load them, check each
    entry point's pointer and scalar counts against the wrapper's, and
    return (library paths, build seconds, nvcc/ptxas output)."""
    if _Build.fns is not None:
        return _Build.paths, _Build.seconds, _Build.log
    t0 = time.monotonic()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    paths, jobs = [], []
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))):
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        with open(src, "rb") as f:
            h.update(f.read())
        stem = os.path.splitext(os.path.basename(src))[0]
        path = os.path.join(BUILD_DIR, f"{stem}_{h.hexdigest()[:16]}.so")
        paths.append(path)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            jobs.append((path, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    log = [(path, tmp, proc.returncode, out) for path, tmp, proc in jobs
           for out in [proc.communicate()[0]]]
    for path, tmp, rc, out in log:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) for {path}:\n{out}")
        os.replace(tmp, path)
    fns = {}
    for path in paths:
        lib = ctypes.CDLL(path)
        for name, (n_ptrs, n_scal) in _ABI.items():
            fn = getattr(lib, f"{name}_launch", None)
            if fn is None:
                continue
            fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_double),
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            got = tuple(getattr(lib, f"{name}_{what}")() for what in ("nptrs", "nscal"))
            if got != (n_ptrs, n_scal):
                raise RuntimeError(f"{name}: library takes {got} pointers/scalars, "
                                   f"the wrapper passes {(n_ptrs, n_scal)}")
            fns[name] = fn
    missing = sorted(set(_ABI) - set(fns))
    if missing:
        raise RuntimeError(f"no entry point for {missing} in {paths}")
    _Build.fns, _Build.paths = fns, paths
    _Build.seconds, _Build.log = time.monotonic() - t0, "".join(out for *_, out in log)
    return _Build.paths, _Build.seconds, _Build.log


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
    rc = _Build.fns[name](ptrs, sc, n, ctypes.c_void_p(stream))
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
            alive, w, record_pending, u_roul, alpha_scatti, bi, mc, grow_cap,
            reference=False):
    """Phase A of the hot step: the plain version on CPU tensors, kernel A
    (its ladder variant under ``reference``) on CUDA tensors.  Arguments
    and result as ``engine.hot_phase_a``."""
    if w.device.type == "cpu":
        return engine.hot_phase_a(
            x, k, dkdlam, e_0_s, dl_shrink, pend_dl, pend_push, at_event, alive, w,
            record_pending, u_roul, alpha_scatti, bi, mc, grow_cap, reference=reference)
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
    _launch("hot_phase_a_ladder" if reference else "hot_phase_a", ins + outs, scal, n, dev)
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
    _check_rows(tab, None, 44, dev, "derived table")
    lanes = [z, *x, *k, *dkdlam, e_0_s, w, alpha_scatti, alpha_absi, bi, tau_abs,
             tau_scatt, interacting, pend_dl, pend_push, sec_w, n_step, alive,
             *x_pre, *k_pre, *dk_pre, e0s_pre, seg, commit, moving, was_pend, stopped,
             u_x1, grown]
    _check(["z"] + _B_PTRS[4:4 + len(lanes) - 1], lanes, n, dev)
    head = dict(tau_over=_empty(n, torch.bool, dev), entry_roll=_empty(n, torch.bool, dev))
    out = _b_outputs(n, dev, detached=True)
    ptrs = ([tab, z] + _b_tables(hc_coeffs, bias_scale, dev) + lanes[1:]
            + list(head.values()) + _flat_outputs(out))
    _launch("hot_phase_b", ptrs, _b_scalars(mc, stall_steps, k2_coeffs, dev), n, dev)
    return dict(**head, **out)


def phase_b_raw(rows, x, k, dkdlam, e_0_s, w, alpha_scatti, alpha_absi, bi,
                tau_abs, tau_scatt, interacting, pend_dl, pend_push, sec_w,
                n_step, alive, x_pre, k_pre, dk_pre, e0s_pre,
                seg, commit, moving, was_pend, stopped, u_x1, grown, bias_scale,
                mc, hc_coeffs, k2_coeffs, stall_steps):
    """Phase B of the hot step under reference semantics, on the raw corner
    rows ``rows`` (N, 32) gathered at phase A's cells: the plain version
    (``engine.hot_phase_b(..., reference=True)``) on CPU tensors, the raw
    variant of kernel B on CUDA tensors.  ``grown`` is not read."""
    if w.device.type == "cpu":
        return engine.hot_phase_b(
            rows, x, k, dkdlam, e_0_s, w, alpha_scatti, alpha_absi, bi, tau_abs,
            tau_scatt, interacting, pend_dl, pend_push, sec_w, n_step, alive, x_pre,
            k_pre, dk_pre, e0s_pre, seg, commit, moving, was_pend, stopped, u_x1,
            grown, bias_scale, mc, hc_coeffs, k2_coeffs, stall_steps, reference=True)
    dev = _cuda_device(w)
    n = w.shape[0]
    _check_rows(rows, n, 32, dev, "raw rows")
    lanes = [*x, *k, *dkdlam, e_0_s, w, alpha_scatti, alpha_absi, bi, tau_abs,
             tau_scatt, interacting, pend_dl, pend_push, sec_w, n_step, alive,
             *x_pre, *k_pre, *dk_pre, e0s_pre, seg, commit, moving, was_pend, stopped,
             u_x1]
    _check(_B_RAW_PTRS[3:3 + len(lanes)], lanes, n, dev)
    out = _b_outputs(n, dev, detached=False)
    ptrs = [rows] + _b_tables(hc_coeffs, bias_scale, dev) + lanes + _flat_outputs(out)
    scal = [mc.a, mc.h_slope, mc.r_0, mc.n_e_unit, mc.theta_e_unit]
    scal += _b_scalars(mc, stall_steps, k2_coeffs, dev)
    _launch("hot_phase_b_raw", ptrs, scal, n, dev)
    return out


def row_gather(table, idx):
    """``table[idx]``: rows of a (Z, W) table at (N,) int32 indices in
    [0, Z) (not checked: the TPU kernel's PROMISE_IN_BOUNDS).  The plain
    version on CPU tensors, the kernel of ``csrc/row_gather.cu`` on CUDA
    tensors (float32, contiguous, W a multiple of 4); no host sync."""
    if table.device.type == "cpu":
        return table[idx.long()]
    dev, n, w = _gather_args(table, idx, "row gather")
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    _launch("row_gather", [table, idx, out], [w], n, dev)
    return out


def plain_rowsum(table, idx):
    """The plain version of :func:`gather_rowsum`: ``table[idx].sum(1)``."""
    return table[idx.long()].sum(dim=1)


def gather_rowsum(table, idx, strategy="coop", blk=256):
    """``table[idx].sum(1)``: row sums of a (Z, W) table at (N,) int32
    indices in [0, Z) (not checked, as in the TPU kernels).  The plain
    version on CPU tensors; on CUDA tensors the kernel of
    ``csrc/gather_probe.cu`` that ``strategy`` names (one of
    ``ROWSUM_STRATEGIES``; float32, contiguous, 16-byte aligned, W a
    multiple of 4).  ``blk`` is the rows per CTA of ``"smem"`` and is read
    by no other strategy.  The sums run in another order than the plain
    version's (``rowsum_slack`` bounds the difference); no host sync."""
    if strategy not in ROWSUM_STRATEGIES:
        raise ValueError(f"gather_rowsum: strategy {strategy!r} not in {ROWSUM_STRATEGIES}")
    if table.device.type == "cpu":
        return plain_rowsum(table, idx)
    dev, n, w = _gather_args(table, idx, f"gather_rowsum {strategy}")
    if strategy == "smem" and not (isinstance(blk, int) and blk > 0):
        raise ValueError(f"gather_rowsum smem: blk must be a positive int, got {blk!r}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    _launch(f"gather_rowsum_{strategy}", [table, idx, out],
            [w, blk] if strategy == "smem" else [w], n, dev)
    return out


def row_gather_rowloop(table, idx):
    """``table[idx]`` as :func:`row_gather`, by the one-thread-per-row
    kernel of ``csrc/gather_probe.cu`` on CUDA tensors (the plain version
    on CPU tensors)."""
    if table.device.type == "cpu":
        return table[idx.long()]
    dev, n, w = _gather_args(table, idx, "row_gather_rowloop")
    out = torch.empty((n, w), dtype=torch.float32, device=dev)
    _launch("row_gather_rowloop", [table, idx, out], [w], n, dev)
    return out


def _gather_args(table, idx, what):
    """(device, N, W) of a gather's CUDA table (Z, W) and int32 indices (N,)."""
    dev = _cuda_device(table)
    if table.dim() != 2 or table.shape[1] % 4:
        raise ValueError(f"{what}: expected a (Z, W) table with W % 4 == 0, got "
                         f"{tuple(table.shape)}")
    n = idx.shape[0]
    _check_rows(table, None, table.shape[1], dev, f"{what} table")
    _check(["idx"], [idx], n, dev)
    if idx.dtype != torch.int32:
        raise TypeError(f"{what}: int32 indices, got {idx.dtype}")
    return dev, n, table.shape[1]


def _empty(n, dtype, dev):
    return torch.empty(n, dtype=dtype, device=dev)


def _check_rows(t, n, width, dev, what):
    """A contiguous, 16-byte aligned float32 (n or any, width) tensor on dev."""
    if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != width
            or (n is not None and t.shape[0] != n) or not t.is_contiguous()
            or t.device != dev or t.data_ptr() % 16):
        raise ValueError(f"{what}: expected a contiguous, 16-byte aligned float32 "
                         f"({'Z' if n is None else n}, {width}) tensor on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _b_tables(hc_coeffs, bias_scale, dev):
    if (hc_coeffs.dtype != torch.float32 or tuple(hc_coeffs.shape) != (41, 31)
            or not hc_coeffs.is_contiguous() or hc_coeffs.device != dev):
        raise ValueError(f"hotcross coefficients: expected float32 (41, 31) on {dev}")
    if (bias_scale.dtype != torch.float32 or bias_scale.numel() != 1
            or bias_scale.device != dev):
        raise ValueError(f"bias_scale: expected a float32 scalar tensor on {dev}")
    return [hc_coeffs, bias_scale]


def _b_outputs(n, dev, detached):
    """Kernel B's outputs in pointer order (after tau_over/entry_roll)."""
    f32, b8 = torch.float32, torch.bool
    out = dict(x=tuple(_empty(n, f32, dev) for _ in range(4)),
               k=tuple(_empty(n, f32, dev) for _ in range(4)),
               dkdlam=tuple(_empty(n, f32, dev) for _ in range(4)))
    for name in ("e_0_s", "pend_dl", "sec_w"):
        out[name] = _empty(n, f32, dev)
    out["pend_push"] = _empty(n, b8, dev)
    for name in ("w", "tau_abs", "tau_scatt", "alpha_scatti", "alpha_absi", "bi"):
        out[name] = _empty(n, f32, dev)
    out.update(interacting=_empty(n, b8, dev), alive=_empty(n, b8, dev),
               n_step=_empty(n, torch.int32, dev))
    if detached:
        out.update({name: _empty(n, f32, dev) for name in ("a_scf", "a_abf", "bf", "nu", "n_e")})
    out["hc_clamp"] = _empty(n, b8, dev)
    return out


def _flat_outputs(out):
    return [t for v in out.values() for t in (v if isinstance(v, tuple) else (v,))]


def _b_scalars(mc, stall_steps, k2_coeffs, dev):
    """Kernel B's scalars (``_B_SCAL_HEAD`` order, then the K2 series)."""
    if len(k2_coeffs) != _K2_N:
        raise ValueError(f"k2 coefficients: expected {_K2_N}, got {len(k2_coeffs)}")
    scal = [mc.x_start[1], mc.x_start[2], mc.x_stop[1], mc.x_stop[2], mc.dx[1],
            mc.dx[2], mc.n1, mc.n2, mc.b_unit, mc.d_tau_k, engine.WEIGHT_MIN, stall_steps,
            engine.GROW_TAU_CAP, tables_mod.HC_XLO, tables_mod.HC_XHI,
            tables_mod.HC_YLO, tables_mod.HC_YHI, tables_mod.K2_LO, tables_mod.K2_HI]
    scal += [_recip(c, dev) for c in (
        mc.dx[1], mc.dx[2], mc.b_unit, consts.HPL, consts.ME * consts.CL * consts.CL,
        tables_mod.HC_XHI - tables_mod.HC_XLO, tables_mod.HC_YHI - tables_mod.HC_YLO,
        tables_mod.K2_HI - tables_mod.K2_LO, consts.CL, 24.0,
        2.0 * math.pi * consts.ME * consts.CL, engine.WEIGHT_MIN, consts.TP_OVER_TE)]
    return scal + list(np.asarray(k2_coeffs, np.float64))


# ---------------------------------------------------------------------------
# checks: synthetic lane states and the comparison contract
# ---------------------------------------------------------------------------

def synthetic_lanes(mc, n, seed, stall_steps, reference=False):
    """Random per-lane hot-step inputs, float64 numpy, from ``seed``.

    Positions span the grid, the vacuum beyond it, the horizon and the
    escape radius; momenta get a consistent dk/dlambda and conserved
    energy, so most pushes commit.  Step factors, pend pushes, parked
    lanes, small weights with forced roulette wins, zero-opacity lanes
    (grown entry roll), large opacities (tau_over, absorption), scatter
    draws and step counts at the cap reach every branch of both phases.
    ``reference`` adds the lanes that the reference variants need to reach
    every branch, drawn from a second stream so that all other lanes stay
    as they are: lanes at the polar edges (where the cell index clamps and
    the raw rows' metric pair is extreme), lanes flying backwards in time
    (negative fluid-frame frequency), and lanes whose conserved energy is
    off by 1e-3, so that their push fails unless at the shrink floor, some
    of them just above it.  Returns a dict of (n,) arrays (4-vectors as
    4-tuples) and the scalar ``bias_scale``."""
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
    extra = np.random.default_rng([seed, 1]).random((3, n)) if reference else np.ones((3, n))
    edge = (0.1 + 1.4 * extra[1]) * mc.dx[2]
    x2 = np.where(extra[0] < 0.02, mc.x_start[2] + edge,
                  np.where(extra[0] < 0.04, mc.x_stop[2] - edge, x2))
    x = (x[0], x1, x2, x[3])
    k = (np.where((extra[0] >= 0.04) & (extra[0] < 0.06), -k[0], k[0]),) + k[1:]
    drift = (extra[0] >= 0.06) & (extra[0] < 0.09)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    conn = geometry.connection_c(t(x1), t(x2), mc.a, mc.h_slope)
    dk = tuple(v.numpy() for v in geometry.geodesic_rhs_c(conn, *map(t, k)))
    g00, g01, g03 = (v.numpy() for v in geometry.gcov_row0_c(
        t(x1), t(x2), mc.a, mc.h_slope, mc.r_0))
    e_0_s = -(k[0] * g00 + k[1] * g01 + k[3] * g03)
    e_0_s = np.where(drift, e_0_s * (1.0 + 1e-3), e_0_s)

    floor = 2.0 ** (-consts.MAX_HALVING_DEPTH)
    dl_shrink = np.where(u(n) < 0.05, floor, 2.0 ** rng.uniform(-7.0, 3.0, n))
    dl_shrink = np.where(drift & (extra[2] < 0.5), floor * (1.0 + extra[1]), dl_shrink)
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
# (-fmad=false, the reciprocals of _recip), so both variants must equal it
# exactly; so must the gather, a copy.  Kernel B's hotcross Chebyshev sum
# cannot round exactly as the plain version's float32 matrix product and
# sum, and a weight decays by exp(-dtau), which multiplies a relative
# error in dtau by dtau; so both variants are held to the Pallas-vs-XLA
# parity contract of tests/test_pallas_hot.py.  The gather-probe row sums
# add a row's W terms in another order than the plain version, and rows of
# normal numbers can sum to nearly zero, so no relative tolerance fits
# them: each index may differ by rowsum_slack, W * 2^-23 * sum_j |row_j|
# (twice the worst-case error of either order), passed as compare's slack.
KERNEL_TOLERANCE = {
    "hot_phase_a": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
    "hot_phase_a_ladder": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
    "hot_phase_b": dict(rtol=1e-4, atol=1e-6, mask_frac=1e-3),
    "hot_phase_b_raw": dict(rtol=1e-4, atol=1e-6, mask_frac=1e-3),
    "row_gather": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
    **{f"gather_rowsum_{s}": dict(rtol=0.0, atol=0.0, mask_frac=0.0)
       for s in ROWSUM_STRATEGIES},
    "row_gather_rowloop": dict(rtol=0.0, atol=0.0, mask_frac=0.0),
}


def rowsum_slack(table, idx):
    """What a row sum of ``table[idx]`` may differ by between two summation
    orders, per index (float64): W * 2^-23 * sum_j |table[idx, j]|."""
    return table.shape[1] * 2.0 ** -23 * plain_rowsum(table.abs().double(), idx)


def compare(ref, got, rtol, atol, mask_frac, slack=None):
    """Hold a phase's outputs ``got`` against ``ref`` (dicts as the phases
    return them) on every lane: each mask and integer field differs on at
    most ``mask_frac`` of the lanes, and each float field agrees to
    ``rtol``/``atol``, plus ``slack`` (a tensor of the lanes) where given
    (NaN only where ``ref`` is NaN).  Returns
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
        allowed = atol + rtol * torch.abs(a64)
        if slack is not None:
            allowed = allowed + slack.to(a64.device)
        bad = ~(diff <= allowed)
        if bool(bad.any()):
            fails.append(f"{name}: {int(bad.sum())} lanes beyond rtol {rtol} atol {atol}"
                         + ("" if slack is None else " plus the slack"))
    return max_err, max_rel, worst, fails
