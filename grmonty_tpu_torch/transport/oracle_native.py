"""ctypes binding of the native C++ scalar tracker (``csrc/oracle.cpp``).

Port of ``grmonty_tpu/transport/oracle_native.py``: ``NativeTracker``,
``_Consts``, ``_Out`` and the ctypes signatures of the library's four
entry points: ``oracle_run`` (track a batch), and the hooks ``oracle_probe``
(every deterministic sub-function at one state, ``PROBE_LEN`` values),
``oracle_sample_electron`` and ``oracle_sample_scattered`` (the two
rejection samplers, ``n`` draws from a seed), which tests hold against the
JAX binding's.  ``NativeTracker(..., bias_fixed=(tau, avg))`` pins the
scattering-bias normalization to tau * (avg + 2), the frozen-bias
comparison mode of the accuracy gate
(``grmonty_tpu_torch.tools.validate_accuracy``; ``Consts.bias_fixed_tau``
in the source).  ``csrc/oracle.cpp`` is a byte-identical copy of the JAX
package's ``native/oracle.cpp`` (a test compares their hashes): the scalar
physics of the reference, tracked one photon at a time with its
per-photon bias feedback.  The driver uses it twice: the pilot that warms
the bias counters before the first wave
(``driver.Simulation._host_warm_counters``) and the CPU backend
(``Simulation.run_native_cpu``); the accuracy gate runs it as the oracle.

The tracker reads the hotcross table (221x81) and the K2 table (201) from
``utils/tables.py``, and the primitives (8, n1, n2) from its caller.

Build: ``g++ -O3 -shared -fPIC`` into ``build/grmonty_tpu_torch/``, keyed by
a hash of the source, at first use; the library is written under a
temporary name and moved into place, so concurrent builds are safe.  A
missing ``g++`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import typing

import numpy as np

from grmonty_tpu_torch import consts
from grmonty_tpu_torch.transport import engine
from grmonty_tpu_torch.utils import tables as tables_mod

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(PKG_DIR, "csrc", "oracle.cpp")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "grmonty_tpu_torch")
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

N_SPEC_CHAN = 16
PROBE_LEN = 128

_lock = threading.Lock()
_lib = None


class _Consts(ctypes.Structure):
    _fields_ = [
        ("a", ctypes.c_double),
        ("h_slope", ctypes.c_double),
        ("r_0", ctypes.c_double),
        ("x_start", ctypes.c_double * 4),
        ("x_stop", ctypes.c_double * 4),
        ("dx", ctypes.c_double * 4),
        ("n1", ctypes.c_int64),
        ("n2", ctypes.c_int64),
        ("n_e_unit", ctypes.c_double),
        ("theta_e_unit", ctypes.c_double),
        ("b_unit", ctypes.c_double),
        ("x1_min", ctypes.c_double),
        ("bias_norm", ctypes.c_double),
        ("d_tau_k", ctypes.c_double),
        ("max_tau_scatt0", ctypes.c_double),
        # frozen-bias comparison mode (0 = live feedback counters)
        ("bias_fixed_tau", ctypes.c_double),
        ("bias_fixed_avg", ctypes.c_double),
    ]


class _Out(ctypes.Structure):
    _fields_ = [
        ("max_tau_scatt", ctypes.c_double),
        ("n_recorded", ctypes.c_int64),
        ("n_scatt_rec", ctypes.c_int64),
    ]


class Photons(typing.NamedTuple):
    """A batch of photons in the tracker's fields (host numpy, float64;
    ``n_scatt`` int32)."""

    x: np.ndarray  # (N, 4)
    k: np.ndarray  # (N, 4)
    w: np.ndarray
    e: np.ndarray
    l: np.ndarray
    n_e_0: np.ndarray
    theta_e_0: np.ndarray
    b_0: np.ndarray
    e_0: np.ndarray
    n_scatt: np.ndarray


def photons_from_rows(rows, weight_scale=1.0) -> Photons:
    """Unpack (N, 16) backlog rows (``engine.ROW_*`` layout, a tensor or an
    array) into :class:`Photons`, the weight divided by ``weight_scale``."""
    r = np.asarray(rows.detach().cpu() if hasattr(rows, "detach") else rows, np.float64)
    col = lambda i: np.ascontiguousarray(r[:, i])  # noqa: E731
    return Photons(
        x=np.ascontiguousarray(r[:, 0:4]), k=np.ascontiguousarray(r[:, 4:8]),
        w=col(engine.ROW_W) / weight_scale, e=col(engine.ROW_E), l=col(engine.ROW_L),
        n_e_0=col(engine.ROW_NE0), theta_e_0=col(engine.ROW_THETAE0), b_0=col(engine.ROW_B0),
        e_0=col(engine.ROW_E0), n_scatt=r[:, engine.ROW_NSCATT].astype(np.int32))


def library_path():
    """The built library's path, keyed by the source's and the flags' hash."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"oracle_{h.hexdigest()[:16]}.so")


_DP = ctypes.POINTER(ctypes.c_double)


def _build(so):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native tracker needs g++, which is not on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC], capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed ({out.returncode}) for {SRC}:\n{out.stderr}")
    os.replace(tmp, so)


def load():
    """Build the library if its hashed file is missing, load it and set
    the signatures of its entry points."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.oracle_run.restype = ctypes.c_int
        # 12 double pointers: hc, k2, prims, x, k, w, e, l, n_e_0,
        # theta_e_0, b_0, e_0
        lib.oracle_run.argtypes = (
            [ctypes.POINTER(_Consts)] + [_DP] * 12
            + [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_uint64,
               _DP, ctypes.POINTER(_Out), ctypes.c_int64]
        )
        lib.oracle_probe.restype = ctypes.c_int
        lib.oracle_probe.argtypes = (
            [ctypes.POINTER(_Consts)] + [_DP] * 6 + [ctypes.c_double, ctypes.c_double, _DP])
        lib.oracle_sample_electron.restype = ctypes.c_int
        lib.oracle_sample_electron.argtypes = [
            ctypes.POINTER(_Consts), _DP, ctypes.c_double, ctypes.c_uint64, ctypes.c_int64, _DP]
        lib.oracle_sample_scattered.restype = ctypes.c_int
        lib.oracle_sample_scattered.argtypes = [
            ctypes.POINTER(_Consts), _DP, _DP, ctypes.c_uint64, ctypes.c_int64, _DP]
        _lib = lib
        return _lib


def _c_consts(mc) -> _Consts:
    c = _Consts()
    c.a = float(mc.a)
    c.h_slope = float(mc.h_slope)
    c.r_0 = float(mc.r_0)
    for i in range(4):
        c.x_start[i] = float(mc.x_start[i])
        c.x_stop[i] = float(mc.x_stop[i])
        c.dx[i] = float(mc.dx[i])
    c.n1 = int(mc.n1)
    c.n2 = int(mc.n2)
    c.n_e_unit = float(mc.n_e_unit)
    c.theta_e_unit = float(mc.theta_e_unit)
    c.b_unit = float(mc.b_unit)
    c.x1_min = float(mc.x1_min)
    c.bias_norm = float(mc.bias_norm)
    c.d_tau_k = float(mc.d_tau_k)
    c.max_tau_scatt0 = float(mc.max_tau_scatt0)
    return c


def _f64(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def _ptr(a):
    return a.ctypes.data_as(_DP)


class NativeTracker:
    """The scalar tracker: ``run`` tracks a batch and accumulates its
    spectrum into ``spec`` (N_TH_BINS, N_E_BINS, 16), carrying the bias
    feedback counters (``n_recorded``, ``n_scatt_rec``,
    ``max_tau_scatt``) from call to call.  ``prims``: the (8, n1, n2)
    primitives, a host array.  ``bias_fixed``: None (the live feedback) or
    (tau, avg), the frozen-bias comparison mode."""

    def __init__(self, mc, prims, seed=consts.RNG_SEED, bias_fixed=None):
        self._lib = load()
        self.mc = mc
        self._c = _c_consts(mc)
        if bias_fixed is not None:
            self._c.bias_fixed_tau = float(bias_fixed[0])
            self._c.bias_fixed_avg = float(bias_fixed[1])
        self._hc = _f64(tables_mod.hotcross_table())
        assert self._hc.shape == (221, 81), self._hc.shape
        self._k2 = _f64(tables_mod.jnu_tables()[1])
        assert self._k2.shape == (201,), self._k2.shape
        self._prims = _f64(prims)
        assert self._prims.shape == (8, mc.n1, mc.n2), self._prims.shape
        self.seed = int(seed)
        self.spec = np.zeros((consts.N_TH_BINS, consts.N_E_BINS, N_SPEC_CHAN))
        self.n_recorded = 0
        self.n_scatt_rec = 0
        self.max_tau_scatt = float(mc.max_tau_scatt0)
        # IN/OUT counter block: the bias feedback state across run() calls
        self._out = _Out(float(mc.max_tau_scatt0), 0, 0)
        self._calls = 0

    def run(self, photons, progress_every=1000):
        """Track a batch (any object with :class:`Photons`' fields, host
        numpy); accumulates into ``spec`` and returns it."""
        n = photons.w.shape[0]
        x = _f64(photons.x)
        k = _f64(photons.k)
        args1 = [_f64(getattr(photons, f))
                 for f in ("w", "e", "l", "n_e_0", "theta_e_0", "b_0", "e_0")]
        n_scatt = np.ascontiguousarray(photons.n_scatt, dtype=np.int32)
        # a distinct stream per chunked call; the state carries via self._out
        seed = self.seed + 0x9E37_79B9 * self._calls
        self._calls += 1
        rc = self._lib.oracle_run(
            ctypes.byref(self._c), _ptr(self._hc), _ptr(self._k2),
            _ptr(self._prims), _ptr(x), _ptr(k), *[_ptr(a) for a in args1],
            n_scatt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, seed, _ptr(self.spec), ctypes.byref(self._out),
            int(progress_every),
        )
        if rc != 0:
            raise RuntimeError(f"oracle_run failed rc={rc}")
        self.n_recorded = int(self._out.n_recorded)
        self.n_scatt_rec = int(self._out.n_scatt_rec)
        self.max_tau_scatt = float(self._out.max_tau_scatt)
        return self.spec

    # -- test hooks -----------------------------------------------------------
    def probe(self, x, k, dk, e0s, dl):
        """Every deterministic sub-function at one state (x, k, dk/dlambda,
        the conserved energy, a step length): ``PROBE_LEN`` values in the
        layout of ``oracle_probe`` in the source."""
        out = np.zeros(PROBE_LEN)
        rc = self._lib.oracle_probe(
            ctypes.byref(self._c), _ptr(self._hc), _ptr(self._k2), _ptr(self._prims),
            _ptr(_f64(x)), _ptr(_f64(k)), _ptr(_f64(dk)), float(e0s), float(dl), _ptr(out))
        if rc != 0:
            raise RuntimeError(f"oracle_probe failed rc={rc}")
        return out

    def sample_electron(self, k_tet, theta_e, n, seed=1):
        """``n`` electron momenta (n, 4) from the rejection sampler, for the
        tetrad-frame photon ``k_tet`` at temperature ``theta_e``."""
        out = np.zeros((n, 4))
        rc = self._lib.oracle_sample_electron(
            ctypes.byref(self._c), _ptr(_f64(k_tet)), float(theta_e), int(seed), int(n),
            _ptr(out.reshape(-1)))
        if rc != 0:
            raise RuntimeError(f"oracle_sample_electron failed rc={rc}")
        return out

    def sample_scattered(self, k_tet, p, n, seed=1):
        """``n`` scattered photon momenta (n, 4) from the Klein-Nishina
        sampler, for the photon ``k_tet`` off the electron ``p``."""
        out = np.zeros((n, 4))
        rc = self._lib.oracle_sample_scattered(
            ctypes.byref(self._c), _ptr(_f64(k_tet)), _ptr(_f64(p)), int(seed), int(n),
            _ptr(out.reshape(-1)))
        if rc != 0:
            raise RuntimeError(f"oracle_sample_scattered failed rc={rc}")
        return out
