"""ctypes binding of the native HARM dump parser (``csrc/harmio.cpp``).

Port of ``grmonty_tpu/models/harmio_native.py``.  ``csrc/harmio.cpp`` is a
byte-identical copy of the JAX package's ``native/harmio.cpp``: it splits
the dump body at line boundaries into one chunk per hardware thread and
parses each chunk with ``strtod``.

Build: ``g++ -O3 -shared -fPIC`` into ``build/grmonty_tpu_torch/``, keyed by
a hash of the source and the flags, at first use; the library is written
under a temporary name and moved into place, so concurrent builds (the
ranks of a sharded run) are safe.  Unlike the JAX package, whose reader
falls back to numpy silently, a missing ``g++`` or a failed build raises:
``models.harm.read_dump(..., native=False)`` is the explicit numpy parse.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(PKG_DIR, "csrc", "harmio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "grmonty_tpu_torch")
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None


def library_path():
    """The built library's path, keyed by the source's and the flags' hash."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"harmio_{h.hexdigest()[:16]}.so")


def _build(so):
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native dump parser needs g++, which is not on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SRC, "-lpthread"],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed ({out.returncode}) for {SRC}:\n{out.stderr}")
    os.replace(tmp, so)


def load():
    """Build the library if its hashed file is missing, load it and set
    the signature of ``harmio_parse_doubles``."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _build(so)
        lib = ctypes.CDLL(so)
        lib.harmio_parse_doubles.restype = ctypes.c_int64
        lib.harmio_parse_doubles.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_int32]
        _lib = lib
        return _lib


def parse_doubles(text: str | bytes) -> np.ndarray:
    """The whitespace-separated doubles of ``text`` as a float64 array;
    raises ``ValueError`` if the parser reports an error."""
    raw = text.encode() if isinstance(text, str) else text
    cap = len(raw) // 2 + 16  # every token needs >= 1 digit + 1 separator
    out = np.empty(cap, dtype=np.float64)
    n = load().harmio_parse_doubles(
        raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap, 0)
    if n < 0:
        raise ValueError("the native parser could not parse the dump body")
    return out[:n].copy()
