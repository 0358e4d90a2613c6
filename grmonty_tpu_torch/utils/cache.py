"""The physics tables' file cache, keyed on the constants that shape them.

Port of ``grmonty_tpu/utils/cache.py``.  The hotcross sigma table, the
synchrotron F(k)/K2 tables and the emission direction quantile table depend
only on constants, so each is stored as ``<name>_<key>.npz``, where the key
hashes ``repr`` of the parameters that shape it, exactly as the JAX
package's ``_key`` does: a changed constant gives another name, and the
table is rebuilt.  (``repr`` makes the key sensitive to the type of each
part: an int where the JAX package has a float gives another name, so the
parts are the port's ``consts`` and ``ops/emission`` values, which equal
the JAX package's, and ``tests/test_torch_table_build.py`` pins the three
names.)

A lookup reads the tracked copy under ``grmonty_tpu_torch/data/``
(``DATA_DIR``) first, then the build cache ``CACHE_DIR``
(``build/grmonty_tpu_torch/tables/`` in the checkout, git-ignored); on a
miss it runs the builder (``ops/hotcross.build_table``,
``ops/jnu.build_tables``, ``ops/emission.build_theta_quantiles``, numpy on
the host) and writes the result to ``CACHE_DIR``, never into the tracked
directory.  The per-dump init cache of the JAX package (``dump_init``) is
not ported: the port builds its per-dump tables on the run's device.
"""

import hashlib
import logging
import os

import numpy as np

from grmonty_tpu_torch import consts

log = logging.getLogger(__name__)

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(PKG_DIR, "data")
CACHE_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "grmonty_tpu_torch", "tables")


def _key(*parts) -> str:
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:12]


def hotcross_key() -> str:
    hc = consts.hotcross
    return _key(hc.MIN_W, hc.MAX_W, hc.MIN_T, hc.MAX_T, hc.N_W, hc.N_T,
                hc.MAX_GAMMA, hc.D_MU_E, hc.D_GAMMA_E)


def jnu_key() -> str:
    j = consts.jnu
    return _key(j.MIN_K, j.MAX_K, j.MIN_T, j.MAX_T, consts.N_E_SAMP, j.EPS_REL)


def theta_q_key() -> str:
    from grmonty_tpu_torch.ops import emission

    return _key(emission.TH_X_NODES, emission.TH_U_NODES, emission.TH_LX_MIN,
                emission.TH_LX_MAX, consts.jnu.CST, "v1")


def file_name(name, key) -> str:
    return f"{name}_{key}.npz"


def _cached(name, key, builder):
    """The arrays of ``<name>_<key>.npz`` from DATA_DIR or CACHE_DIR, else
    ``builder()``'s, written to CACHE_DIR (atomically: a temporary file,
    then ``os.replace``).  One array or a tuple of arrays."""
    fname = file_name(name, key)
    for d in (DATA_DIR, CACHE_DIR):
        path = os.path.join(d, fname)
        if os.path.exists(path):
            with np.load(path) as z:
                arrs = tuple(np.asarray(z[k]) for k in z.files)
            return arrs if len(arrs) > 1 else arrs[0]
    path = os.path.join(CACHE_DIR, fname)
    log.info("Building the %s table (cached to %s)", name, path)
    result = builder()
    os.makedirs(CACHE_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        if isinstance(result, tuple):
            np.savez(f, *result)
        else:
            np.savez(f, result)
    os.replace(tmp, path)
    return result


def hotcross_table() -> np.ndarray:
    """(N_W+1, N_T+1) log10 hot Compton cross-section [cm^2]."""
    from grmonty_tpu_torch.ops import hotcross

    return _cached("hotcross", hotcross_key(), hotcross.build_table)


def jnu_tables() -> tuple:
    """(f_table, k2_table): ln F(k) and ln K2(1/theta_e), each (201,)."""
    from grmonty_tpu_torch.ops import jnu

    return _cached("jnu", jnu_key(), jnu.build_tables)


def theta_quantiles() -> np.ndarray:
    """(TH_X_NODES, TH_U_NODES) float32 |cos theta| emission quantiles."""
    from grmonty_tpu_torch.ops import emission

    return _cached("theta_q", theta_q_key(), emission.build_theta_quantiles)
