"""The scatter-chain distribution probe (``tools/probe_scatter_dist.py``) on
the CPU, against the native scalar samplers and the JAX engine's chain.

Three cells of the probe's grid, (theta_e, k0) = (2, 1e-6), (8, 1e-3) and
(20, 1e-1), at n = 4,000 photons with the probe's fixed seeds: the port's
deferring chain (``engine_chain``, float64) against the native tracker's
samplers (``oracle_chain``) and against the JAX tool's ``engine_chain``
(loaded from ``tools/probe_scatter_dist.py`` by path; ``tools/`` is not a
package), run as the JAX package runs on the CPU.  Each pair holds the log
amplification by a two-sample Kolmogorov-Smirnov test at p > 1e-3 and the
mean amplification within 4 combined standard errors.  The port's cell
keys and stats keys equal the JAX tool's.
"""

import ast
import importlib.util
import math
import os

import numpy as np
import pytest
import scipy.stats
import torch

from grmonty_tpu_torch.tools import probe_scatter_dist as probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(ROOT, "tools", "probe_scatter_dist.py")
N = 4000
CELLS = [(2.0, 1e-6), (8.0, 1e-3), (20.0, 1e-1)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_tool():
    spec = importlib.util.spec_from_file_location("jax_probe_scatter_dist", JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def native():
    return probe.native_tracker("cpu")


def _same(a, b, k0, what):
    """Log amplification by KS at p > 1e-3; means within 4 combined
    standard errors."""
    assert a.size >= 0.99 * N and b.size >= 0.99 * N, what
    p = scipy.stats.ks_2samp(np.log(a / k0), np.log(b / k0)).pvalue
    assert p > 1e-3, f"{what}: KS p {p}"
    se = math.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) <= 4.0 * se, f"{what}: means {a.mean()} {b.mean()} se {se}"


@pytest.mark.parametrize("theta_e,k0", CELLS)
def test_engine_chain_matches_oracle_and_jax(native, jax_tool, theta_e, k0):
    got = probe.engine_chain(theta_e, k0, N, probe.ENGINE_SEED)
    assert got.size == N  # every lane accepted within the 64 phases
    oracle = probe.oracle_chain(native, theta_e, k0, N, probe.ORACLE_SEED)
    ref = jax_tool.oracle_chain(native, theta_e, k0, N, probe.ORACLE_SEED)
    assert np.array_equal(oracle, ref)  # the same hooks, the same draws
    _same(got, oracle, k0, f"port vs oracle at {theta_e}, {k0}")
    jax_e = jax_tool.engine_chain(theta_e, k0, N, probe.ENGINE_SEED)
    _same(got, jax_e, k0, f"port vs JAX at {theta_e}, {k0}")


def _jax_cell_keys():
    """The keys of the JAX tool's per-cell dict literal (``cell = {...}``)."""
    with open(JAX_TOOL) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "cell" and isinstance(node.value, ast.Dict)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no cell literal in the JAX tool")


def test_cell_keys_match_the_jax_tool(native, jax_tool):
    c = probe.cell(native, 2.0, 1e-3, 500)
    assert set(c) == _jax_cell_keys()
    sample = np.linspace(1.0, 3.0, 50)
    assert probe.stats(sample, 0.5) == jax_tool.stats(sample, 0.5)
    assert set(c["engine"]) == set(c["oracle"]) == set(jax_tool.stats(sample, 0.5))
    assert (probe.THETAS, probe.K0S) == ((2.0, 8.0, 20.0), (1e-6, 1e-3, 1e-1))
    assert c["mean_ratio"] == c["engine"]["mean_amp"] / c["oracle"]["mean_amp"]


def test_ratio_errors_match_the_spread_over_seeds(native):
    """The Monte Carlo errors that phase 13 of chip_smoke.py holds the
    ratios with: on (8, 1e-3) at 4,000 photons, the mean ratio's and the
    q99 ratio's errors lie within a factor 2 of their spread over 8 engine
    seeds against one oracle sample."""
    o = probe.oracle_chain(native, 8.0, 1e-3, N, probe.ORACLE_SEED)
    chains = [probe.engine_chain(8.0, 1e-3, N, seed) for seed in range(8)]
    err = probe.ratio_errors(chains[0], o)
    assert set(err) == {"mean_ratio", "q99_ratio"}
    # the spread over engine seeds is the engine side's share of the error
    for key, f in (("mean_ratio", np.mean), ("q99_ratio", lambda a: np.quantile(a, 0.99))):
        spread = np.std([f(e) / f(o) for e in chains], ddof=1)
        assert 0.5 * spread < err[key] / math.sqrt(2.0) < 2.0 * spread, (key, err[key], spread)
