"""The port's row gather against the JAX package's Pallas row gather, and the
port's copies of the tracked tables against the JAX package's files.

The gather is a copy, so the port's plain version (the one the wrapper
takes on CPU tensors) must equal ``gather.vmem_row_gather`` in interpret
mode exactly, at the shapes of tests/test_gather.py, on tables and indices
from a numpy seed.  The kernel itself is held to ``table[idx]`` bitwise on
the card (here and in ``chip_smoke.py``).

JAX is imported inside the test that compares with it, so that the card
test runs on a machine with only the port's dependencies:
``python -m pytest --noconftest -m cuda tests/test_torch_gather.py``.
"""

import hashlib
import os

import numpy as np
import pytest
import torch

from grmonty_tpu_torch.transport import hot_kernels
from grmonty_tpu_torch.utils import tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("z, w, n", [(512, 32, 512), (256, 32, 1000), (1024, 32, 300)])
def test_row_gather_matches_vmem_row_gather(z, w, n):
    import jax.numpy as jnp

    from grmonty_tpu.ops import gather

    rng = np.random.default_rng(z + n)
    table = rng.standard_normal((z, w)).astype(np.float32)
    idx = rng.integers(0, z, n).astype(np.int32)
    idx[:2] = (0, z - 1)
    ref = np.asarray(gather.vmem_row_gather(jnp.asarray(table), jnp.asarray(idx),
                                            interpret=True))
    before = dict(hot_kernels.launches)
    got = hot_kernels.row_gather(torch.as_tensor(table), torch.as_tensor(idx))
    assert hot_kernels.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, w)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_row_gather_raises_on_a_tensor_neither_on_cpu_nor_on_the_card():
    table = torch.zeros((8, 32), dtype=torch.float32, device="meta")
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        hot_kernels.row_gather(table, idx)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_row_gather_matches_indexing_on_the_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    dev, z, w, n = torch.device("cuda"), 65536, 32, 65536
    rng = np.random.default_rng(5)
    table = torch.as_tensor(rng.standard_normal((z, w)), dtype=dtype, device=dev)
    idx_np = rng.integers(0, z, n).astype(np.int32)
    idx_np[:2] = (0, z - 1)
    idx = torch.as_tensor(idx_np, device=dev)
    name = hot_kernels.entry_point("row_gather", dtype)
    n0 = hot_kernels.launches[name]
    got = hot_kernels.row_gather(table, idx)
    torch.cuda.synchronize()
    assert hot_kernels.launches[name] == n0 + 1
    assert got.dtype == dtype and torch.equal(got, table[idx.long()])


@pytest.mark.parametrize("name", [tables.HOTCROSS_FILE, tables.JNU_FILE, tables.THETA_Q_FILE])
def test_data_copies_match_the_jax_package(name):
    def digest(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    port = os.path.join(tables.DATA_DIR, name)
    assert os.path.dirname(os.path.abspath(port)) == os.path.join(
        ROOT, "grmonty_tpu_torch", "data")
    assert digest(port) == digest(os.path.join(ROOT, "grmonty_tpu", "data", name))
