"""Gather strategies for the fluid corner fetch, timed per link of a chain:
the counterpart of the JAX package's ``tools/probe_vmem_gather.py``.

    python -m grmonty_tpu_torch.tools.probe_vmem_gather   # PROBE_N PROBE_Z PROBE_W

Variants over a (Z, w) table:

* ``torch``: ``table[idx].sum(1)`` in eager PyTorch, the baseline row
  gather from device memory (the JAX probe's ``xla``);
* ``torch_sorted``: the same with sorted indices (coalescing);
* ``cuda_take`` and ``cuda_taa``: ``gather_rowsum(strategy="coop")``, the
  Hopper counterpart of both ``pallas_take``
  (``tools/probe_vmem_gather.py:106``, ``jnp.take``) and ``pallas_taa``
  (``:142``, ``take_along_axis``).  The two compute the same function and
  differ only in how Mosaic lowers the gather, which has no counterpart on
  Hopper, so one kernel serves both; the two keys are two measurements of
  it;
* ``cuda_ds``: ``row_gather_rowloop``, the row copy
  ``out[n, :] = table[idx[n], :]``, of ``pallas_ds``
  (``:178``); its link takes the row sum of the copy.

The JAX probe's ``xla_barrier`` has no counterpart: ``lax.optimization_barrier``
kept XLA's gather a standalone op, and eager PyTorch always runs it as one,
which ``torch_ms`` measures.  The port's kernels have no grid block, so
``PROBE_BLK`` is not read.

Each is timed as the marginal time per link of chains of 16 and 128 links
captured into CUDA graphs (``tools.chain_ms``); a link also holds the small
glue kernels that XLA fused, so its time is an upper bound on the
kernel's, and ``chip_smoke.py`` reports the kernel's device time alone.
Prints one JSON line: ``n z w``, ``torch_ms``, ``torch_sorted_ms``,
``cuda_take_ms``, ``cuda_taa_ms``, ``cuda_ds_ms`` and ``card``.  A kernel
that fails to build, launch or be captured raises.  With no CUDA device it
exits 2.
"""

import json
import os

import numpy as np
import torch

from grmonty_tpu_torch.tools import card, chain_ms, require_cuda
from grmonty_tpu_torch.transport import hot_kernels

SHORT, LONG = 16, 128


def experiments(device, n, z, w, gen):
    """The probe's inputs and ops on ``device``: a float32 normal (z, w)
    table and indices uniform in [0, z - 1), drawn from ``gen`` (a numpy
    Generator), and the indices sorted.  Returns (data, ops): the numpy
    inputs (``table``, ``idx``, ``idx_sorted``) and, by variant name,
    (op, base indices); ``op(idx)`` gives the (n,) row sums, or the (n, w)
    rows for ``cuda_ds``."""
    idx = gen.integers(0, z - 1, n).astype(np.int32)
    data = {"table": gen.standard_normal((z, w)).astype(np.float32), "idx": idx,
            "idx_sorted": np.sort(idx)}
    table, i, i_sorted = (torch.as_tensor(data[k], device=device)
                          for k in ("table", "idx", "idx_sorted"))

    def coop(j):
        return hot_kernels.gather_rowsum(table, j, "coop")

    ops = {"torch": (lambda j: hot_kernels.plain_rowsum(table, j), i),
           "torch_sorted": (lambda j: hot_kernels.plain_rowsum(table, j), i_sorted),
           "cuda_take": (coop, i),
           "cuda_taa": (coop, i),
           "cuda_ds": (lambda j: hot_kernels.row_gather_rowloop(table, j), i)}
    return data, ops


def measure():
    """The probe's JSON object, measured on the card."""
    n = int(os.environ.get("PROBE_N", "65536"))
    z = int(os.environ.get("PROBE_Z", "65536"))
    w = int(os.environ.get("PROBE_W", "32"))
    _, ops = experiments(torch.device("cuda"), n, z, w, np.random.default_rng(0))
    results = {"n": n, "z": z, "w": w}
    for name, (op, base) in ops.items():
        results[f"{name}_ms"] = chain_ms(op, base, z, SHORT, LONG)
    results["card"] = card()
    return results


def main():
    require_cuda("probe_vmem_gather")
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
