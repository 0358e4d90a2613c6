"""Gather-and-row-sum strategies on the card, timed per link of a chain: the
counterpart of the JAX package's ``tools/probe_pallas_gather.py``.

    python -m grmonty_tpu_torch.tools.probe_pallas_gather   # PROBE_N PROBE_Z PROBE_BLK

Variants, each ``table[idx].sum(1)`` over a (Z, 32) table:

* ``take1``: ``gather_rowsum(strategy="persistent")``, one wave of CTAs
  sized by occupancy over the whole pool (the passes fixed at launch), the
  counterpart of the one-grid-step ``take1``
  (``tools/probe_pallas_gather.py:74``);
* ``takeB``: ``gather_rowsum(strategy="coop")``, of the blocked ``takeB``
  (``:99``);
* ``dsB``: ``gather_rowsum(strategy="smem", blk=PROBE_BLK)``, rows staged
  into shared memory by ``cp.async`` and then summed, of ``dsB`` (``:125``,
  rows copied one by one into a VMEM scratch tile).  ``PROBE_BLK`` (default
  8192), the JAX probe's grid block, is read by this variant only: it caps
  the rows of one shared-memory stage (``hot_kernels.smem_stage_rows``);
  the kernel's grid is one wave whatever it is.

Each is timed as the marginal time per link of a chain: chains of 8 and 40
links captured into CUDA graphs (``tools.chain_ms``), the counterpart of
chaining inside ``lax.fori_loop``.  A link also holds the small glue
kernels that XLA fused (the index nudge, the carry update), so its time is
an upper bound on the kernel's; ``chip_smoke.py`` reports the kernel's
device time alone.  Prints one JSON line: ``n z w blk``, ``take1_ms``,
``takeB_ms``, ``dsB_ms`` and ``card``.  A kernel that fails to build,
launch or be captured raises.  With no CUDA device it exits 2.
"""

import json
import os

import numpy as np
import torch

from grmonty_tpu_torch.tools import card, chain_ms, require_cuda
from grmonty_tpu_torch.transport import hot_kernels

W = 32
SHORT, LONG = 8, 40


def experiments(device, n, z, w, blk, gen):
    """The probe's inputs and ops on ``device``: a float32 normal (z, w)
    table and indices uniform in [0, z - 1), drawn from ``gen`` (a numpy
    Generator).  Returns (data, ops): the numpy inputs (``table``, ``idx``)
    and, by variant name, (op, base indices) where ``op(idx)`` gives the
    (n,) row sums."""
    data = {"table": gen.standard_normal((z, w)).astype(np.float32),
            "idx": gen.integers(0, z - 1, n).astype(np.int32)}
    table, idx = (torch.as_tensor(data[k], device=device) for k in ("table", "idx"))
    rowsum = hot_kernels.gather_rowsum
    ops = {"take1": (lambda i: rowsum(table, i, "persistent"), idx),
           "takeB": (lambda i: rowsum(table, i, "coop"), idx),
           "dsB": (lambda i: rowsum(table, i, "smem", blk=blk), idx)}
    return data, ops


def measure():
    """The probe's JSON object, measured on the card."""
    n = int(os.environ.get("PROBE_N", "65536"))
    z = int(os.environ.get("PROBE_Z", "65536"))
    blk = int(os.environ.get("PROBE_BLK", "8192"))
    _, ops = experiments(torch.device("cuda"), n, z, W, blk, np.random.default_rng(0))
    results = {"n": n, "z": z, "w": W, "blk": blk}
    for name, (op, base) in ops.items():
        results[f"{name}_ms"] = chain_ms(op, base, z, SHORT, LONG)
    results["card"] = card()
    return results


def main():
    require_cuda("probe_pallas_gather")
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
