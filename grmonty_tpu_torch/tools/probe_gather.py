"""Probe the card's cost of the transport engine's gather primitives: the
counterpart of the JAX package's ``tools/probe_gather.py``.

    python -m grmonty_tpu_torch.tools.probe_gather

Times, at N = Z = 65,536 (the 256x256 zones), each of these as the least of
5 single calls after a warm-up, by CUDA events around a call on an idle
stream, so the host's launch cost is included as JAX's dispatch was:

* ``torch_gather_w{8..256}``: ``table[idx].sum(1)`` in eager PyTorch at
  seven widths (the XLA gathers; at w = 216 and 256 the table outgrows the
  50 MB L2), at w = 216 with half the indices, at w = 32 with sorted indices;
* ``torch_gather_4x_w8``: four narrow gathers of neighbouring cells;
* ``relayout_n{8,32}_T``: an (N, w) to (w, N) relayout, then a sum; the
  transpose is made contiguous, since in eager PyTorch ``a.T * 2.0`` keeps
  ``a``'s layout and would move nothing;
* ``gather_blend_rowmajor`` / ``gather_blend_T``: a 32-wide gather blended
  in row-major layout or through a transpose;
* ``cuda_vmem_take``: ``gather_rowsum(strategy="coop")``, the Hopper
  counterpart of ``pallas_gather`` (``tools/probe_gather.py:104``);
* ``cuda_vmem_looprow``: ``gather_rowsum(strategy="rowloop")``, of
  ``pallas_loop`` (``tools/probe_gather.py:133``).

Prints one JSON line: each time under ``<name>_ms``, and ``card`` (the
``nvidia-smi`` name and power limit).  A kernel that fails to build or
launch raises; nothing is recorded in its place.  With no CUDA device it
exits 2.
"""

import json

import numpy as np
import torch

from grmonty_tpu_torch.tools import card, require_cuda, timed_ms
from grmonty_tpu_torch.transport import hot_kernels

N = Z = 65536
WIDTHS = (8, 16, 32, 64, 128, 216, 256)


def four_neighbours(t, i, z):
    """Four narrow gathers, a cell and its neighbours (the design before
    the corner table), summed."""
    i = i.long()
    return (t[i] + t[i + 1] + t[torch.clamp(i + 256, max=z - 1)]
            + t[torch.clamp(i + 257, max=z - 1)]).sum(dim=1)


def relayout(a):
    """(N, w) to (w, N) with the data moved, then the sum of each row."""
    return (a.T.contiguous() * 2.0).sum(dim=1)


def _blend(rows):
    return rows[:, 0:8] * 0.3 + rows[:, 8:16] * 0.2 + rows[:, 16:24] * 0.4 + rows[:, 24:32] * 0.1


def gather_blend_rowmajor(t, i):
    """Gather 32-wide rows and blend their four 8-wide parts, in (N, 8)."""
    c = torch.linspace(0.1, 0.9, 8, dtype=torch.float32, device=t.device)
    return _blend(t[i.long()]) @ c


def gather_blend_T(t, i):
    """The same blend, then through an (8, N) transpose."""
    p = _blend(t[i.long()]).T.contiguous()
    return p[0] + p[1] * p[2]


def experiments(device, n, z, widths, gen):
    """The probe's inputs and its experiments on ``device``.

    Indices uniform in [0, z - 2), tables float32 normal at each of
    ``widths`` and at 8, 32 and 216 (the fixed-width experiments), and two
    (n, 8) and (n, 32) matrices for the relayouts, all drawn from ``gen``
    (a numpy Generator).  Returns (data, fns): the numpy
    inputs by name (``idx``, ``idx_sorted``, ``table<w>``, ``m8``, ``m32``),
    and the zero-argument callables by the name of their key without
    ``_ms``."""
    idx = gen.integers(0, z - 2, n).astype(np.int32)
    data = {"idx": idx, "idx_sorted": np.sort(idx)}
    for w in sorted(set(widths) | {8, 32, 216}):
        data[f"table{w}"] = gen.standard_normal((z, w)).astype(np.float32)
    data["m8"] = gen.standard_normal((n, 8)).astype(np.float32)
    data["m32"] = gen.standard_normal((n, 32)).astype(np.float32)
    t = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    i, tab32 = t["idx"], t["table32"]
    rowsum = hot_kernels.plain_rowsum
    fns = {f"torch_gather_w{w}": (lambda w=w: rowsum(t[f"table{w}"], i)) for w in widths}
    fns.update({
        "torch_gather_w216_n32k": lambda: rowsum(t["table216"], i[: n // 2]),
        "torch_gather_w32_sorted": lambda: rowsum(tab32, t["idx_sorted"]),
        "torch_gather_4x_w8": lambda: four_neighbours(t["table8"], i, z),
        "relayout_n8_T": lambda: relayout(t["m8"]),
        "relayout_n32_T": lambda: relayout(t["m32"]),
        "gather_blend_rowmajor": lambda: gather_blend_rowmajor(tab32, i),
        "gather_blend_T": lambda: gather_blend_T(tab32, i),
        "cuda_vmem_take": lambda: hot_kernels.gather_rowsum(tab32, i, "coop"),
        "cuda_vmem_looprow": lambda: hot_kernels.gather_rowsum(tab32, i, "rowloop"),
    })
    return data, fns


def measure():
    """The probe's JSON object, measured on the card."""
    _, fns = experiments(torch.device("cuda"), N, Z, WIDTHS, np.random.default_rng(0))
    results = {f"{name}_ms": timed_ms(fn) for name, fn in fns.items()}
    results["card"] = card()
    return results


def main():
    require_cuda("probe_gather")
    print(json.dumps(measure()))


if __name__ == "__main__":
    main()
