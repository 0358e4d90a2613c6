"""The port's gather probes, the counterparts of the JAX package's
``tools/probe_gather.py``, ``tools/probe_pallas_gather.py`` and
``tools/probe_vmem_gather.py`` under the same names.  Each times gather
strategies on the card and prints one JSON line::

    python -m grmonty_tpu_torch.tools.probe_gather
    python -m grmonty_tpu_torch.tools.probe_pallas_gather   # PROBE_N PROBE_Z PROBE_BLK
    python -m grmonty_tpu_torch.tools.probe_vmem_gather     # PROBE_N PROBE_Z PROBE_W

Each module's ``experiments`` builds the probe's inputs from a numpy seed
and returns them with the named callables; on ``device="cpu"`` the kernel
wrappers take their plain versions, which is how the tests hold the probes
against the JAX ones.  ``main`` runs only on the card: with no CUDA device
it exits 2.  The timers below are shared by the three.
"""

import subprocess
import sys

import torch


def require_cuda(name):
    """Exit 2 with a message when there is no CUDA device: a probe's numbers
    are the card's, and it offers no CPU run."""
    if not torch.cuda.is_available():
        print(f"{name}: no CUDA device; this probe runs only on the card", file=sys.stderr)
        sys.exit(2)


def card():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    return out.strip().splitlines()[0]


def timed_ms(fn, reps=5):
    """The least milliseconds of ``reps`` single calls of ``fn`` after a
    warm-up, by CUDA events around each call on an idle stream: the host's
    launch cost is part of the time, as JAX's dispatch was part of the JAX
    probe's."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        ts.append(t0.elapsed_time(t1))
    return min(ts)


def link_fn(op, base, z):
    """One link of the JAX probes' chain: indices that depend on the carry
    (so that no link can be hoisted), the op, and the carry nudged by its
    row sums: ``acc + s * 1e-20`` with ``s`` the op's result (its row sums
    where it returns rows)."""
    def link(acc):
        s = op(torch.clamp(base + (acc.to(torch.int32) & 1), max=z - 1))
        if s.dim() == 2:
            s = s.sum(dim=1)
        return acc + s * 1e-20
    return link


def chain_ms(op, base, z, short, long, reps=5):
    """Marginal milliseconds per link: chains of ``short`` and ``long``
    links of ``link_fn(op, base, z)`` are captured into CUDA graphs, each is
    replayed ``reps`` times (the least time kept), and the difference is
    divided by ``long - short``; the counterpart of the JAX probes' two
    ``fori_loop`` lengths.  A link holds the op and its small glue kernels
    (the index nudge, the row sum of a copy, the carry update), so the time
    bounds the op's own from above.  A capture that fails raises."""
    link = link_fn(op, base, z)
    acc0 = torch.zeros(base.shape[0], dtype=torch.float32, device=base.device)
    link(acc0)  # load every kernel before the capture
    torch.cuda.synchronize()

    def best(links):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            acc = acc0
            for _ in range(links):
                acc = link(acc)
        ts = []
        for _ in range(reps + 1):  # the first replay warms up
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            g.replay()
            t1.record()
            t1.synchronize()
            ts.append(t0.elapsed_time(t1))
        del g
        return min(ts[1:])

    t_short, t_long = best(short), best(long)
    torch.cuda.empty_cache()
    return (t_long - t_short) / (long - short)
