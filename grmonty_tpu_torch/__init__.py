"""grmonty_tpu_torch — the PyTorch/CUDA port of ``grmonty_tpu``.

The same general-relativistic Monte Carlo transport as ``grmonty_tpu``,
written against PyTorch so it runs on an NVIDIA H100.  The layout mirrors
the JAX package module for module, so each function's counterpart is found
under the same name:

    models/     HARM dump I/O (the native parser, ``csrc/harmio.cpp``),
                units, the synthetic torus writer (numpy)
    ops/        geometry, opacities, fluid tables, tetrads, samplers,
                emission and spectrum binning (torch on tensors); the
                physics tables' builders (numpy)
    transport/  the engine (plain torch), the hand-written CUDA kernels
                (``hot_kernels`` + ``csrc/*.cu``), the native scalar
                tracker's binding (``oracle_native`` + ``csrc/oracle.cpp``),
                the profiles, the ``Simulation`` driver (pilot, waves,
                tail cascade, checkpoints) and the Python scalar oracle
                (``cpu_reference``)
    parallel/   ``ShardedSimulation``: the plan over ``torch.distributed``
                ranks (NCCL on the cards, gloo on the CPU)
    utils/      the physics tables' file cache and their Chebyshev fits;
                logging
    convert.py  JAX-package objects (as numpy) -> the port's state
    cli.py      the command line (``python -m grmonty_tpu_torch``)
    plot_spectrum.py  a spectrum file's parser and plot (matplotlib, only
                there)

The package imports torch, numpy and scipy only; it never imports JAX or
``grmonty_tpu``.  Every function takes an explicit ``device`` or works on
the device of its tensors; no autograd is used anywhere.
"""

__version__ = "0.1.0"
