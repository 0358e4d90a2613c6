"""The engine profiles: the shipped one, and reference semantics.

Port of ``grmonty_tpu/transport/profiles.py`` with the same values.  The
JAX profile's layout knobs (``mxu_extract``, ``gather_split``,
``hot_halves``, ``pallas_*``) tuned XLA and Mosaic on the TPU and have no
counterpart here; ``derived_fluid`` is not a knob either: the shipped
profile's hot step reads the derived table, reference semantics the raw
one.  The JAX ``ref_mode`` is one switch, ``EngineConfig.reference``, with
the widths of :func:`reference_config`.
"""

import torch

from grmonty_tpu_torch.transport import engine


def bench_config(pool=65536, dtype=torch.float32, stall_steps=150000):
    """The accelerated profile's widths at ``pool`` lanes.  Its physics
    (error-proportional step control with growth up to 8x, detached
    scatter events, light refill phases every 4 hot iterations, the
    windowed bias feedback) is the engine's: the ``EngineConfig`` defaults
    and the constants of ``engine``."""
    return engine.EngineConfig(
        n_pool=pool, m_period=16, sec_cap=2 * pool, stall_steps=stall_steps,
        dtype=dtype, ev_k=min(pool, 16384), refill_k=min(pool, 32768),
        refill_period=4, light_k=12288, grow_cap=8.0,
    )


def bench_sim_kwargs(pool):
    """Driver-level pieces of the shipped profile: the emission wave size,
    the pilot's 8,192 photons, the pool-full wave hand-off and the
    overrides of the tail cascade (the emission order is always strided)."""
    return dict(emit_chunk=1 << 20, warmup=8192, wave_tail_exit=pool,
                tail_grow_cap=16.0, tail_stall_steps=50000)


def reference_config(pool=65536, dtype=torch.float32, stall_steps=150000):
    """Reference semantics at ``pool`` lanes, with the JAX
    ``bench_config(ref_mode=True)`` widths: the full phase every 32 hot
    iterations and no light phases, events and refills ``min(pool,
    16384)`` wide, no step growth (the ladder capped at 1)."""
    return engine.EngineConfig(
        n_pool=pool, m_period=32, sec_cap=2 * pool, stall_steps=stall_steps,
        dtype=dtype, ev_k=min(pool, 16384), refill_k=0, refill_period=0, light_k=0,
        grow_cap=1.0, reference=True,
    )


def reference_sim_kwargs(pool):
    """Driver-level pieces of reference semantics: the emission wave size,
    the pilot's 8,192 photons (the JAX ``bench_sim_kwargs`` gives both
    semantics the same pilot) and the pool-full wave hand-off; the tail
    cascade keeps the wave engine's step cap and growth (no overrides)."""
    return dict(emit_chunk=1 << 20, warmup=8192, wave_tail_exit=pool)
