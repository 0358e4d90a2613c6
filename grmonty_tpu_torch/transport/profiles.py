"""The shipped engine profile.

Port of ``grmonty_tpu/transport/profiles.py`` with the same values.  The
JAX profile's layout knobs (``mxu_extract``, ``gather_split``,
``hot_halves``, ``pallas_*``) tuned XLA and Mosaic on the TPU and have no
counterpart here; the hot step always reads the derived-fluid table, so
``derived_fluid`` is not a knob either.
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
    the pool-full wave hand-off and the overrides of the final drain (the
    emission order is always strided)."""
    return dict(emit_chunk=1 << 20, wave_tail_exit=pool,
                tail_grow_cap=16.0, tail_stall_steps=50000)
