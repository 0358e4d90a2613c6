"""Compton scattering event kinematics over a batch of photons.

Port of the component layer of ``grmonty_tpu/ops/scattering.py``
(reference ``harm_model.cpp``: ``scatter_super_photon`` :1071-1145,
``sample_scattered_photon`` :1147-1215).  All lanes compute; the masks tell
the caller which results to use.  The samplers draw from a draw source
(:mod:`grmonty_tpu_torch.ops.draws`): a ``torch.Generator`` or
``draws.PhiloxDraws``, the numbers of the event kernel
``csrc/scatter_event.cu``, whose card entry point is
``hot_kernels.scatter_event``.
"""

import math
import typing

import torch

from grmonty_tpu_torch.ops import draws, proba, tetrads

PI = math.pi


class ScatterResultC(typing.NamedTuple):
    parent_die: torch.Tensor  # (N,) bool
    made: torch.Tensor  # (N,) bool: a valid secondary was produced
    k_sec: tuple  # 4x (N,) coordinate-frame secondary wave vector
    e_sec: torch.Tensor
    l_sec: torch.Tensor
    sampled: torch.Tensor  # (N,) bool: every sampler accepted; lanes with
    #   sampled=False are deferred to the next periodic phase
    rounds_el: torch.Tensor = None  # (N,) int32: the electron loop's rounds
    rounds_sc: torch.Tensor = None  # (N,) int32: the Klein-Nishina loop's
    #   rounds where the boosted photon is hot (ke0 > 1e-4), else Thomson's;
    #   both 0 on guarded lanes (inactive, doomed parent or invalid frame)


class ChainResult(typing.NamedTuple):
    """The sampling chain of one scatter in the tetrad frame."""
    p_el: tuple  # 4x (N,) electron 4-momentum
    k_tet_p: tuple  # 4x (N,) scattered photon's tetrad wave vector
    ok_el: torch.Tensor  # (N,) bool
    ok_kn: torch.Tensor  # (N,) bool
    rounds_el: torch.Tensor = None
    rounds_sc: torch.Tensor = None


def sample_scattered_photon_c(gen, k_tet, p, force=None, live=None):
    """Scattered photon's tetrad wave vector given incident ``k_tet`` and
    electron ``p`` (4-tuples).  Returns ``(k_tet_p, ok)``: ok reports KN
    acceptance within the deferring cap (cold Thomson lanes always ok).
    ``gen``: a draw source; ``live``: the lanes whose acceptance tests
    count in its margins (all when None).  Records on the draw source the
    rounds of the loop each lane uses (``rounds["scatter"]``)."""
    src = draws.as_draws(gen)
    ke = tetrads.boost_c(k_tet, p)
    ke0 = ke[0]
    hot = ke0 > 1.0e-4
    live = torch.ones_like(hot) if live is None else live
    src.gap(ke0, torch.full_like(ke0, 1.0e-4), live)

    k0_safe = torch.clamp(ke0, min=1.0e-4)
    k0p_kn, ok_kn = proba.sample_klein_nishina_c(src, k0_safe, force=force, live=live & hot)
    c_th_kn = 1.0 - 1.0 / k0p_kn + 1.0 / k0_safe
    c_th_t = proba.sample_thomson(src, ke0, cap=proba._THOMSON_CAP, live=live & ~hot)
    src.rounds["scatter"] = torch.where(hot, src.rounds["klein_nishina"],
                                        src.rounds["thomson"])

    k0p = torch.where(hot, k0p_kn, ke0)
    c_th = torch.where(hot, c_th_kn, c_th_t)
    s_th = torch.sqrt(torch.abs(1.0 - c_th * c_th))

    u_phi, u_z, u_dphi = src.direction(draws.SCATTER_DIR, ke0)
    phi = 2.0 * PI * u_phi
    dx, dy, dz = proba._dir_about_axis_c((ke[1], ke[2], ke[3]),
                                         proba._rand_dir_from(u_z, u_dphi), c_th, s_th, phi)
    kpe = (k0p, k0p * dx, k0p * dy, k0p * dz)

    p_rev = (p[0], -p[1], -p[2], -p[3])
    return tetrads.boost_c(kpe, p_rev), ok_kn | ~hot


def scatter_chain_c(gen, k_tet, theta_e, force=None):
    """The electron draw, then the scattered photon, of tetrad-frame wave
    vectors ``k_tet`` off electrons at ``theta_e`` (as the scatter-chain
    probe samples them): a :class:`ChainResult`, with the rounds each lane
    ran."""
    src = draws.as_draws(gen)
    p_el, ok_el = proba.sample_electron_distr_p_c(src, k_tet, theta_e, force=force)
    k_tet_p, ok_kn = sample_scattered_photon_c(src, k_tet, p_el, force=force)
    return ChainResult(p_el, k_tet_p, ok_el, ok_kn, src.rounds["electron"],
                       src.rounds["scatter"])


def scatter_event_c(gen, k_coord, fl, g7, b_unit, active=None, force=None):
    """Full scattering event (harm_model.cpp:1071-1145).

    ``k_coord``: 4-tuple of wave-vector components; ``fl``: FluidC at the
    event; ``g7``: covariant metric tuple.  ``active`` masks the lanes at an
    event: the others get placeholder sampler inputs that accept at once.
    ``gen``: a draw source (``torch.Generator`` or ``draws.PhiloxDraws``).
    """
    src = draws.as_draws(gen)
    k0 = k_coord[0]
    parent_die = ((k0 > 1.0e5) | (k0 < 0.0) | torch.isnan(k0)
                  | torch.isnan(k_coord[1]) | torch.isnan(k_coord[3]))

    # Field-direction trial vector; x1 axis when unmagnetised (:1083-1094).
    b_code = fl.b / b_unit
    mag = fl.b > 0.0
    inv_b = 1.0 / torch.clamp(b_code, min=1e-30)
    zero = torch.zeros_like(fl.b)
    b_hat = (torch.where(mag, fl.b_con[0] * inv_b, zero),
             torch.where(mag, fl.b_con[1] * inv_b, torch.ones_like(fl.b)),
             torch.where(mag, fl.b_con[2] * inv_b, zero),
             torch.where(mag, fl.b_con[3] * inv_b, zero))

    e_con, e_cov = tetrads.make_tetrad_c(fl.u_con, b_hat, g7)
    k_tet = tetrads.coordinate_to_tetrad_c(e_cov, k_coord)

    kt0 = k_tet[0]
    invalid_frame = (kt0 > 1.0e5) | (kt0 < 0.0) | torch.isnan(k_tet[1])

    guard = invalid_frame | parent_die
    if active is not None:
        guard = guard | ~active
    small = torch.full_like(kt0, 1.0e-6)
    k_tet_safe = (torch.where(guard, small, k_tet[0]),
                  torch.where(guard, small, k_tet[1]),
                  torch.where(guard, zero, k_tet[2]),
                  torch.where(guard, zero, k_tet[3]))
    theta_safe = torch.clamp(fl.theta_e, min=1e-4)
    # the guarded lanes' placeholder draws decide nothing (the kernel skips
    # them): their tests do not count in the draw source's margins
    p_el, ok_el = proba.sample_electron_distr_p_c(src, k_tet_safe, theta_safe, force=force,
                                                  live=~guard)
    k_tet_p, ok_kn = sample_scattered_photon_c(src, k_tet_safe, p_el, force=force, live=~guard)

    k_sec = tetrads.tetrad_to_coordinate_c(e_con, k_tet_p)
    sec_w_zero = torch.isnan(k_sec[1])

    # Conserved quantities from the dual basis, time sign flipped (:1123-1129).
    tmp = tetrads.tetrad_to_coordinate_c(
        e_cov, (-k_tet_p[0], k_tet_p[1], k_tet_p[2], k_tet_p[3]))
    sampled = (ok_el & ok_kn) | guard
    made = ~(parent_die | invalid_frame | sec_w_zero)
    no = torch.zeros_like(src.rounds["electron"])
    return ScatterResultC(parent_die, made, k_sec, -tmp[0], tmp[3], sampled,
                          torch.where(guard, no, src.rounds["electron"]),
                          torch.where(guard, no, src.rounds["scatter"]))
