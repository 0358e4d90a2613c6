"""Monte Carlo samplers for Compton scattering, with masked rejection loops.

Port of the deferring samplers of ``grmonty_tpu/ops/proba.py`` (reference
``proba.cpp:30-215``).  Each sampler draws from a draw source
(:mod:`grmonty_tpu_torch.ops.draws`): a ``torch.Generator``, whole batches
as it always has, or ``draws.PhiloxDraws``, the counter-based numbers of
the event kernel ``csrc/scatter_event.cu``.  A lane that does not accept
within its round cap reports ``ok=False`` and the engine defers its
scatter event to the next periodic phase (a fresh draw), so the caps
truncate nothing.  ``force`` lanes take their final draw at the cap (the
anti-stall escalation).

The loops leave as soon as every lane accepted.  That test reads the device,
so it runs every ``_CHECK_EVERY`` rounds; the rounds in between are no-ops
for accepted lanes, so the result is the same as checking every round.
Each loop records on its draw source the rounds each lane ran (the round
it accepted in, else the cap): ``src.rounds["electron"]``,
``["klein_nishina"]``, ``["thomson"]``.
"""

import math

import torch

from grmonty_tpu_torch.ops import draws

PI = math.pi

_ELECTRON_CAP_DEFER = 16
_KN_CAP_DEFER = 128
_THOMSON_CAP = 16
_CHECK_EVERY = 4


def _done(accepted, it):
    return (it + 1) % _CHECK_EVERY == 0 and bool(accepted.all())


def _mu_from(x1, beta_e):
    """The pitch-angle cosine weighted by relative flux of the uniform
    ``x1`` (proba.cpp:168-172)."""
    det = 1.0 + 2.0 * beta_e + beta_e * beta_e - 4.0 * beta_e * x1
    return (1.0 - torch.sqrt(det)) / (beta_e + 1e-30)


def _rand_dir_from(uz, uphi):
    """The isotropic unit vector of the uniforms (``uz``, ``uphi``)
    (proba.cpp:202-210)."""
    z = uz * 2.0 - 1.0
    phi = uphi * 2.0 * PI
    s = torch.sqrt(1.0 - z * z)
    return s * torch.cos(phi), s * torch.sin(phi), z


def _sigma_kn_total(k_eff):
    """Total KN cross-section / sigma_T at photon energy k_eff (proba.cpp:50-55)."""
    k = torch.clamp(k_eff, min=1e-30)
    full = (3.0 / (4.0 * k * k)) * (
        2.0
        + k * k * (1.0 + k) / ((1.0 + 2.0 * k) * (1.0 + 2.0 * k))
        + (k * k - 2.0 * k - 2.0) / (2.0 * k) * torch.log1p(2.0 * k)
    )
    return torch.where(k_eff < 1.0e-3, 1.0 - 2.0 * k_eff, full)


def _sum_sq(nrm, dof, ordered):
    """The sum of the first ``dof`` squared normals of ``nrm`` (6, N): by
    ``torch.sum``, or (``ordered``) one term after another, as the kernel
    adds them."""
    iota = torch.arange(6, device=nrm.device)[:, None]
    terms = torch.where(iota < dof[None, :], nrm * nrm, 0.0)
    if not ordered:
        return torch.sum(terms, dim=0)
    total = terms[0]
    for i in range(1, 6):
        total = total + terms[i]
    return total


def sample_electron_distr_p_c(gen, k, theta_e, force=None, cap=_ELECTRON_CAP_DEFER,
                              live=None):
    """Thermal electron 4-momentum weighted by the KN cross-section at the
    boosted photon energy (proba.cpp:30-112), as one flat rejection loop:
    proposal (chi^2-mixture y, flux-weighted mu), acceptance the product of
    the Maxwell-Juettner correction and the KN test.  ``gen``: a draw
    source (a ``torch.Generator`` or ``draws.PhiloxDraws``); ``k``: 4-tuple
    of tetrad-frame components; ``live``: the lanes whose acceptance tests
    count in the draw source's margins (all when None).  Returns
    ``(p_tuple, ok)``."""
    src = draws.as_draws(gen)
    k0c, k1c, k2c, k3c = k
    if force is None:
        force = torch.zeros_like(theta_e, dtype=torch.bool)

    pi_3 = math.sqrt(PI) / 4.0 * torch.ones_like(theta_e)
    pi_4 = torch.sqrt(0.5 * theta_e) / 2.0
    pi_5 = 3.0 * math.sqrt(PI) * theta_e / 8.0
    pi_6 = theta_e * torch.sqrt(0.5 * theta_e)
    s3 = pi_3 + pi_4 + pi_5 + pi_6
    c1 = pi_3 / s3
    c2 = (pi_3 + pi_4) / s3
    c3 = (pi_3 + pi_4 + pi_5) / s3

    gamma = torch.ones_like(theta_e)
    beta = torch.zeros_like(theta_e)
    mu = torch.zeros_like(theta_e)
    accepted = torch.zeros_like(theta_e, dtype=torch.bool)
    rounds = torch.full_like(theta_e, cap, dtype=torch.int32)
    for it in range(cap):
        x1, nrm, u_y, u_mu, u_kn = src.electron_round(it, theta_e)
        dof = torch.where(x1 < c1, 3, torch.where(x1 < c2, 4, torch.where(x1 < c3, 5, 6)))
        y_new = torch.sqrt(_sum_sq(nrm, dof, src.ordered_sum) / 2.0)

        num = torch.sqrt(1.0 + 0.5 * theta_e * y_new * y_new)
        den = 1.0 + y_new * torch.sqrt(0.5 * theta_e)
        accept_y = u_y < num / den

        g_new = y_new * y_new * theta_e + 1.0
        b_new = torch.sqrt(1.0 - 1.0 / (g_new * g_new))
        mu_new = torch.clamp(_mu_from(u_mu, b_new), -1.0, 1.0)

        k_eff = g_new * (1.0 - b_new * mu_new) * k0c
        sigma = _sigma_kn_total(k_eff)
        accept_kn = u_kn < sigma

        noted = ~accepted if live is None else live & ~accepted
        for thr in (c1, c2, c3):
            src.gap(x1, thr, noted)
        src.gap(u_y, num / den, noted)
        src.gap(u_kn, sigma, noted)
        take = ((accept_y & accept_kn) | ((it + 1 >= cap) & force)) & ~accepted
        gamma = torch.where(take, g_new, gamma)
        beta = torch.where(take, b_new, beta)
        mu = torch.where(take, mu_new, mu)
        rounds = torch.where(take, it + 1, rounds)
        accepted = accepted | take
        if _done(accepted, it):
            break
    src.rounds["electron"] = rounds

    c_th, s_th = mu, torch.sqrt(1.0 - mu * mu)
    u_phi, u_z, u_dphi = src.direction(draws.ELECTRON_DIR, theta_e)
    phi = u_phi * 2.0 * PI
    dx, dy, dz = _dir_about_axis_c((k1c, k2c, k3c), _rand_dir_from(u_z, u_dphi), c_th, s_th,
                                   phi)
    gb = gamma * beta
    return (gamma, gb * dx, gb * dy, gb * dz), accepted


def _dir_about_axis_c(axis, n0, c_th, s_th, phi):
    """Unit vector at polar angle (c_th, s_th, phi) about ``axis`` with the
    azimuthal frame of the random direction ``n0`` (proba.cpp:67-107)."""
    ax, ay, az = axis
    inv = 1.0 / torch.sqrt(ax * ax + ay * ay + az * az + 1e-300)
    v0x, v0y, v0z = ax * inv, ay * inv, az * inv

    n0x, n0y, n0z = n0
    ndv = n0x * v0x + n0y * v0y + n0z * v0z
    v1x, v1y, v1z = n0x - ndv * v0x, n0y - ndv * v0y, n0z - ndv * v0z
    inv1 = 1.0 / torch.sqrt(v1x * v1x + v1y * v1y + v1z * v1z + 1e-300)
    v1x, v1y, v1z = v1x * inv1, v1y * inv1, v1z * inv1
    v2x = v0y * v1z - v0z * v1y
    v2y = v0z * v1x - v0x * v1z
    v2z = v0x * v1y - v0y * v1x

    cp, sp = torch.cos(phi), torch.sin(phi)
    dx = c_th * v0x + s_th * (cp * v1x + sp * v2x)
    dy = c_th * v0y + s_th * (cp * v1y + sp * v2y)
    dz = c_th * v0z + s_th * (cp * v1z + sp * v2z)
    return dx, dy, dz


def klein_nishina(a, ap):
    """KN differential cross-section kernel (proba.cpp:212-215)."""
    ch = 1.0 + 1.0 / a - 1.0 / ap
    return (a / ap + ap / a - 1.0 + ch * ch) / (a * a)


def sample_klein_nishina_c(gen, k0, force=None, cap=_KN_CAP_DEFER, live=None):
    """Scattered photon energy from the KN distribution by rejection over
    k0p (proba.cpp:174-189).  ``live``: the lanes whose tests count in the
    draw source's margins (all when None).  Returns ``(k0p, ok)``."""
    src = draws.as_draws(gen)
    if force is None:
        force = torch.zeros_like(k0, dtype=torch.bool)
    k0pmin = k0 / (1.0 + 2.0 * k0)
    k0pmax = k0
    envelope = 2.0 * (1.0 + 2.0 * k0 + 2.0 * k0 * k0) / (k0 * k0 * (1.0 + 2.0 * k0))

    k0p = k0pmax
    accepted = torch.zeros_like(k0, dtype=torch.bool)
    rounds = torch.full_like(k0, cap, dtype=torch.int32)
    for it in range(cap):
        u_t, u_x = src.pair_round(draws.KLEIN_NISHINA, it, k0)
        tent = k0pmin + (k0pmax - k0pmin) * u_t
        x1 = envelope * u_x
        kn = klein_nishina(k0, tent)
        accept = x1 < kn
        src.gap(x1, kn, ~accepted if live is None else live & ~accepted)
        take = (accept | ((it + 1 >= cap) & force)) & ~accepted
        k0p = torch.where(take, tent, k0p)
        rounds = torch.where(take, it + 1, rounds)
        accepted = accepted | take
        if _done(accepted, it):
            break
    src.rounds["klein_nishina"] = rounds
    return k0p, accepted


def sample_thomson(gen, like, cap=_THOMSON_CAP, live=None):
    """Scattering cosine from the Thomson phase function (proba.cpp:191-200);
    a lane that never accepts keeps 0.  ``live`` as in
    :func:`sample_klein_nishina_c`."""
    src = draws.as_draws(gen)
    c_th = torch.zeros_like(like)
    accepted = torch.zeros_like(like, dtype=torch.bool)
    rounds = torch.full_like(like, cap, dtype=torch.int32)
    for it in range(cap):
        u1, u2 = src.pair_round(draws.THOMSON, it, like)
        x1 = 2.0 * u1 - 1.0
        x2 = (3.0 / 4.0) * u2
        thr = (3.0 / 8.0) * (1.0 + x1 * x1)
        accept = x2 < thr
        src.gap(x2, thr, ~accepted if live is None else live & ~accepted)
        c_th = torch.where(accept & ~accepted, x1, c_th)
        rounds = torch.where(accept & ~accepted, it + 1, rounds)
        accepted = accepted | accept
        if _done(accepted, it):
            break
    src.rounds["thomson"] = rounds
    return c_th
