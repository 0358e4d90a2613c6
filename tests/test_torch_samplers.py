"""The port's Monte Carlo samplers against the JAX package's, in distribution.

The two draw from different generators (torch.Generator vs threefry), so
they are compared by statistics of large samples, float64 on the CPU:
the mean to 5 combined standard errors, and the 0.1% / 99.9% quantiles by
rank: each side's quantile must lie between the other side's quantiles at
p -/+ 5 sqrt(2 p (1 - p) / n) (distribution-free).  Acceptance fractions
agree to 5 binomial standard errors.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from grmonty_tpu.models import torus as jtorus
from grmonty_tpu.ops import emission as jem
from grmonty_tpu.ops import proba as jproba
from grmonty_tpu.ops import scattering as jsc
from grmonty_tpu.transport import driver as jdriver
from grmonty_tpu.transport import engine as jengine
from grmonty_tpu_torch.ops import emission, proba, scattering
from grmonty_tpu_torch.utils import tables

N = 40000
Z = 5.0


def gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def same_distribution(a, b, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.size > 1000 and b.size > 1000, what
    se = math.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) <= Z * se + 1e-12 * abs(a.mean()), (
        f"{what}: means {a.mean()} vs {b.mean()} (se {se})")
    for p in (0.001, 0.999):
        dp = Z * math.sqrt(2.0 * p * (1.0 - p) / min(a.size, b.size))
        for x, y in ((a, b), (b, a)):
            q = np.quantile(y, p)
            lo, hi = np.quantile(x, max(p - dp, 0.0)), np.quantile(x, min(p + dp, 1.0))
            assert lo <= q <= hi, f"{what}: q{p} {q} outside [{lo}, {hi}]"


def same_fraction(fa, fb, n, what):
    p = 0.5 * (fa + fb)
    se = math.sqrt(2.0 * p * (1.0 - p) / n) + 1e-12
    assert abs(fa - fb) <= Z * se, f"{what}: fractions {fa} vs {fb}"


@pytest.mark.parametrize("theta_e", [0.5, 3.0, 20.0])
@pytest.mark.parametrize("k0", [1e-6, 1e-2])
def test_electron_sampler_matches_jax(theta_e, k0):
    te = np.full(N, theta_e)
    k = (np.full(N, k0), np.full(N, k0), np.zeros(N), np.zeros(N))
    pj, okj = jproba.sample_electron_distr_p_c(
        random.PRNGKey(1), tuple(map(jnp.asarray, k)), jnp.asarray(te))
    pt, okt = proba.sample_electron_distr_p_c(
        gen(1), tuple(map(torch.as_tensor, k)), torch.as_tensor(te))
    okj, okt = np.asarray(okj), okt.numpy()
    same_fraction(okj.mean(), okt.mean(), N, "electron acceptance")
    gj, gt = np.asarray(pj[0])[okj], pt[0].numpy()[okt]
    same_distribution(gj, gt, f"gamma at theta_e={theta_e}")
    # the spatial momentum along the photon direction (flux weighting)
    same_distribution(np.asarray(pj[1])[okj], pt[1].numpy()[okt], "p_x")
    assert np.allclose(pt[0].numpy() ** 2 - sum(c.numpy() ** 2 for c in pt[1:]), 1.0)


@pytest.mark.parametrize("k0", [1e-3, 0.1, 1.0, 10.0])
def test_klein_nishina_sampler_matches_jax(k0):
    k = np.full(N, k0)
    kj, okj = jproba.sample_klein_nishina_c(random.PRNGKey(2), jnp.asarray(k))
    kt, okt = proba.sample_klein_nishina_c(gen(2), torch.as_tensor(k))
    okj, okt = np.asarray(okj), okt.numpy()
    same_fraction(okj.mean(), okt.mean(), N, "KN acceptance")
    same_distribution(np.asarray(kj)[okj] / k0, kt.numpy()[okt] / k0, f"k0p/k0 at {k0}")


def test_thomson_sampler_matches_jax():
    cj = np.asarray(jproba.sample_thomson(random.PRNGKey(3), (N,), jnp.float64,
                                          cap=jproba._THOMSON_CAP))
    ct = proba.sample_thomson(gen(3), torch.zeros(N, dtype=torch.float64)).numpy()
    same_distribution(cj, ct, "thomson cos")
    same_distribution(cj * cj, ct * ct, "thomson cos^2")


def test_scattered_photon_matches_jax():
    rng = np.random.default_rng(4)
    k_tet = (np.full(N, 0.05), np.full(N, 0.05), np.zeros(N), np.zeros(N))
    g = 1.0 + rng.exponential(2.0, N)
    b = np.sqrt(1.0 - 1.0 / g**2)
    p = (g, g * b, np.zeros(N), np.zeros(N))
    kj, okj = jsc.sample_scattered_photon_c(random.PRNGKey(5), tuple(map(jnp.asarray, k_tet)),
                                            tuple(map(jnp.asarray, p)))
    kt, okt = scattering.sample_scattered_photon_c(gen(5), tuple(map(torch.as_tensor, k_tet)),
                                                   tuple(map(torch.as_tensor, p)))
    okj, okt = np.asarray(okj), okt.numpy()
    same_fraction(okj.mean(), okt.mean(), N, "scattered photon acceptance")
    same_distribution(np.asarray(kj[0])[okj], kt[0].numpy()[okt], "scattered energy")
    same_distribution(np.asarray(kj[1])[okj] / np.asarray(kj[0])[okj],
                      kt[1].numpy()[okt] / kt[0].numpy()[okt], "scattered cos")


@pytest.fixture(scope="module")
def emission_tables(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dump") / "torus")
    jtorus.write_torus_dump(path, n1=64, n2=32)
    cfg = jengine.EngineConfig(n_pool=256, m_period=8, sec_cap=1024)
    h = jdriver.Simulation(path, photon_n=2000, mass_unit=4e19, config=cfg,
                           cdf_sampler=True)._host
    jt = jem.SamplerTables(zone_map=jnp.asarray(h["nu_zone_map"]),
                           lnrho=jnp.asarray(h["nu_lnrho"]), cdf=jnp.asarray(h["nu_cdf"]),
                           theta_q=jnp.asarray(tables.theta_quantiles()))
    pt = emission.SamplerTables(
        zone_map=torch.as_tensor(np.array(h["nu_zone_map"]), dtype=torch.int64),
        lnrho=torch.as_tensor(np.array(h["nu_lnrho"])), cdf=torch.as_tensor(np.array(h["nu_cdf"])),
        theta_q=torch.as_tensor(tables.theta_quantiles()))
    return h, jt, pt


def test_frequency_cdf_sampler_matches_jax(emission_tables):
    h, jt, pt = emission_tables
    rows = np.unique(np.asarray(h["nu_zone_map"]).ravel())
    rows = rows[rows >= 0]
    for r in rows[[0, len(rows) // 2, -1]]:
        row = np.full(N, r)
        _, nuj, lwj, _ = jem.sample_nu_cdf(random.PRNGKey(6), jnp.asarray(row), jt,
                                           jnp.asarray(h["weights"]), jnp.float64)
        nut, lwt, alive = emission.sample_nu_cdf(gen(6), torch.as_tensor(row), pt,
                                                 torch.as_tensor(np.array(h["weights"])),
                                                 torch.float64)
        assert bool(alive.all())
        same_distribution(np.log(np.asarray(nuj)), np.log(nut.numpy()), f"ln nu, row {r}")
        same_distribution(np.asarray(lwj), lwt.numpy(), f"ln w, row {r}")


@pytest.mark.parametrize("x90", [1e-3, 1.0, 1e3])
def test_direction_cdf_sampler_matches_jax(emission_tables, x90):
    _, jt, pt = emission_tables
    theta_e, b = np.full(N, 5.0), np.full(N, 30.0)
    nu_s90 = (2.0 / 9.0) * (4.80320680e-10 * 30.0 / (2.0 * math.pi * 9.1093826e-28
                                                       * 2.99792458e10)) * 25.0
    nu = np.full(N, x90 * nu_s90)
    _, cj = jem.sample_costh_cdf(random.PRNGKey(7), jnp.asarray(nu), jnp.asarray(theta_e),
                                 jnp.asarray(b), jt, jnp.float64)
    ct = emission.sample_costh_cdf(gen(7), torch.as_tensor(nu), torch.as_tensor(theta_e),
                                   torch.as_tensor(b), pt, torch.float64)
    same_distribution(np.abs(np.asarray(cj)), np.abs(ct.numpy()), f"|cos| at x90={x90}")
    same_fraction((np.asarray(cj) > 0).mean(), (ct.numpy() > 0).mean(), N, "cos sign")
