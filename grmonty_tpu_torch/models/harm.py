"""HARM GRMHD snapshot model: dump I/O, unit system, derived quantities.

Port of ``grmonty_tpu/models/harm.py`` in plain numpy (the reference reader
is ``cuda_grmonty/harm_model.cpp:64-232``).  A dump is one header line of
25-26 fields followed by ``n1 * n2`` rows of 34 columns, of which the 8
primitives (rho, u, u^1..u^3, B^1..B^3) are kept.  The body is parsed by
the native parser (``models/harmio_native``) unless the caller asks for
numpy; where the JAX reader falls back to numpy silently, the port raises.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

from grmonty_tpu_torch import consts


@dataclasses.dataclass
class Header:
    """Dump header (harm_data.hpp:19-44, parse order harm_model.cpp:103-136)."""

    t: float = 0.0
    n: tuple[int, int] = (0, 0)
    x_start: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    x_stop: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    dx: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    t_final: float = 0.0
    n_step: int = 0
    a: float = 0.0  # dimensionless BH spin
    gamma: float = 0.0  # adiabatic index
    courant: float = 0.0
    dt_dump: float = 0.0
    dt_log: float = 0.0
    dt_img: float = 0.0
    dt_rdump: int = 0
    cnt_dump: int = 0
    cnt_img: int = 0
    cnt_rdump: int = 0
    dt: float = 0.0
    lim: int = 0
    failed: int = 0
    r_in: float = 0.0
    r_out: float = 0.0
    h_slope: float = 0.0
    r_0: float = 0.0


@dataclasses.dataclass
class Data:
    """Primitive fluid variables on the (n1, n2) grid, float64 numpy arrays."""

    k_rho: np.ndarray
    u: np.ndarray
    u_1: np.ndarray
    u_2: np.ndarray
    u_3: np.ndarray
    b_1: np.ndarray
    b_2: np.ndarray
    b_3: np.ndarray

    def stacked(self) -> np.ndarray:
        """All 8 primitives as one (8, n1, n2) array."""
        return np.stack([self.k_rho, self.u, self.u_1, self.u_2, self.u_3,
                         self.b_1, self.b_2, self.b_3])


@dataclasses.dataclass
class Units:
    """CGS unit system derived from the mass unit (harm_model.cpp:64-79)."""

    mass_unit: float
    l_unit: float
    t_unit: float
    rho_unit: float
    u_unit: float
    b_unit: float
    n_e_unit: float
    theta_e_unit: float = 0.0


def make_units(mass_unit: float) -> Units:
    l_unit = consts.G_NEWT * consts.M_BH / (consts.CL * consts.CL)
    rho_unit = mass_unit / l_unit**3
    return Units(
        mass_unit=mass_unit,
        l_unit=l_unit,
        t_unit=l_unit / consts.CL,
        rho_unit=rho_unit,
        u_unit=rho_unit * consts.CL * consts.CL,
        b_unit=consts.CL * math.sqrt(4.0 * math.pi * rho_unit),
        n_e_unit=rho_unit / (consts.MP + consts.ME),
    )


def theta_e_unit(gamma: float) -> float:
    """Two-temperature electron temperature unit (harm_model.cpp:139-141)."""
    two_temp_gamma = 0.5 * (
        (1.0 + 2.0 / 3.0 * (consts.TP_OVER_TE + 1.0) / (consts.TP_OVER_TE + 2.0)) + gamma
    )
    return (two_temp_gamma - 1.0) * (consts.MP / consts.ME) / (1.0 + consts.TP_OVER_TE)


@dataclasses.dataclass
class HARMModel:
    """A parsed HARM snapshot plus the derived quantities the transport needs."""

    header: Header
    data: Data
    units: Units
    bias_norm: float  # volume-averaged (u/rho * theta_e_unit)^2
    rh: float  # event horizon radius 1 + sqrt(1 - a^2)
    x1_min: float  # ln(rh): inner tracking boundary

    @property
    def max_tau_scatt_init(self) -> float:
        """Initial bias normalisation depth (harm_model.cpp:72)."""
        return 6.0 * self.units.l_unit * self.units.rho_unit * 0.4

    @property
    def d_tau_k(self) -> float:
        """Optical depth per unit affine parameter (harm_model.cpp:73)."""
        return 2.0 * math.pi * self.units.l_unit / (
            consts.ME * consts.CL * consts.CL / consts.HBAR
        )


def _parse_header(line: str) -> Header:
    f = [float(t) for t in line.split()]
    h = Header()
    h.t = f[0]
    n1, n2 = int(f[1]), int(f[2])
    h.n = (n1, n2)
    x_start1, x_start2 = f[3], f[4]
    dx1, dx2 = f[5], f[6]
    h.x_start = (0.0, x_start1, x_start2, 0.0)
    h.dx = (1.0, dx1, dx2, 2.0 * math.pi)
    h.x_stop = (1.0, x_start1 + n1 * dx1, x_start2 + n2 * dx2, 2.0 * math.pi)
    h.t_final = f[7]
    h.n_step = int(f[8])
    h.a = f[9]
    h.gamma = f[10]
    h.courant = f[11]
    h.dt_dump = f[12]
    h.dt_log = f[13]
    h.dt_img = f[14]
    h.dt_rdump = int(f[15])
    h.cnt_dump = int(f[16])
    h.cnt_img = int(f[17])
    h.cnt_rdump = int(f[18])
    h.dt = f[19]
    h.lim = int(f[20])
    h.failed = int(f[21])
    h.r_in = f[22]
    h.r_out = f[23]
    h.h_slope = f[24]
    h.r_0 = f[25] if len(f) > 25 else 0.0
    return h


# Column layout of a dump row (harm_model.cpp:185-204): 0..3 x1 x2 r h,
# 4..11 the 8 primitives, 12 div_b, 13..16 u_con, 17..20 u_cov,
# 21..24 b_con, 25..28 b_cov, 29..32 vmin/vmax, 33 g_det.
_N_COLS = 34


def parse_body(text: str, native: bool = True) -> np.ndarray:
    """The dump body's values as a flat float64 array: by the native
    parser (``models/harmio_native``, which raises if it cannot build), or
    with ``native=False`` by numpy.  Both give the same bits."""
    if native:
        from grmonty_tpu_torch.models import harmio_native

        return harmio_native.parse_doubles(text)
    return np.array(text.split(), dtype=np.float64)


def read_dump(filepath: str, mass_unit: float, native: bool = True) -> HARMModel:
    """Read a HARM dump file (harm_model.cpp:81-232); the body is parsed by
    :func:`parse_body`."""
    if not os.path.exists(filepath):
        raise FileNotFoundError(f"File does not exist {filepath}")
    with open(filepath) as fh:
        header = _parse_header(fh.readline())
        body = parse_body(fh.read(), native)
    n1, n2 = header.n
    if body.size != n1 * n2 * _N_COLS:
        raise ValueError(
            f"HARM dump body has {body.size} values, expected {n1 * n2}x{_N_COLS}")
    body = body.reshape(n1 * n2, _N_COLS)

    units = make_units(mass_unit)
    units.theta_e_unit = theta_e_unit(header.gamma)

    prims = body[:, 4:12].reshape(n1, n2, 8)
    data = Data(*[np.ascontiguousarray(prims[:, :, i]) for i in range(8)])

    # Volume-averaged bias normalisation (harm_model.cpp:142-223).
    g_det = body[:, 33].reshape(n1, n2)
    d_v = header.dx[1] * header.dx[2] * header.dx[3]
    w = g_det * (data.u / data.k_rho * units.theta_e_unit) ** 2
    bias_norm = d_v * w.sum() / (d_v * g_det.sum())

    rh = 1.0 + math.sqrt(max(0.0, 1.0 - header.a * header.a))
    return HARMModel(header=header, data=data, units=units,
                     bias_norm=bias_norm, rh=rh, x1_min=math.log(rh))


def write_dump(filepath: str, header: Header, data: Data,
               extras: np.ndarray | None = None):
    """Write a HARM dump; ``extras`` supplies the 22 trailing diagnostic
    columns (div_b..g_det) as an (n1*n2, 22) array, zeros otherwise."""
    h = header
    n1, n2 = h.n
    hdr = (
        f"{h.t} {n1} {n2} {h.x_start[1]} {h.x_start[2]} {h.dx[1]} {h.dx[2]} "
        f"{h.t_final} {h.n_step} {h.a} {h.gamma} {h.courant} {h.dt_dump} "
        f"{h.dt_log} {h.dt_img} {h.dt_rdump} {h.cnt_dump} {h.cnt_img} "
        f"{h.cnt_rdump} {h.dt} {h.lim} {h.failed} {h.r_in} {h.r_out} "
        f"{h.h_slope} {h.r_0}"
    )
    rows = np.zeros((n1 * n2, _N_COLS))
    rows[:, 4:12] = data.stacked().reshape(8, -1).T
    if extras is not None:
        rows[:, 12:34] = extras
    with open(filepath, "w") as fh:
        fh.write(hdr + "\n")
        np.savetxt(fh, rows, fmt="%.17g")
