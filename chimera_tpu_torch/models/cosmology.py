"""FLRW cosmology and its modified-propagation form MGFLRW, each with the
gather-free Chebyshev distance engine or the dense table of the reference
(``interp_method='table'``) (counterpart of
``chimera_tpu/models/cosmology.py``).

Every hyper-parameter and table carries a leading λ axis (see
``chimera_tpu_torch.pytree``); ``create`` builds the tables for the whole
batch with tensor ops, the batched form of the JAX package's per-λ
``FLRW.create`` under ``vmap``.

Units: distances in Gpc, H0 in km/s/Mpc (c = 299792.458 km/s).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from chimera_tpu_torch.ops.chebyshev import cheb_nodes, chebeval, chebfit_from_values
from chimera_tpu_torch.ops.integrate import cumtrapz, gauss_legendre_unit, logspace
from chimera_tpu_torch.ops.interp import interp
from chimera_tpu_torch.pytree import (fit_in_float64, lam, resolve_params,
                                      update_batch)

C_LIGHT_KM_S = 299792.458  # km/s
_Z_LO = 1e-6  # lower edge of the log-log Chebyshev fits; queries below clamp


@dataclasses.dataclass(frozen=True)
class FLRW:
    """w0waCDM FLRW cosmology.  Hyper-parameters H0, Om0, Ok0, Or0, w0, wa
    (each (L,)); Chebyshev state ``cheb_g`` (L, deg) for the comoving
    integral and ``cheb_logh`` (L, deg) on [dgw_lo, dgw_max] for the inverse
    distance map, float64 in every dtype (see ``z_from_dgw``); or, with
    ``interp_method='table'``, the table ``int_invE`` (L, Z) of the
    cumulative 1/E integral on the nodes ``z_grid`` (L, Z) = [0] +
    logspace(-10, log10 z_max), which both maps interpolate."""

    H0: torch.Tensor
    Om0: torch.Tensor
    Ok0: torch.Tensor
    Or0: torch.Tensor
    w0: torch.Tensor
    wa: torch.Tensor
    cheb_g: torch.Tensor | None = None
    cheb_logh: torch.Tensor | None = None
    dgw_lo: torch.Tensor | None = None
    dgw_max: torch.Tensor | None = None
    z_grid: torch.Tensor | None = None
    int_invE: torch.Tensor | None = None
    z_max: float = 10.0
    z_grid_res: int = 1500
    interp_method: str = "chebyshev"
    cheb_deg: int = 64

    name: ClassVar[str] = "flrw"
    hyper_defaults: ClassVar[dict] = dict(H0=70.0, Om0=0.25, Ok0=0.0, Or0=0.0,
                                          w0=-1.0, wa=0.0)
    float64_fields: ClassVar[tuple[str, ...]] = ("cheb_logh", "dgw_lo", "dgw_max")
    config_keys: ClassVar[tuple[str, ...]] = (
        "z_max", "z_grid_res", "interp_method", "cheb_deg")
    # d_GW = Xi(z) d_L with Xi != 1 (MGFLRW)
    modified_gw: ClassVar[bool] = False

    # -- construction -------------------------------------------------------

    @classmethod
    def create(cls, *, device=None, dtype=None, **kwargs) -> "FLRW":
        """Build the model and its distance tables for every λ at once
        (fitted in float64, stored in the model's dtype).  Hyper-parameters
        are scalars or 1-D sequences/tensors (the λ axis)."""
        hyper, config = resolve_params(cls, kwargs, device, dtype)
        if config["interp_method"] not in ("chebyshev", "table"):
            raise ValueError(f"unknown interp_method {config['interp_method']!r}")
        return fit_in_float64(cls(**hyper, **config), FLRW._with_tables)

    def _with_tables(self) -> "FLRW":
        """The cumulative 1/E table on [0] + logspace(-10, log10 z_max)
        (cosmology.py:89-94); the 'table' engine keeps it, the Chebyshev
        engine takes its Newton starting points from it:

        forward fit of G(z) = (1/z) int_0^z dz'/E from Gauss–Legendre
        quadrature, then the inverse fit of log(z/dgw) vs log dgw from three
        Newton refinements of a table guess (cosmology.py:95-139)."""
        dtype, device = self.H0.dtype, self.H0.device
        ends = torch.full((2,), -10.0, dtype=dtype, device=device)
        ends[1] = math.log10(self.z_max)
        zg = torch.cat([torch.zeros(1, dtype=dtype, device=device),
                        logspace(ends[0], ends[1], self.z_grid_res - 1)])
        table = cumtrapz(1.0 / e_at_z(self, zg[None]), zg)        # (L, Z)
        if self.interp_method == "table":
            return dataclasses.replace(self, z_grid=zg.expand_as(table),
                                       int_invE=table)

        gl_x, gl_w = gauss_legendre_unit(48, dtype, device)
        z_nodes = cheb_nodes(self.cheb_deg, 0.0, self.z_max, dtype=dtype,
                             device=device)
        g_vals = torch.sum(
            gl_w / e_at_z(self, (z_nodes[:, None] * gl_x)[None]), dim=-1)
        obj = dataclasses.replace(self, cheb_g=chebfit_from_values(g_vals))

        dgw_table = _dl_from_table(obj, zg, table)                # (L, Z)
        dgw_max = dgw_table[:, -1]
        dgw_lo = interp(torch.full((), _Z_LO, dtype=dtype, device=device),
                        zg, dgw_table)
        d_nodes = torch.exp(cheb_nodes(obj.cheb_deg, torch.log(dgw_lo),
                                       torch.log(dgw_max)))      # (L, deg)
        z_n = torch.clamp(interp(d_nodes, dgw_table, zg), _Z_LO, obj.z_max)
        for _ in range(3):
            resid = dl_at_z(obj, z_n) - d_nodes
            z_n = torch.clamp(z_n - resid / ddl_dz_at_z(obj, z_n),
                              _Z_LO * 0.5, obj.z_max)
        return dataclasses.replace(
            obj, cheb_logh=chebfit_from_values(torch.log(z_n / d_nodes)),
            dgw_lo=dgw_lo, dgw_max=dgw_max)

    @classmethod
    def from_state(cls, state: dict, prefix: str = "", device=None,
                   dtype=None) -> "FLRW":
        """Load hyper-parameters and built tables from a
        ``convert.state_from_reference`` dict (tables are not rebuilt)."""
        from chimera_tpu_torch.convert import model_from_state

        return model_from_state(cls, state, prefix, device, dtype)

    update_batch = update_batch

    # -- derived quantities -------------------------------------------------

    @property
    def L(self) -> int:
        return self.H0.shape[0]

    @property
    def Ode0(self) -> torch.Tensor:
        return 1.0 - self.Om0 - self.Or0 - self.Ok0

    @property
    def dH(self) -> torch.Tensor:
        """Hubble distance in Gpc."""
        return C_LIGHT_KM_S * 1e-3 / self.H0


@dataclasses.dataclass(frozen=True)
class MGFLRW(FLRW):
    """FLRW with modified GW propagation d_GW = Xi(z) d_L,
    Xi(z) = Xi0 + (1 - Xi0) (1+z)^-n (cosmology.py:180-195)."""

    Xi0: torch.Tensor = None
    n: torch.Tensor = None

    name: ClassVar[str] = "mg_flrw"
    hyper_defaults: ClassVar[dict] = dict(FLRW.hyper_defaults, Xi0=1.0, n=0.0)
    modified_gw: ClassVar[bool] = True

    def gw_distance_factor(self, z: torch.Tensor) -> torch.Tensor:
        xi0 = lam(self.Xi0, z)
        return xi0 + (1.0 - xi0) * torch.pow(1.0 + z, -lam(self.n, z))

    def gw_distance_factor_derivative(self, z: torch.Tensor) -> torch.Tensor:
        n = lam(self.n, z)
        return n * (lam(self.Xi0, z) - 1.0) * torch.pow(1.0 + z, -(n + 1.0))


# ---------------------------------------------------------------------------
# Cosmological functions; ``z`` has a leading λ axis of length 1 or L
# ---------------------------------------------------------------------------

def e_at_z(cosmo: FLRW, z: torch.Tensor) -> torch.Tensor:
    """Dimensionless Hubble parameter E(z) for w0waCDM."""
    zp1 = 1.0 + z
    w_z = lam(cosmo.w0, z) + lam(cosmo.wa, z) * z / zp1
    return torch.sqrt(
        lam(cosmo.Om0, z) * zp1**3
        + lam(cosmo.Or0, z) * zp1**4
        + lam(cosmo.Ok0, z) * zp1**2
        + lam(cosmo.Ode0, z) * torch.pow(zp1, 3.0 * (1.0 + w_z)))


def _curvature_transverse(cosmo: FLRW, dcr: torch.Tensor) -> torch.Tensor:
    """The curvature map d_C -> d_M as branch-free selects."""
    ok0 = lam(cosmo.Ok0, dcr)
    sqrt_ok = torch.sqrt(torch.abs(ok0 + 1e-10))
    dh = lam(cosmo.dH, dcr)
    x = sqrt_ok * dcr / dh
    return torch.where(ok0 == 0.0, dcr,
                       torch.where(ok0 > 0.0, (dh / sqrt_ok) * torch.sinh(x),
                                   (dh / sqrt_ok) * torch.sin(x)))


def _dl_from_table(cosmo: FLRW, zg: torch.Tensor, table: torch.Tensor
                   ) -> torch.Tensor:
    """GW distance on the table's own nodes ``zg`` (Z,) or (L, Z), from its
    cumulative 1/E integral ``table`` (L, Z): no lookup."""
    dgw = _curvature_transverse(cosmo, lam(cosmo.dH, table) * table) * (1.0 + zg)
    if cosmo.modified_gw:
        dgw = dgw * cosmo.gw_distance_factor(zg.expand_as(table))
    return dgw


def int_inv_e_at_z(cosmo: FLRW, z: torch.Tensor) -> torch.Tensor:
    """int_0^z dz'/E: z G(z), G from the Chebyshev fit, or the table
    interpolated (``interp_method='table'``)."""
    if cosmo.interp_method == "table":
        return interp(z, cosmo.z_grid, cosmo.int_invE)
    zc = torch.clamp(z, 0.0, cosmo.z_max)
    return zc * chebeval(cosmo.cheb_g, zc, 0.0, cosmo.z_max)


def comoving_distance(cosmo: FLRW, z: torch.Tensor) -> torch.Tensor:
    return lam(cosmo.dH, z) * int_inv_e_at_z(cosmo, z)


def transverse_comoving_distance(cosmo: FLRW, z: torch.Tensor) -> torch.Tensor:
    return _curvature_transverse(cosmo, comoving_distance(cosmo, z))


def _dct(cosmo: FLRW, z: torch.Tensor, distances) -> torch.Tensor:
    """Transverse comoving distance at z, or from measured GW distances,
    de-modified by Xi(z) first: d_M = d_GW / Xi(z) / (1+z)."""
    if distances is None:
        return transverse_comoving_distance(cosmo, z)
    if cosmo.modified_gw:
        distances = distances / cosmo.gw_distance_factor(z)
    return distances / (1.0 + z)


def angular_distance(cosmo: FLRW, z: torch.Tensor, distances=None) -> torch.Tensor:
    """Angular-diameter distance d_M / (1+z) in Gpc."""
    return _dct(cosmo, z, distances) / (1.0 + z)


def comoving_volume(cosmo: FLRW, z: torch.Tensor, distances=None) -> torch.Tensor:
    """Comoving volume V_C(z) in Gpc^3, with the curvature branches as
    selects (chimera_tpu/models/cosmology.py:270)."""
    dct = _dct(cosmo, z, distances)
    ok0 = lam(cosmo.Ok0, dct)
    reg_ok = ok0 + 1e-10
    sqrt_ok = torch.sqrt(torch.abs(reg_ok))
    dh = lam(cosmo.dH, dct)
    r = dct / dh
    common = r * torch.sqrt(1.0 + reg_ok * r * r)
    curved = 4.0 * math.pi * dh**3 / (2.0 * reg_ok)
    return torch.where(
        ok0 == 0.0, 4.0 * math.pi * dct**3 / 3.0,
        torch.where(ok0 > 0.0,
                    curved * (common - torch.asinh(sqrt_ok * r) / sqrt_ok),
                    curved * (common - torch.asin(sqrt_ok * r) / sqrt_ok)))


def differential_comoving_volume(cosmo: FLRW, z: torch.Tensor,
                                 distances=None) -> torch.Tensor:
    """dV_C/dz in Gpc^3 per unit z."""
    dct = _dct(cosmo, z, distances)
    return 4.0 * math.pi * lam(cosmo.dH, z) * dct**2 / e_at_z(cosmo, z)


def dl_at_z(cosmo: FLRW, z: torch.Tensor) -> torch.Tensor:
    """GW luminosity distance Xi(z) (1+z) d_M(z)."""
    dgw = transverse_comoving_distance(cosmo, z) * (1.0 + z)
    if cosmo.modified_gw:
        dgw = dgw * cosmo.gw_distance_factor(z)
    return dgw


def ddl_dz_at_z(cosmo: FLRW, z: torch.Tensor, distances=None) -> torch.Tensor:
    """d(d_GW)/dz — the Jacobian of the distance-redshift map."""
    dct = _dct(cosmo, z, distances)
    ddl = dct + (lam(cosmo.dH, z) / e_at_z(cosmo, z)) * (1.0 + z)
    if cosmo.modified_gw:
        ddl = (ddl * cosmo.gw_distance_factor(z)
               + dct * (1.0 + z) * cosmo.gw_distance_factor_derivative(z))
    return ddl


def z_from_dgw(cosmo: FLRW, dgw: torch.Tensor) -> torch.Tensor:
    """Invert the GW distance-redshift relation: distances clamp to
    [dgw_lo, dgw_max], then z = d exp(cheb_logh(log d)), in ``dgw``'s dtype.

    The Chebyshev series is summed in float64 whatever that dtype, as the
    dark-siren CUDA kernels do; the clamp, log and exp stay in ``dgw``'s
    dtype.  In float32 the 64-term Clenshaw sum is off by ~1e-7 and nearby
    samples share the error, so every z of an event moves alike; the
    dark-siren numerator integrates narrow per-pixel KDEs on coarse z-grids
    and amplifies such a shift some 20 times (a 5e-8 shift of z moved the
    sum of 16 log numerators by 1.8e-5 on a CPU run).  The spectral kernel
    sums in its working dtype: its likelihood does not feel the shift.

    The 'table' engine interpolates the distance table, clamping to its
    ends like ``jnp.interp``."""
    if cosmo.interp_method == "table":
        return interp(dgw, _dl_from_table(cosmo, cosmo.z_grid, cosmo.int_invE),
                      cosmo.z_grid)
    dt, f64 = dgw.dtype, torch.float64
    lo, hi = cosmo.dgw_lo.to(f64), cosmo.dgw_max.to(f64)
    d = torch.minimum(torch.maximum(dgw, lam(lo.to(dt), dgw)), lam(hi.to(dt), dgw))
    c = chebeval(cosmo.cheb_logh.to(f64), torch.log(d).to(f64), torch.log(lo),
                 torch.log(hi), clip=False)
    return d * torch.exp(c.to(dt))
