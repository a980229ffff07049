"""Galaxy-catalog completeness (counterpart of
``chimera_tpu/catalog/completeness.py``): the step completeness
``DVdzCompleteness`` and the empirical ``HomogeneousCompleteness``.

A completeness model gives the likelihood three things: ``P_compl`` on the
per-event z-grids, the cosmology-dependent normalization ``fR`` and the
homogeneous background prior ``p_bkg``.  Neither model holds a
hyper-parameter, so neither carries a λ axis; ``fR`` and ``p_bkg`` take a
λ-batched cosmology and return (L, ...).
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar

import torch

from chimera_tpu_torch.config import default_dtype, resolve_device
from chimera_tpu_torch.data.structs import ThetaSrc
from chimera_tpu_torch.models import cosmology as cosmo_fns
from chimera_tpu_torch.ops.integrate import linspace, trapz
from chimera_tpu_torch.ops.interp import interp, uniform_interp


@dataclasses.dataclass(frozen=True)
class DVdzCompleteness:
    """Step (or erf-smoothed step) completeness on ``z_range``:
    fR = V_C(z_range[1]) - V_C(z_range[0]) and p_bkg = dV_C/dz.  It holds no
    hyper-parameter, so it carries no λ axis; ``fR`` and ``p_bkg`` take a
    λ-batched cosmology."""

    z_range: torch.Tensor
    z_sig: torch.Tensor | None = None
    kind: str = "step"

    name: ClassVar[str] = "dVdz_completeness"

    @classmethod
    def create(cls, z_range=(0.073, 1.3), kind: str = "step", z_sig=None,
               device=None, dtype=None) -> "DVdzCompleteness":
        if kind not in ("step", "step_smooth"):
            raise ValueError("kind must be 'step' or 'step_smooth'")
        if kind == "step_smooth" and z_sig is None:
            raise ValueError("step_smooth requires z_sig")
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)

        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        return cls(z_range=t(z_range), z_sig=None if z_sig is None else t(z_sig),
                   kind=kind)

    @classmethod
    def from_state(cls, state: dict, prefix: str, device=None, dtype=None
                   ) -> "DVdzCompleteness":
        return cls.create(z_range=state[prefix + "z_range"],
                          kind=str(state[prefix + "kind"]),
                          z_sig=state.get(prefix + "z_sig"),
                          device=device, dtype=dtype)

    def P_compl(self, z_grids: torch.Tensor) -> torch.Tensor:
        lo, hi = self.z_range[0], self.z_range[1]
        if self.kind == "step":
            return ((z_grids > lo) & (z_grids < hi)).to(z_grids.dtype)
        s = self.z_sig * 2.0 ** 0.5
        rise = 0.5 * (1.0 + torch.special.erf((z_grids - lo) / s))
        fall = 0.5 * (1.0 + torch.special.erf((hi - z_grids) / s))
        return rise * fall

    def fR(self, cosmo) -> torch.Tensor:
        """(L,) comoving volume between the completeness edges."""
        vc = cosmo_fns.comoving_volume(cosmo, self.z_range[None])
        return vc[:, 1] - vc[:, 0]

    def p_bkg(self, cosmo, theta_or_z) -> torch.Tensor:
        if isinstance(theta_or_z, ThetaSrc):
            return cosmo_fns.differential_comoving_volume(
                cosmo, theta_or_z.z, theta_or_z.original_distances)
        return cosmo_fns.differential_comoving_volume(cosmo, theta_or_z)


def _z_of(theta_or_z) -> torch.Tensor:
    return theta_or_z.z if isinstance(theta_or_z, ThetaSrc) else theta_or_z


def _histogram(x: torch.Tensor, edges: torch.Tensor, weights) -> torch.Tensor:
    """``jnp.histogram(x, bins=edges, weights=weights)[0]`` on any device:
    each value's bin by ``searchsorted`` on the edges, the last bin closed,
    values outside dropped.  The sums accumulate by a sorted
    ``index_put_``, so the same galaxies give the same bits on CUDA too
    (a weighted ``bincount`` adds by atomics; ``torch.histogram`` runs on
    the CPU only)."""
    n = edges.shape[0]
    idx = torch.searchsorted(edges, x, right=True)
    idx = torch.where(x == edges[-1], n - 1, idx)
    w = torch.ones_like(x) if weights is None else weights.to(x.dtype)
    counts = torch.zeros(n + 1, dtype=x.dtype, device=x.device)
    counts.index_put_((idx,), w, accumulate=True)
    return counts[1:-1]


def _convolve_same(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``jnp.convolve(a, k, mode='same')`` for an odd, symmetric kernel no
    longer than ``a``: the centred len(a) values of the full convolution."""
    if k.shape[0] > a.shape[0]:
        raise ValueError("the smoothing kernel is longer than the z table")
    half = (k.shape[0] - 1) // 2
    return torch.nn.functional.conv1d(a[None, None], k.flip(0)[None, None],
                                      padding=half)[0, 0]


@dataclasses.dataclass(frozen=True)
class HomogeneousCompleteness:
    """Empirical completeness: the observed over the theoretical galaxy
    density on a uniform z table, fixed at the fiducial cosmology of
    ``create``.  Fields: ``z_table``, ``completeness`` and ``n_theo_table``
    (Nz,), ``z_min`` and ``z_max`` (0-d)."""

    z_table: torch.Tensor
    completeness: torch.Tensor
    n_theo_table: torch.Tensor
    z_min: torch.Tensor
    z_max: torch.Tensor

    name: ClassVar[str] = "homogeneous_completeness"

    @classmethod
    def create(cls, z_gal, theory_density_func, cosmo,
               sky_area_deg2: float = 58.0, z_range=None, n_bins: int = 50,
               n_interp: int = 1000, weights=None,
               smooth_sigma_bins: float | None = None, device=None, dtype=None
               ) -> "HomogeneousCompleteness":
        """Build the table from galaxy redshifts ``z_gal`` (and optional
        ``weights``), on their device and in their dtype when they are a
        floating-point tensor, else on ``device`` in ``dtype``.
        ``theory_density_func`` maps a z tensor to the theoretical density
        in Mpc^-3; ``cosmo`` is the fiducial cosmology (L = 1)."""
        if isinstance(z_gal, torch.Tensor) and z_gal.is_floating_point():
            device, dtype = z_gal.device, dtype or z_gal.dtype
        else:
            device = resolve_device(device)
            dtype = dtype or default_dtype(device)
        z_gal = torch.as_tensor(z_gal, device=device).to(dtype)
        if weights is not None:
            weights = torch.as_tensor(weights, device=device).to(dtype)
        if z_range is None:
            z_range = (float(z_gal.min()), float(z_gal.max()))
        z_lo, z_hi = float(z_range[0]), float(z_range[1])

        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=device)

        z_table = linspace(t(z_lo), t(z_hi), n_interp + 1)
        sky_area_sr = sky_area_deg2 * (math.pi / 180.0) ** 2

        # observed density: weighted histogram over the comoving shells
        edges = linspace(t(z_lo), t(z_hi), n_bins + 1)
        centers = 0.5 * (edges[:-1] + edges[1:])
        dz = edges[1] - edges[0]
        n_obs = _histogram(z_gal, edges, weights)
        dvdz = cosmo_fns.differential_comoving_volume(cosmo, centers[None])[0]
        # dV/dz in Gpc^3, densities per Mpc^3 (the 1e9 Gpc^3 -> Mpc^3)
        shell_mpc3 = dz * 1e9 * dvdz * sky_area_sr / (4.0 * math.pi)
        rho_obs = interp(z_table, centers, n_obs / shell_mpc3)
        if smooth_sigma_bins:
            half = int(4 * smooth_sigma_bins) + 1
            x = torch.arange(-half, half + 1, device=device).to(dtype)
            k = torch.exp(-0.5 * (x / smooth_sigma_bins) ** 2)
            rho_obs = _convolve_same(rho_obs, k / torch.sum(k))
        n_theo = theory_density_func(z_table)
        rho_theo = torch.clamp_min(n_theo, 1e-99)
        compl = torch.clamp_max(rho_obs / rho_theo, 1.0)
        compl = torch.where((z_table >= z_lo) & (z_table <= z_hi), compl, 0.0)
        return cls(z_table=z_table, completeness=compl, n_theo_table=n_theo,
                   z_min=t(z_lo), z_max=t(z_hi))

    @classmethod
    def from_state(cls, state: dict, prefix: str, device=None, dtype=None
                   ) -> "HomogeneousCompleteness":
        device = resolve_device(device)
        dtype = dtype or default_dtype(device)
        return cls(**{f.name: torch.as_tensor(state[prefix + f.name],
                                              device=device).to(dtype)
                      for f in dataclasses.fields(cls)})

    def _on_table(self, z: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
        """Linear interpolation of table rows ``fp`` (R, Nz) at ``z``, whose
        leading axis has length 1 or R, zero outside the table; the nodes are
        uniform, so by ``uniform_interp`` (its backward adds by a sorted
        ``index_put_``, no atomics)."""
        r = max(fp.shape[0], z.shape[0] if z.dim() else 1)
        x = z.reshape(z.shape[0] if z.dim() else 1, -1).expand(r, -1)
        lo = self.z_table[0].expand(r)
        hi = self.z_table[-1].expand(r)
        out = uniform_interp(x, lo, hi, fp.expand(r, -1), 0.0, 0.0)
        return out.reshape((r,) + tuple(z.shape[1:]) if z.dim() else (r,))

    def P_compl(self, z_grids: torch.Tensor) -> torch.Tensor:
        """The completeness at ``z_grids`` (any shape), 0 off the table."""
        flat = z_grids.reshape(1, -1)
        return self._on_table(flat, self.completeness[None]).reshape(z_grids.shape)

    def _bkg_table(self, cosmo) -> torch.Tensor:
        """(L, Nz) n_theo dV_C/dz at the trial cosmology on the table,
        normalized over it."""
        zt = self.z_table
        inside = (zt >= self.z_min) & (zt <= self.z_max)
        bkg = torch.where(inside, self.n_theo_table
                          * cosmo_fns.differential_comoving_volume(cosmo, zt[None]),
                          0.0)
        return bkg / trapz(bkg, zt)[:, None]

    def p_bkg(self, cosmo, theta_or_z) -> torch.Tensor:
        """n_theo(z) dV_C/dz at the trial cosmology, normalized over the
        table, at z (leading axis 1 or L) -> (L, ...)."""
        return self._on_table(_z_of(theta_or_z), self._bkg_table(cosmo))

    def fR(self, cosmo) -> torch.Tensor:
        """(L,) the completeness-weighted integral of p_bkg over the table."""
        p_bkg = self._on_table(self.z_table[None], self._bkg_table(cosmo))
        return trapz(self.completeness * p_bkg, self.z_table)
