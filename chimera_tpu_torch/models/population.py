"""Population wrapper and the population-level functions (counterpart of
``chimera_tpu/models/population.py``).

``Population.update_batch`` is the batched form of the JAX package's
``jax.vmap(lambda lam: pop.update(**lam))``: each sub-model rebuilds its
tables for the whole λ batch when the batch holds one of its
hyper-parameters, and is broadcast unchanged otherwise.
"""

from __future__ import annotations

import dataclasses

import torch

from chimera_tpu_torch.catalog import EmptyCatalog, PixelatedCatalog
from chimera_tpu_torch.data.structs import ThetaInjDet, ThetaPEDet, ThetaSrc
from chimera_tpu_torch.models import cosmology as cosmo_fns
from chimera_tpu_torch.models.cosmology import FLRW
from chimera_tpu_torch.models.mass import BaseMassModel, PowerLawPeak, p_m1m2
from chimera_tpu_torch.models.rate import MadauDickinsonRate
from chimera_tpu_torch.ops.integrate import linspace
from chimera_tpu_torch.pytree import as_batch, batch_size, lam, tensor_map


@dataclasses.dataclass(frozen=True)
class Population:
    """(cosmology, mass, rate) hyper-model plus catalog prior and run config;
    every sub-model and R0 carry the same λ axis.  The catalog prior holds
    no hyper-parameter: ``update_batch`` leaves it as it is."""

    cosmo: FLRW
    mass: BaseMassModel
    rate: MadauDickinsonRate
    R0: torch.Tensor
    gal_cat: EmptyCatalog | PixelatedCatalog = dataclasses.field(
        default_factory=EmptyCatalog)
    Tobs: float = 1.0
    scale_free: bool = True

    @classmethod
    def create(cls, cosmo, mass, rate, R0=1.0, gal_cat=None, Tobs=1.0,
               scale_free=True) -> "Population":
        """A catalog prior is moved to the cosmology's device, its
        floating-point tensors to its dtype."""
        ref = cosmo.H0
        gal_cat = EmptyCatalog() if gal_cat is None else tensor_map(
            gal_cat, lambda t: t.to(ref.device, ref.dtype if t.is_floating_point()
                                    else t.dtype))
        return cls(cosmo=cosmo, mass=mass, rate=rate,
                   R0=as_batch(R0, ref.device, ref.dtype), gal_cat=gal_cat,
                   Tobs=float(Tobs), scale_free=bool(scale_free))

    @classmethod
    def from_state(cls, state: dict, prefix: str = "", device=None,
                   dtype=None) -> "Population":
        """Load a population from a ``convert.state_from_reference`` dict."""
        from chimera_tpu_torch.convert import class_name

        models = {m.__name__: m for m in (FLRW, PowerLawPeak, MadauDickinsonRate)}
        parts = {}
        for part in ("cosmo", "mass", "rate"):
            kind = class_name(state, f"{prefix}{part}.")
            model = models.get(kind)
            if model is None:
                raise NotImplementedError(
                    f"{part} model {kind} is not ported (ROADMAP.md §1 item 3)")
            parts[part] = model.from_state(state, f"{prefix}{part}.", device, dtype)
        ref = parts["cosmo"].H0
        cat = class_name(state, f"{prefix}gal_cat.")
        if cat == "PixelatedCatalog":
            gal_cat = PixelatedCatalog.from_state(state, f"{prefix}gal_cat.",
                                                  ref.device, ref.dtype)
        elif cat == "EmptyCatalog":
            gal_cat = EmptyCatalog()
        else:
            raise NotImplementedError(
                f"galaxy catalog {cat} is not ported (ROADMAP.md §1 item 7)")
        return cls(**parts,
                   R0=torch.as_tensor(state[f"{prefix}R0"], dtype=ref.dtype,
                                      device=ref.device).reshape(-1),
                   gal_cat=gal_cat,
                   Tobs=float(state[f"{prefix}Tobs"]),
                   scale_free=bool(state[f"{prefix}scale_free"]))

    @property
    def L(self) -> int:
        return self.R0.shape[0]

    def update_batch(self, hyper_batch: dict) -> "Population":
        """λ batch from a dict of equal-length 1-D hyper-parameter arrays."""
        ref = self.cosmo.H0
        batch = {k: as_batch(v, ref.device, ref.dtype)
                 for k, v in hyper_batch.items()}
        owned = {"R0", *self.cosmo.hyper_defaults, *self.mass.hyper_defaults,
                 *self.rate.hyper_defaults}
        unknown = set(batch) - owned
        if unknown:
            raise ValueError(f"no population model owns {sorted(unknown)}")
        n = batch_size(*batch.values())
        return dataclasses.replace(
            self,
            cosmo=self.cosmo.update_batch(batch, n),
            mass=self.mass.update_batch(batch, n),
            rate=self.rate.update_batch(batch, n),
            R0=batch["R0"].expand(n) if "R0" in batch else self.R0.expand(n))

    def update(self, **hyper) -> "Population":
        """One hyper-parameter sample: a λ batch of 1."""
        return self.update_batch({k: [v] for k, v in hyper.items()})


# ---------------------------------------------------------------------------
# Frame transforms, redshift prior, detector-frame rates
# ---------------------------------------------------------------------------

def theta_det_to_src(cosmo, theta_det, include_original_distances: bool = False
                     ) -> ThetaSrc:
    """Detector -> source frame for every λ: z = z(dGW | λ_c),
    m_src = m_det / (1+z); results carry a leading λ axis."""
    dl = theta_det.dL[None]
    z = cosmo_fns.z_from_dgw(cosmo, dl)
    return ThetaSrc(m1src=theta_det.m1det[None] / (1.0 + z),
                    m2src=theta_det.m2det[None] / (1.0 + z), z=z,
                    original_distances=dl if include_original_distances else None)


def p_cbc(pop: Population, z: torch.Tensor) -> torch.Tensor:
    """p_gal(z) psi(z) / (1+z) — the CBC redshift prior; ``z`` has a
    leading λ axis.  A pixelated catalog adds a pixel axis before the last:
    (L, Nev, P, Nz) for z (1 or L, Nev, Nz)."""
    p_gal = pop.gal_cat.p_gal(pop.cosmo, z)
    p_rate = pop.rate.rate(z) / (1.0 + z)
    if p_gal.dim() > p_rate.dim():
        p_rate = p_rate.unsqueeze(-2)
    return p_gal * p_rate


def pop_rate_det(pop: Population, theta) -> torch.Tensor:
    """Population rate density in the detector frame, dN/dtheta_det, per λ:
    (L, ...) for PE samples or injections (``ThetaPEDet``/``ThetaInjDet``)
    or source-frame samples (``ThetaSrc``)."""
    if isinstance(theta, ThetaSrc):
        th_src = theta
    else:
        th_src = theta_det_to_src(
            pop.cosmo, theta,
            include_original_distances=isinstance(theta, ThetaInjDet))
    z = th_src.z
    p_z = pop.gal_cat.p_bkg(pop.cosmo, th_src)
    p_z = p_z * pop.rate.rate(z) / (1.0 + z)
    dn = lam(pop.R0, z) * p_m1m2(pop.mass, th_src.m1src, th_src.m2src) * p_z
    jac = torch.abs(cosmo_fns.ddl_dz_at_z(pop.cosmo, z, th_src.original_distances)
                    ) * (1.0 + z) ** 2
    return dn / jac


# ---------------------------------------------------------------------------
# Per-event z-grid construction
# ---------------------------------------------------------------------------

def compute_z_grids(cosmo: FLRW, theta_det: ThetaPEDet,
                    cosmo_prior: dict | None = None, z_int_res: int = 300,
                    z_conf_range=None) -> torch.Tensor:
    """Per-event redshift grids (Nev, z_int_res) covering each event's
    support under any cosmology in the prior box: the dL range is inverted at
    the two prior-corner cosmologies, built together as a λ batch of 2."""
    if cosmo.L != 1:
        raise ValueError("compute_z_grids takes a single cosmology (L = 1)")
    d_l = theta_det.dL
    if isinstance(z_conf_range, (list, tuple)):
        q = torch.as_tensor(z_conf_range, dtype=d_l.dtype, device=d_l.device)
        dl_min, dl_max = torch.quantile(d_l, q / 100.0, dim=1)
    elif z_conf_range is not None:
        mu = torch.mean(d_l, dim=1)
        sig = torch.std(d_l, dim=1, correction=0)
        dl_min = mu - z_conf_range * sig
        dl_max = mu + z_conf_range * sig
    else:
        dl_max = torch.amax(d_l, dim=1) * 2.0
        dl_min = torch.amin(d_l, dim=1) * 0.5
    dl_min = torch.clamp_min(dl_min, 1e-8)

    prior = {k: (getattr(cosmo, k), getattr(cosmo, k))
             for k in cosmo.hyper_defaults}
    if cosmo_prior is not None:
        prior.update({k: tuple(v) for k, v in cosmo_prior.items()})
    corners = type(cosmo).create(
        **{k: torch.cat([as_batch(lo, d_l.device, d_l.dtype),
                         as_batch(hi, d_l.device, d_l.dtype)])
           for k, (lo, hi) in prior.items()},
        z_max=cosmo.z_max, z_grid_res=10_000, interp_method=cosmo.interp_method,
        cheb_deg=cosmo.cheb_deg, device=d_l.device, dtype=d_l.dtype)
    z_lo, z_hi = cosmo_fns.z_from_dgw(corners, torch.stack([dl_min, dl_max]))
    return linspace(z_lo, z_hi, z_int_res)
