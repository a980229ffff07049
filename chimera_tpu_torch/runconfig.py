"""Run-level TOML configuration (counterpart of ``chimera_tpu/runconfig.py``):
one TOML file selects the population models, the likelihood's settings, the
priors, the catalog's completeness, the pixelization and the sampler, and
the builders below turn it into the port's objects.  The files are the JAX
package's (``examples/*.toml``); the builders take the device and dtype the
port's constructors take (default: the card and its dtype).

    [cosmology]
    model = "flrw"          # flrw | mg_flrw
    H0 = 70.0

    [mass]
    model = "plp"           # tpl | bpl | plp | pl2p | pls

    [rate]
    model = "madau_dickinson"

    [likelihood]            # HyperLikelihood.create's keywords
    binning = false

    [prior.H0]
    range = [40.0, 120.0]
"""

from __future__ import annotations

import tomllib
from dataclasses import dataclass, field
from typing import Any

from chimera_tpu_torch.models import (FLRW, MGFLRW, BrokenPowerLaw,
                                      MadauDickinsonRate, Population,
                                      PowerLawPeak, PowerLawRate,
                                      PowerLawSpline, PowerLawTwoPeaks,
                                      TruncatedMadauDickinsonRate,
                                      TruncatedPowerLaw, TruncatedPowerLawRate)

COSMO_MODELS = {"flrw": FLRW, "mg_flrw": MGFLRW}
MASS_MODELS = {
    "tpl": TruncatedPowerLaw,
    "bpl": BrokenPowerLaw,
    "plp": PowerLawPeak,
    "pl2p": PowerLawTwoPeaks,
    "pls": PowerLawSpline,
}
RATE_MODELS = {
    "power_law": PowerLawRate,
    "trunc_power_law": TruncatedPowerLawRate,
    "madau_dickinson": MadauDickinsonRate,
    "trunc_madau_dickinson": TruncatedMadauDickinsonRate,
}
COMPLETENESS_MODELS = {"dvdz": "DVdzCompleteness",
                       "homogeneous": "HomogeneousCompleteness"}


@dataclass
class RunConfig:
    """A parsed run configuration; every section is optional."""

    cosmology: dict = field(default_factory=lambda: {"model": "flrw"})
    mass: dict = field(default_factory=lambda: {"model": "plp"})
    rate: dict = field(default_factory=lambda: {"model": "madau_dickinson"})
    population: dict = field(default_factory=dict)   # R0, Tobs, scale_free
    likelihood: dict = field(default_factory=dict)   # kind, binning, ...
    prior: dict = field(default_factory=dict)        # {name: {range=[lo,hi]}}
    sampler: dict = field(default_factory=dict)      # kind, n_walkers, ...
    data: dict = field(default_factory=dict)         # paths / mock settings
    catalog: dict = field(default_factory=dict)      # completeness, z_err
    pixelization: dict = field(default_factory=dict)  # pixelize_gw_catalog's

    @classmethod
    def from_dict(cls, raw: dict) -> "RunConfig":
        unknown = set(raw) - set(cls.__dataclass_fields__)
        if unknown:
            raise ValueError(f"unknown config sections: {sorted(unknown)}")
        return cls(**{k: dict(v) for k, v in raw.items()})

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))


def _build_model(section: dict, registry: dict, what: str, device, dtype):
    params = dict(section)
    name = params.pop("model", None)
    if name not in registry:
        raise ValueError(
            f"{what}.model must be one of {sorted(registry)}, got {name!r}")
    return registry[name].create(**params, device=device, dtype=dtype)


def build_population(cfg: RunConfig, gal_cat: Any = None, device=None,
                     dtype=None) -> Population:
    """Population (cosmology x mass x rate) from the config's sections."""
    cosmo = _build_model(cfg.cosmology, COSMO_MODELS, "cosmology", device, dtype)
    ref = cosmo.H0
    mass = _build_model(cfg.mass, MASS_MODELS, "mass", ref.device, ref.dtype)
    rate = _build_model(cfg.rate, RATE_MODELS, "rate", ref.device, ref.dtype)
    return Population.create(cosmo, mass, rate, gal_cat=gal_cat,
                             **cfg.population)


def build_likelihood(cfg: RunConfig, theta_gw, z_grids, population,
                     selection=None):
    """HyperLikelihood from the [likelihood] section, on the population's
    device and dtype."""
    from chimera_tpu_torch.likelihood import HyperLikelihood

    return HyperLikelihood.create(theta_gw, z_grids, population, selection,
                                  **cfg.likelihood)


def prior_bounds(cfg: RunConfig) -> dict[str, tuple[float, float]]:
    """{param: (lo, hi)} from the [prior.*] tables."""
    out = {}
    for name, spec in cfg.prior.items():
        rng = spec["range"] if isinstance(spec, dict) else spec
        if len(rng) != 2 or rng[0] >= rng[1]:
            raise ValueError(f"prior.{name}.range must be [lo, hi]")
        out[name] = (float(rng[0]), float(rng[1]))
    return out


def build_completeness(cfg: RunConfig, device=None, dtype=None):
    """Completeness model from the [catalog] section: ``completeness``
    ('dvdz' by default) and the model's ``create`` keywords (z_range, kind,
    z_sig for 'dvdz'); ``z_err`` belongs to the catalog build."""
    from chimera_tpu_torch import catalog as cat_mod

    params = dict(cfg.catalog)
    params.pop("z_err", None)
    name = params.pop("completeness", "dvdz")
    if name not in COMPLETENESS_MODELS:
        raise ValueError(
            f"catalog.completeness must be one of "
            f"{sorted(COMPLETENESS_MODELS)}, got {name!r}")
    cls = getattr(cat_mod, COMPLETENESS_MODELS[name])
    if "z_range" in params:
        params["z_range"] = tuple(params["z_range"])
    return cls.create(**params, device=device, dtype=dtype)


def pixelization_kwargs(cfg: RunConfig) -> dict:
    """``data.pixelize.pixelize_gw_catalog``'s keywords from the
    [pixelization] section."""
    out = dict(cfg.pixelization)
    if "nside_list" in out:
        out["nside_list"] = [int(n) for n in out["nside_list"]]
    return out


def cosmo_prior(cfg: RunConfig) -> dict[str, list[float]]:
    """The cosmology parameters' priors, in the list form
    ``compute_z_grids`` takes."""
    keys = set(FLRW.hyper_defaults) | set(MGFLRW.hyper_defaults)
    return {k: [lo, hi] for k, (lo, hi) in prior_bounds(cfg).items()
            if k in keys}
