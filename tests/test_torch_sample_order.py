"""The sample order that the pruned pair loops of K1a and K2b rely on for
their speed (csrc/kde.cuh, contract_pruned; csrc/adjoint.cuh,
rows_adjoint_event): ``HyperLikelihood.create`` sorts each event's PE
samples by distance (``likelihood._sort_samples_by_distance``), so that a
row's z ascends under every cosmology, and the dark-siren layouts keep
that order (``data.pixelize.compact_samples_by_pixel``, a stable sort by
pixel; ``chunk_rows_from_compact``, each pixel's samples cut in order),
with only the weightless fillers after a row's real samples.  The kernels'
outputs do not depend on the order (their tile bounds are computed, not
assumed); a change that breaks it shows here rather than as a silent
slowdown on the card."""

import pytest
import torch

from chimera_tpu_torch import HyperLikelihood, SelectionFunction
from chimera_tpu_torch.data.mock import (make_mock_catalog, make_mock_galaxies,
                                         make_mock_injections)
from chimera_tpu_torch.models import (FLRW, MadauDickinsonRate, Population,
                                      PowerLawPeak, compute_z_grids)

F64 = torch.float64


def _population(gal_cat=None):
    return Population.create(
        FLRW.create(H0=70.0, Om0=0.25, device="cpu", dtype=F64),
        PowerLawPeak.create(device="cpu", dtype=F64),
        MadauDickinsonRate.create(device="cpu", dtype=F64), gal_cat=gal_cat)


def _shuffled(cat, gen):
    """The catalog with each event's samples in a random order."""
    perm = torch.argsort(torch.rand(cat.dL.shape, generator=gen), dim=1)
    fields = [k for k in ("m1det", "m2det", "dL", "pe_prior", "ra", "dec")
              if getattr(cat, k, None) is not None]
    out = cat.update(**{k: torch.take_along_dim(getattr(cat, k), perm, dim=1)
                        for k in fields})
    assert not (out.dL[:, 1:] >= out.dL[:, :-1]).all()
    return out


def _ascending_then_fillers(dl: torch.Tensor, weight: torch.Tensor) -> None:
    """Each row's samples with weight ascend in dl and come first; only
    weightless fillers follow them."""
    real = weight > 0
    assert real.any()
    first_filler = torch.where(real.all(dim=1), real.shape[1],
                               torch.argmin(real.int(), dim=1))
    cols = torch.arange(real.shape[1])[None]
    assert torch.equal(real, cols < first_filler[:, None])
    step_ok = (dl[:, 1:] >= dl[:, :-1]) | ~real[:, 1:]
    assert step_ok.all()


def test_spectral_rows_ascend_in_distance():
    """After ``create`` every spectral row's dL is non-decreasing, whatever
    order the catalog gave (here shuffled)."""
    pop = _population()
    gen = torch.Generator().manual_seed(3)
    cat = make_mock_catalog(gen, pop, n_events=6, n_samples=300,
                            snr_threshold=12.0, oversample=300)
    cat = _shuffled(cat, gen)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=20_000,
                                      snr_threshold=12.0)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=48)
    hl = HyperLikelihood.create(cat, z_grids, pop,
                                SelectionFunction.create(inj, n_gen),
                                binning=False, cut_grid=None)
    assert (hl.dL[:, 1:] >= hl.dL[:, :-1]).all()


@pytest.fixture(scope="module")
def dark_hl():
    """The 'marginalized' likelihood of 8 port-generated dark-siren events
    x 256 samples, each event's samples shuffled (nside {8, 16}, 6 pixels
    asked, 48-point grids)."""
    from chimera_tpu_torch.catalog import DVdzCompleteness
    from chimera_tpu_torch.catalog.build import build_pixelated_catalog
    from chimera_tpu_torch.data.pixelize import pixelize_gw_catalog

    pop = _population()
    gen = torch.Generator().manual_seed(9)
    cat, truths = make_mock_catalog(gen, pop, n_events=8, n_samples=256,
                                    snr_threshold=12.0, sigma_sky_rad=0.03,
                                    oversample=300, return_truths=True)
    inj, n_gen = make_mock_injections(gen, pop, n_generated=20_000,
                                      snr_threshold=12.0)
    gal = make_mock_galaxies(gen, pop, truths, n_background=3000)
    cat = pixelize_gw_catalog(_shuffled(cat, gen), nside_list=[8, 16],
                              mean_npixels_event=6,
                              sky_conf=0.9)
    z_grids = compute_z_grids(pop.cosmo, cat, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=48)
    gal_cat = build_pixelated_catalog(
        gal, cat, z_grids, pop.cosmo,
        DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step", device="cpu",
                                dtype=F64), z_err=0.01)
    return HyperLikelihood.create(cat, z_grids, _population(gal_cat),
                                  SelectionFunction.create(inj, n_gen),
                                  kind="marginalized", binning=False,
                                  cut_grid=None)


def test_dark_chunk_rows_ascend_then_fillers(dark_hl):
    """K2's and K2b's chunk rows: each row's real samples ascend in dL, and
    only zero-weight fillers follow them."""
    _ascending_then_fillers(dark_hl.row_dL, dark_hl.row_inv_pe_prior)


def test_dark_pixel_rows_ascend_then_fillers(dark_hl):
    """The per-pixel rows (K1c's logical rows): the first n_real samples of
    each live row ascend in dL; the slots past them carry no weight."""
    live = dark_hl.pix_n_real > 0
    _ascending_then_fillers(dark_hl.pix_dL[live], dark_hl.pix_inv_pe_prior[live])
    cols = torch.arange(dark_hl.pix_dL.shape[1])[None]
    assert torch.equal(dark_hl.pix_inv_pe_prior > 0,
                       cols < dark_hl.pix_n_real[:, None])
