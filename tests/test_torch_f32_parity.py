"""The port's float32 against the repo's 1e-6 bar on the repo's own
dark-siren precision mock, the data of
``tests/test_f32_parity.py::test_f32_dark_siren_parity`` (16 events x 512
samples, nside {8, 16}, 6 pixels asked, 200-point z-grids, 10 000
background galaxies, 100 000 generated injections, 7 H0 values in
[58, 100]).

The mock is built here with the JAX package and kept in
``tests/data/f32_parity_dark.npz``, which ``chip_smoke.py`` phase 9 holds
to the same bar on the card (it imports no JAX).  Rewrite the file with

    PYTHONPATH=. python tests/test_torch_f32_parity.py

The reference-default configuration (``binning=True, cut_grid=2.0``) has a
float32 bar of its own: binning moves a sample into the neighbouring bin
when its float32 z lies within rounding of a bin edge.  The JAX package's
own float32-vs-float64 gap on the repo's two precision mocks (this dark one
and the 64 x 1024 x 300 spectral one of ``test_f32_loglike_parity``), and
that of kind 'full' (cut_grid=2.0) on this dark one, is measured by

    PYTHONPATH=. python tests/test_torch_f32_parity.py --reference-gap

and the port's float32 is held to max(1e-6, 2 x that gap)
(``chip_smoke.BINNED_F32_BAR``) here and on the card; 'full''s gap is below
1e-6, and its bar stays the repo's (``chip_smoke.FULL_F32_BAR``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

MOCK = Path(__file__).resolve().parent / "data" / "f32_parity_dark.npz"
H0S = np.linspace(58.0, 100.0, 7)


def reference_dark_mock(pop) -> dict:
    """The arrays ``test_f32_dark_siren_parity`` builds and hands to its
    float32 run, built the same way from the fiducial population."""
    from chimera_tpu.catalog import DVdzCompleteness
    from chimera_tpu.catalog.build import build_pixelated_catalog
    from chimera_tpu.data.mock import (make_mock_catalog, make_mock_galaxies,
                                       make_mock_injections)
    from chimera_tpu.data.pixelize import pixelize_gw_catalog
    from chimera_tpu.models import compute_z_grids

    theta, truths = make_mock_catalog(
        jax.random.PRNGKey(31), pop, n_events=16, n_samples=512,
        sigma_sky_rad=0.03, oversample=400, return_truths=True)
    theta = pixelize_gw_catalog(theta, nside_list=[8, 16],
                                mean_npixels_event=6, sky_conf=0.9)
    z_grids = compute_z_grids(pop.cosmo, theta, cosmo_prior={"H0": [40.0, 120.0]},
                              z_int_res=200)
    gal = make_mock_galaxies(jax.random.PRNGKey(32), pop, truths,
                             n_background=10_000)
    compl = DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step")
    gc = build_pixelated_catalog(gal, theta, z_grids, pop.cosmo, compl, z_err=0.01)
    theta_inj, n_gen = make_mock_injections(jax.random.PRNGKey(33), pop,
                                            n_generated=100_000)
    arrays = dict(
        m1=theta.m1det, m2=theta.m2det, dl=theta.dL, prior=theta.pe_prior,
        ra=theta.ra, dec=theta.dec, opt_nsides=theta.opt_nsides,
        pixels=theta.pixels_opt_nsides, ra_pix=theta.ra_pix,
        dec_pix=theta.dec_pix, loc2d=theta.gw_loc2d_pdf,
        pix_pe=theta.pixels_pe_opt_nside, pmask=theta.pixel_mask,
        p_cat=gc.p_cat, P_compl=gc.P_compl, n_gal=gc.n_gal,
        im1=theta_inj.m1det, im2=theta_inj.m2det, idl=theta_inj.dL,
        ipd=theta_inj.p_draw, zg=z_grids, n_gen=n_gen)
    return {k: np.asarray(v) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def port_data():
    return chip_smoke.parity_dark_mock(torch.device("cpu"))


def test_committed_mock_is_the_reference_mock(fiducial_population):
    expect = reference_dark_mock(fiducial_population)
    with np.load(MOCK) as got:
        assert set(got.files) == set(expect)
        for key, value in expect.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_float32_meets_the_repo_bar(port_data, fiducial_population):
    """Port float64 within 1e-10 of JAX float64 on the mock, and port float32
    (the kernels' plain versions) within 1e-6 of port float64, elementwise."""
    from chimera_tpu import HyperLikelihood as JHL
    from chimera_tpu import SelectionFunction, pytree
    from chimera_tpu.catalog import DVdzCompleteness
    from chimera_tpu.catalog.pixelated import PixelatedCatalog
    from chimera_tpu.data.structs import ThetaInjDet, ThetaPEDet

    cat, z_grids, gal_cat, inj, n_gen = port_data
    jnp_ = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    theta = ThetaPEDet(**{f: jnp_(getattr(cat, f)) for f in (
        "m1det", "m2det", "dL", "pe_prior", "ra", "dec", "opt_nsides",
        "pixels_opt_nsides", "ra_pix", "dec_pix", "gw_loc2d_pdf",
        "pixels_pe_opt_nside", "pixel_mask")})
    jgc = PixelatedCatalog(
        p_cat=jnp_(gal_cat.p_cat), P_compl=jnp_(gal_cat.P_compl),
        pixel_mask=jnp_(gal_cat.pixel_mask), n_gal=jnp_(gal_cat.n_gal),
        completeness=DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step"))
    jinj = ThetaInjDet(**{f: jnp_(getattr(inj, f)) for f in
                          ("m1det", "m2det", "dL", "p_draw")})
    jhl = JHL.create(theta, jnp_(z_grids),
                     pytree.replace(fiducial_population, gal_cat=jgc),
                     SelectionFunction.create(jinj, n_gen), kind="marginalized",
                     binning=False, cut_grid=None, kde_engine="xla")
    expect = np.asarray(jhl.log_like_batch({"H0": jnp.asarray(H0S)}))
    assert np.all(np.isfinite(expect))

    ll64 = chip_smoke.dark_likelihood(port_data, torch.float64).log_like_batch(
        {"H0": torch.as_tensor(H0S)})
    np.testing.assert_allclose(ll64.numpy(), expect, rtol=1e-10, atol=0)
    ll32 = chip_smoke.dark_likelihood(port_data, torch.float32).log_like_batch(
        {"H0": torch.as_tensor(H0S, dtype=torch.float32)})
    rel = np.abs(ll32.double().numpy() - ll64.numpy()) / np.abs(ll64.numpy())
    assert rel.max() <= 1e-6, rel


def test_full_float32_meets_its_bar(port_data):
    """Kind 'full' (cut_grid=2.0) on the mock: the port's float32 (K5's
    plain version) within ``chip_smoke.FULL_F32_BAR`` of its float64,
    elementwise, as phase 27 holds the card to it."""
    h0 = torch.as_tensor(H0S)
    ll64 = chip_smoke.dark_likelihood(port_data, torch.float64,
                                      **chip_smoke.FULL).log_like_batch({"H0": h0})
    ll32 = chip_smoke.dark_likelihood(port_data, torch.float32,
                                      **chip_smoke.FULL).log_like_batch(
        {"H0": h0.float()})
    assert torch.all(torch.isfinite(ll64))
    rel = (ll32.double() - ll64).abs() / ll64.abs()
    assert rel.max() <= chip_smoke.FULL_F32_BAR, rel


# the JAX package in float32 (x64 off, in its own process) on the arrays of
# a reference mock, binning=True and cut_grid=2.0; prints log L at H0S
_EVAL_BINNED32 = r"""
import json, sys
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
import numpy as np
sys.path.insert(0, sys.argv[4])
from test_torch_f32_parity import reference_likelihood
ll = reference_likelihood(dict(np.load(sys.argv[1])), sys.argv[2]).log_like_batch(
    {"H0": jax.numpy.linspace(58.0, 100.0, 7)})
print(json.dumps(np.asarray(ll, np.float64).tolist()))
"""


def reference_spectral_mock(pop) -> dict:
    """The arrays of ``tests/test_f32_parity.py::test_f32_loglike_parity``
    (64 events x 1024 samples, 300-point z-grids, 200 000 generated
    injections)."""
    from chimera_tpu.data.mock import make_mock_catalog, make_mock_injections
    from chimera_tpu.models import compute_z_grids

    theta = make_mock_catalog(jax.random.PRNGKey(1), pop, n_events=64,
                              n_samples=1024)
    inj, n_gen = make_mock_injections(jax.random.PRNGKey(2), pop,
                                      n_generated=200_000)
    zg = compute_z_grids(pop.cosmo, theta, cosmo_prior={"H0": [40.0, 120.0]},
                         z_int_res=300)
    arrays = dict(m1=theta.m1det, m2=theta.m2det, dl=theta.dL,
                  prior=theta.pe_prior, im1=inj.m1det, im2=inj.m2det,
                  idl=inj.dL, ipd=inj.p_draw, zg=zg, n_gen=n_gen)
    return {k: np.asarray(v) for k, v in arrays.items()}


def reference_likelihood(d: dict, kind: str):
    """The JAX likelihood of a mock's arrays in JAX's working dtype, with
    the reference's defaults (binning, cut_grid=2.0): kind '1d' on the
    spectral arrays, 'marginalized' or 'full' (which ignores binning) on
    the dark ones."""
    from chimera_tpu import HyperLikelihood as JHL
    from chimera_tpu import SelectionFunction
    from chimera_tpu.catalog import DVdzCompleteness, EmptyCatalog
    from chimera_tpu.catalog.pixelated import PixelatedCatalog
    from chimera_tpu.data.structs import ThetaInjDet, ThetaPEDet
    from chimera_tpu.models import (FLRW, MadauDickinsonRate, Population,
                                    PowerLawPeak)

    f = jnp.asarray(0.0).dtype
    arr = lambda k: jnp.asarray(d[k], f)  # noqa: E731
    theta = ThetaPEDet(m1det=arr("m1"), m2det=arr("m2"), dL=arr("dl"),
                       pe_prior=arr("prior"))
    gal_cat = EmptyCatalog()
    if kind in ("marginalized", "full"):
        theta = theta.update(
            ra=arr("ra"), dec=arr("dec"), opt_nsides=jnp.asarray(d["opt_nsides"]),
            pixels_opt_nsides=jnp.asarray(d["pixels"]), ra_pix=arr("ra_pix"),
            dec_pix=arr("dec_pix"), gw_loc2d_pdf=arr("loc2d"),
            pixels_pe_opt_nside=jnp.asarray(d["pix_pe"]),
            pixel_mask=jnp.asarray(d["pmask"]))
        gal_cat = PixelatedCatalog(
            p_cat=arr("p_cat"), P_compl=arr("P_compl"),
            pixel_mask=jnp.asarray(d["pmask"]), n_gal=jnp.asarray(d["n_gal"]),
            completeness=DVdzCompleteness.create(z_range=(0.0, 3.0), kind="step"))
    inj = ThetaInjDet(m1det=arr("im1"), m2det=arr("im2"), dL=arr("idl"),
                      p_draw=arr("ipd"))
    pop = Population.create(FLRW.create(H0=70.0, Om0=0.25), PowerLawPeak.create(),
                            MadauDickinsonRate.create(), gal_cat=gal_cat)
    return JHL.create(theta, arr("zg"), pop,
                      SelectionFunction.create(inj, float(d["n_gen"])),
                      kind=kind, kde_engine="xla")


def reference_gap(arrays: dict, kind: str, tmp: Path) -> tuple[float, list]:
    """The JAX package's float32 against its float64, elementwise relative,
    on ``arrays`` with binning=True and cut_grid=2.0; returns the largest
    gap and the float64 log L."""
    ll64 = np.asarray(reference_likelihood(arrays, kind).log_like_batch(
        {"H0": jnp.asarray(H0S)}))
    data, script = tmp / f"{kind}.npz", tmp / "eval_binned32.py"
    np.savez(data, **arrays)
    script.write_text(_EVAL_BINNED32)
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    here = Path(__file__).resolve().parent
    out = subprocess.run([sys.executable, str(script), str(data), kind,
                          str(here.parent), str(here)], check=True, env=env,
                         capture_output=True, text=True, timeout=900)
    ll32 = np.asarray(json.loads(out.stdout.strip().splitlines()[-1]))
    return float(np.max(np.abs(ll32 - ll64) / np.abs(ll64))), ll64.tolist()


if __name__ == "__main__" and "--reference-gap" in sys.argv:
    import tempfile

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from chimera_tpu.catalog import EmptyCatalog
    from chimera_tpu.models import (FLRW, MadauDickinsonRate, Population,
                                    PowerLawPeak)

    fiducial = Population.create(FLRW.create(H0=70.0, Om0=0.25),
                                 PowerLawPeak.create(), MadauDickinsonRate.create(),
                                 gal_cat=EmptyCatalog())
    with tempfile.TemporaryDirectory() as tmp, np.load(MOCK) as dark:
        for kind, arrays in (("1d", reference_spectral_mock(fiducial)),
                             ("marginalized", dict(dark)), ("full", dict(dark))):
            gap, ll64 = reference_gap(arrays, kind, Path(tmp))
            print(json.dumps({"kind": kind, "binning": True, "cut_grid": 2.0,
                              "float32_vs_float64_max_rel": gap,
                              "log_like_float64": ll64}))
    sys.exit(0)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from chimera_tpu.catalog import EmptyCatalog
    from chimera_tpu.models import (FLRW, MadauDickinsonRate, Population,
                                    PowerLawPeak)

    fiducial = Population.create(FLRW.create(H0=70.0, Om0=0.25),
                                 PowerLawPeak.create(), MadauDickinsonRate.create(),
                                 gal_cat=EmptyCatalog())
    MOCK.parent.mkdir(exist_ok=True)
    np.savez_compressed(MOCK, **reference_dark_mock(fiducial))
    print(f"wrote {MOCK} ({MOCK.stat().st_size} bytes)")
