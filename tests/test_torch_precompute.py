"""The port's precompute against the JAX package, float64 on the CPU:
HEALPix in both schemes (and the port's C++ oracle), the NESTED
pixelization, ``HomogeneousCompleteness`` with its λ-gradients, the catalog
build's options (weights, mask, sumgauss='pbkg', nest, the z reshuffle, the
host engine), a float32 build's voxels, and ``log_like_batch`` of kind
'marginalized' on a catalog with the homogeneous completeness.

Data: the repo's dark-siren precision mock (``tests/data/f32_parity_dark
.npz``: 16 events x 512 samples, nside {8, 16}, 200-point grids), galaxies
drawn with numpy around its pixels, cosmologies of degree-16 series (short
``jax.grad`` compiles)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chimera_tpu import HyperLikelihood as JHL
from chimera_tpu import SelectionFunction as JSel
from chimera_tpu.catalog import DVdzCompleteness as JDVdz
from chimera_tpu.catalog import HomogeneousCompleteness as JHom
from chimera_tpu.catalog.build import build_pixelated_catalog as j_build
from chimera_tpu.catalog.build import load_pixelated_catalog as j_load
from chimera_tpu.data import pixelize as jpix
from chimera_tpu.data.structs import ThetaInjDet as JInj
from chimera_tpu.data.structs import ThetaPEDet as JTheta
from chimera_tpu.models import FLRW as JFLRW
from chimera_tpu.models import MadauDickinsonRate as JMD
from chimera_tpu.models import Population as JPop
from chimera_tpu.models import PowerLawPeak as JPLP
from chimera_tpu.ops import healpix as jhpx
from chimera_tpu_torch import HyperLikelihood, convert, native
from chimera_tpu_torch.catalog import DVdzCompleteness, HomogeneousCompleteness
from chimera_tpu_torch.catalog.build import build_pixelated_catalog
from chimera_tpu_torch.data import pixelize as tpix
from chimera_tpu_torch.models import FLRW
from chimera_tpu_torch.ops import healpix as hpx

F64 = torch.float64
CPU = torch.device("cpu")
SMALL = dict(cheb_deg=16, z_grid_res=500)
PIXEL_FIELDS = ("opt_nsides", "pixels_opt_nsides", "ra_pix", "dec_pix",
                "gw_loc2d_pdf", "pixels_pe_opt_nside", "pixel_mask")
LAMBDA = {"H0": [62.0, 70.0, 79.0], "Om0": [0.22, 0.25, 0.31]}
# the theoretical galaxy density (Mpc^-3) of the homogeneous completeness
DENSITY = 8e-8
# the JAX cosmology, jitted: its eager build is ~9 s of op-by-op compiles
_jax_flrw = jax.jit(lambda h0, om0: JFLRW.create(H0=h0, Om0=om0, **SMALL))


def _rel(got, expect):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    return float(np.max(np.abs(got - expect)) / np.max(np.abs(expect)))


def _row_rel(got, expect):
    """Largest difference relative to each row's largest |value|."""
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else got
    expect = np.asarray(expect)
    row_max = np.abs(expect).max(axis=-1, keepdims=True).clip(1e-300)
    return float(np.max(np.abs(got - expect) / row_max))


def _jax_theta(cat, fields=("m1det", "m2det", "dL", "pe_prior", "ra", "dec")
               + PIXEL_FIELDS):
    return JTheta(**{f: jnp.asarray(getattr(cat, f).numpy()) for f in fields})


def _sky_points(rng, n):
    theta = np.arccos(rng.uniform(-1.0, 1.0, n))
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    # the poles, phi = 0 and 2 pi, the equator and the cap boundaries
    edges_t = np.array([0.0, np.pi, 0.5 * np.pi, 0.5 * np.pi, np.arccos(2 / 3),
                        np.arccos(-2 / 3), 1e-12, np.pi - 1e-12])
    edges_p = np.array([0.0, 0.0, 0.0, 2.0 * np.pi, 0.25 * np.pi, np.pi,
                        1.0, 2.0])
    return np.concatenate([theta, edges_t]), np.concatenate([phi, edges_p])


def _inside(bounds, theta_c, phi_c, frac=1e-6):
    """Boundary points moved ``frac`` of the way to their pixel's centre."""
    b_t, b_p = bounds
    dphi = torch.remainder(b_p - phi_c[:, None] + np.pi, 2 * np.pi) - np.pi
    return (b_t + (theta_c[:, None] - b_t) * frac,
            torch.remainder(phi_c[:, None] + dphi * (1 - frac), 2 * np.pi))


@pytest.fixture(scope="module")
def dark():
    cat, z_grids, gal_cat, inj, n_gen = chip_smoke.parity_dark_mock(CPU)
    jc = _jax_flrw(70.0, 0.25)
    tc = FLRW.from_state(convert.state_from_reference(jc), device=CPU)
    rng = np.random.default_rng(5)
    mask = cat.pixel_mask.numpy()
    ra_c, dec_c = cat.ra_pix.numpy()[mask], cat.dec_pix.numpy()[mask]
    k = rng.integers(0, ra_c.size, 4000)
    ra = np.concatenate([ra_c[k] + rng.normal(0.0, 0.04, 4000),
                         rng.uniform(0.0, 2.0 * np.pi, 2000)]) % (2.0 * np.pi)
    dec = np.clip(np.concatenate([dec_c[k] + rng.normal(0.0, 0.04, 4000),
                                  np.arcsin(rng.uniform(-1.0, 1.0, 2000))]),
                  -1.5, 1.5)
    z = rng.uniform(0.01, 1.2, ra.size)
    galaxies = {"ra": ra, "dec": dec, "z": z}
    weights = rng.uniform(0.1, 3.0, ra.size)
    gal_mask = rng.uniform(size=ra.size) > 0.2
    jh = jax.jit(lambda zz, ww: JHom.create(
        zz, lambda x: DENSITY * (1.0 + x), jc, sky_area_deg2=41253.0,
        z_range=(0.005, 6.0), n_bins=30, weights=ww, smooth_sigma_bins=1.5))(
            jnp.asarray(z), jnp.asarray(weights))
    th = HomogeneousCompleteness.create(
        torch.tensor(z), lambda zz: DENSITY * (1.0 + zz), tc,
        sky_area_deg2=41253.0, z_range=(0.005, 6.0), n_bins=30,
        weights=torch.tensor(weights), smooth_sigma_bins=1.5)
    return dict(cat=cat, z_grids=z_grids, inj=inj, n_gen=n_gen, jc=jc, tc=tc,
                galaxies=galaxies, weights=weights, gal_mask=gal_mask, jh=jh,
                th=th)


def _nest_theta(cat):
    """The catalog's RING pixelization re-indexed to NESTED."""
    ns = cat.opt_nsides

    def to_nest(p):
        out = p.clone()
        for n in ns.unique().tolist():
            sel = ns == n
            out[sel] = hpx.ring2nest(int(n), p[sel].clamp_min(0))
        return out

    pix = torch.where(cat.pixel_mask, to_nest(cat.pixels_opt_nsides),
                      cat.pixels_opt_nsides)
    return cat.update(pixels_opt_nsides=pix,
                      pixels_pe_opt_nside=to_nest(cat.pixels_pe_opt_nside))


# ---------------------------------------------------------------------------
# HEALPix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nside", [1, 8192])
def test_healpix_matches_jax(nside):
    """ang2pix, pix2ang, ring2nest, nest2ring and convert_pixelization give
    the JAX package's integers and angles within 1e-14 (random points, the
    poles, phi = 0 and 2 pi, the caps' edges); boundaries within 1e-14, and
    each pixel's corners, pulled 1e-6 towards its centre, in the pixel."""
    rng = np.random.default_rng(nside)
    theta, phi = _sky_points(rng, 4000)
    for nest in (False, True):
        expect = np.asarray(jhpx.ang2pix(nside, jnp.asarray(theta),
                                         jnp.asarray(phi), nest=nest))
        got = hpx.ang2pix(nside, torch.tensor(theta), torch.tensor(phi), nest=nest)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), expect)
        pix = np.unique(np.concatenate([expect, [0, 12 * nside * nside - 1]]))
        t_j, p_j = jhpx.pix2ang(nside, jnp.asarray(pix), nest=nest)
        t_t, p_t = hpx.pix2ang(nside, torch.tensor(pix), nest=nest)
        assert np.abs(t_t.numpy() - np.asarray(t_j)).max() <= 1e-14
        assert np.abs(p_t.numpy() - np.asarray(p_j)).max() <= 1e-14
        b_j = jhpx.boundaries(nside, jnp.asarray(pix[:200]), step=2, nest=nest)
        b_t = hpx.boundaries(nside, torch.tensor(pix[:200]), step=2, nest=nest)
        for a, b in zip(b_j, b_t):
            assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-14
        # the corners and edge points pulled 1e-6 of the way to the centre
        # land in their own pixel (a point on an edge belongs to either side:
        # its pixel depends on the last bit of cos)
        th_in, ph_in = _inside(b_t, t_t[:200], p_t[:200])
        np.testing.assert_array_equal(
            hpx.ang2pix(nside, th_in, ph_in, nest=nest).numpy(),
            np.broadcast_to(pix[:200, None], th_in.shape))
    for fn in ("ring2nest", "nest2ring"):
        np.testing.assert_array_equal(
            getattr(hpx, fn)(nside, torch.tensor(pix)).numpy(),
            np.asarray(getattr(jhpx, fn)(nside, jnp.asarray(pix))))
    out = max(1, nside // 2)
    for nest_in, nest_out in ((False, True), (True, False)):
        np.testing.assert_array_equal(
            hpx.convert_pixelization(torch.tensor(pix), nside, out, nest_in,
                                     nest_out).numpy(),
            np.asarray(jhpx.convert_pixelization(jnp.asarray(pix), nside, out,
                                                 nest_in, nest_out)))
    assert hpx.npix2nside(12 * nside * nside) == nside


def test_healpix_native_oracle_and_galactic():
    """The port's C++ copy against the tensor HEALPix in both schemes
    (integers equal, angles within 1e-15), galactic_to_equatorial against
    the JAX package's, npix2nside's refusal."""
    assert native.available()
    rng = np.random.default_rng(11)
    for nside in (1, 4, 64, 8192):
        theta, phi = _sky_points(rng, 20_000)
        for nest in (False, True):
            pix = hpx.ang2pix(nside, torch.tensor(theta), torch.tensor(phi), nest)
            np.testing.assert_array_equal(
                pix.numpy(), native.ang2pix(nside, theta, phi, nest))
            got = hpx.pix2ang(nside, pix, nest)
            for a, b in zip(got, native.pix2ang(nside, pix.numpy(), nest)):
                assert np.abs(a.numpy() - b).max() <= 1e-15
            got = hpx.boundaries(nside, pix[:300], step=3, nest=nest)
            for a, b in zip(got, native.boundaries(nside, pix[:300].numpy(), 3,
                                                   nest)):
                assert np.abs(a.numpy() - b).max() <= 1e-15
    lon, lat = rng.uniform(0, 2 * np.pi, 500), rng.uniform(-1.5, 1.5, 500)
    expect = jhpx.galactic_to_equatorial(jnp.asarray(lon), jnp.asarray(lat))
    got = hpx.galactic_to_equatorial(torch.tensor(lon), torch.tensor(lat))
    for a, b in zip(got, expect):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-14
    with pytest.raises(ValueError):
        hpx.npix2nside(100)


def test_nest_pixelization_matches_jax(dark):
    """``pixelize_gw_catalog(nest=True)`` on 4 events gives the JAX
    package's pixel sets, sample pixels and nsides, and its centres and
    localization pdfs within 1e-10."""
    cat = dark["cat"]
    sub = cat.update(**{f: getattr(cat, f)[:4, :256] for f in
                        ("m1det", "m2det", "dL", "pe_prior", "ra", "dec")})
    sub = sub.update(**{f: None for f in PIXEL_FIELDS})
    got = tpix.pixelize_gw_catalog(sub, [8, 16], 6, nest=True)
    expect = jpix.pixelize_gw_catalog(
        _jax_theta(sub, ("m1det", "m2det", "dL", "pe_prior", "ra", "dec")),
        [8, 16], 6, nest=True)
    for f in ("opt_nsides", "pixels_opt_nsides", "pixels_pe_opt_nside",
              "pixel_mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(expect, f)), err_msg=f)
    for f in ("ra_pix", "dec_pix", "gw_loc2d_pdf"):
        assert _rel(getattr(got, f), getattr(expect, f)) <= 1e-10, f
    ring = tpix.pixelize_gw_catalog(sub, [8, 16], 6)
    for e in range(4):
        ns = int(got.opt_nsides[e])
        m = got.pixel_mask[e]
        np.testing.assert_array_equal(
            np.sort(hpx.nest2ring(ns, got.pixels_opt_nsides[e][m]).numpy()),
            np.sort(ring.pixels_opt_nsides[e][ring.pixel_mask[e]].numpy()))


# ---------------------------------------------------------------------------
# HomogeneousCompleteness
# ---------------------------------------------------------------------------

def test_homogeneous_completeness_matches_jax(dark):
    """The table, P_compl on the grids, and p_bkg and fR of a batch of 3 λ
    (the port's batched cosmology) within 1e-10 of the JAX package's, one
    λ at a time; their gradients in (H0, Om0) within 1e-9 of jax.grad."""
    jh, th, zg = dark["jh"], dark["th"], dark["z_grids"]
    for f in ("z_table", "completeness", "n_theo_table", "z_min", "z_max"):
        np.testing.assert_allclose(getattr(th, f).numpy(),
                                   np.asarray(getattr(jh, f)), rtol=1e-12,
                                   atol=1e-300, err_msg=f)
    assert 0.3 < float(th.completeness.max()) <= 1.0
    assert _rel(th.P_compl(zg), jh.P_compl(jnp.asarray(zg.numpy()))) <= 1e-10
    z = zg[:4, ::7]
    lam = {k: torch.tensor(v, dtype=F64, requires_grad=True)
           for k, v in LAMBDA.items()}
    tc = FLRW.create(**lam, **SMALL, device=CPU)
    p_bkg, fr = th.p_bkg(tc, z[None]), th.fR(tc)
    assert p_bkg.shape == (3, *z.shape) and fr.shape == (3,)
    zj = jnp.asarray(z.numpy())

    @jax.jit
    def jax_terms(h0, om0):
        jc = JFLRW.create(H0=h0, Om0=om0, **SMALL)
        return jnp.sum(jh.p_bkg(jc, zj)), jh.fR(jc), jh.p_bkg(jc, zj)

    grads = jax.jit(jax.jacrev(lambda h, o: jax_terms(h, o)[:2], argnums=(0, 1)))
    for i in range(3):
        h0, om0 = LAMBDA["H0"][i], LAMBDA["Om0"][i]
        s_j, f_j, p_j = jax_terms(h0, om0)
        assert _rel(p_bkg[i], p_j) <= 1e-10
        assert abs(fr[i].item() - float(f_j)) <= 1e-10 * abs(float(f_j))
        (ds_h, ds_o), (df_h, df_o) = grads(h0, om0)
        for out, expect in ((p_bkg[i].sum(), (ds_h, ds_o)), (fr[i], (df_h, df_o))):
            g = torch.autograd.grad(out, (lam["H0"], lam["Om0"]), retain_graph=True)
            # relative to the larger slope: both are normalized over the
            # table, so H0 scales out and its slope is rounding
            scale = max(abs(float(e)) for e in expect)
            assert scale > 0
            for gi, ei in zip(g, expect):
                assert abs(gi[i].item() - float(ei)) <= 1e-9 * scale


# ---------------------------------------------------------------------------
# the catalog build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ring", "ring_options", "nest_options"])
def test_build_matches_jax(dark, case, tmp_path):
    """The device engine against the JAX build (p_cat within 1e-10 of the
    largest value, n_gal equal), with the options: luminosity weights, a
    galaxy mask, sumgauss='pbkg' with the homogeneous completeness, the
    z reshuffle seed, NESTED pixels; against the port's host engine; its
    ``out_file`` read by the JAX package's ``load_pixelated_catalog``."""
    cat = _nest_theta(dark["cat"]) if case.startswith("nest") else dark["cat"]
    nest = case.startswith("nest")
    kw = dict(nest=nest)
    if case.endswith("options"):
        kw.update(weights=dark["weights"], mask=dark["gal_mask"],
                  sumgauss="pbkg", z_reshuffle_seed=3, z_err=0.015)
    gal, zg = dark["galaxies"], dark["z_grids"]
    expect = j_build(gal, _jax_theta(cat, PIXEL_FIELDS), jnp.asarray(zg.numpy()),
                     dark["jc"], dark["jh"], **kw)
    out_file = str(tmp_path / "cat.h5")
    got = build_pixelated_catalog(gal, cat, zg, dark["tc"], dark["th"],
                                  out_file=out_file, **kw)
    saved = j_load(out_file, dark["jh"])
    for f in ("p_cat", "P_compl", "pixel_mask", "n_gal"):
        np.testing.assert_array_equal(np.asarray(getattr(saved, f)),
                                      getattr(got, f).numpy())
    host = build_pixelated_catalog(gal, cat, zg, dark["tc"], dark["th"],
                                   engine="host", **kw)
    assert _rel(got.p_cat, expect.p_cat) <= 1e-10
    assert _rel(got.P_compl, expect.P_compl) <= 1e-10
    np.testing.assert_array_equal(got.n_gal.numpy(), np.asarray(expect.n_gal))
    assert int(got.n_gal.sum()) > 1000
    assert _rel(host.p_cat, got.p_cat) <= 1e-10
    assert torch.equal(host.n_gal, got.n_gal)


def test_float32_build_keeps_the_float64_voxels(dark):
    """Galaxies within a float32 ulp of the nside-16 pixels' edges: the
    float32 build indexes them from float64 angles, so it gives the float64
    build's n_gal and the JAX build's p_cat within 1e-5 of each row's
    largest value (a galaxy moved to the next pixel moves its rows by
    O(1))."""
    cat, zg = dark["cat"], dark["z_grids"]
    rng = np.random.default_rng(7)
    ras, decs, zs = [], [], []
    for e in torch.nonzero(cat.opt_nsides == 16)[:, 0].tolist():
        pix = cat.pixels_opt_nsides[e][cat.pixel_mask[e]].numpy()
        b_t, b_p = (np.asarray(b).ravel() for b in
                    jhpx.boundaries(16, jnp.asarray(pix), step=6))
        n = b_t.size

        def nudge():
            return rng.choice([-1.0, 1.0], n) * rng.uniform(1e-8, 4e-8, n)

        ras.append((b_p + nudge()) % (2.0 * np.pi))
        decs.append(0.5 * np.pi - b_t + nudge())
        g = zg[e].numpy()
        zs.append(rng.uniform(g[0] + 0.1 * (g[-1] - g[0]),
                              g[-1] - 0.1 * (g[-1] - g[0]), n))
    gal = {"ra": np.concatenate(ras), "dec": np.concatenate(decs),
           "z": np.concatenate(zs)}
    jc = dark["jc"]
    expect = j_build(gal, _jax_theta(cat, PIXEL_FIELDS), jnp.asarray(zg.numpy()),
                     jc, JDVdz.create(z_range=(0.0, 3.0)))
    state = convert.state_from_reference(jc)
    builds = {}
    for dtype in (torch.float64, torch.float32):
        builds[dtype] = build_pixelated_catalog(
            gal, cat, zg.to(dtype), FLRW.from_state(state, device=CPU, dtype=dtype),
            DVdzCompleteness.create(z_range=(0.0, 3.0), device=CPU, dtype=dtype))
    np.testing.assert_array_equal(builds[torch.float32].n_gal.numpy(),
                                  np.asarray(expect.n_gal))
    assert torch.equal(builds[torch.float32].n_gal, builds[torch.float64].n_gal)
    assert _row_rel(builds[torch.float64].p_cat, expect.p_cat) <= 1e-12
    assert _row_rel(builds[torch.float32].p_cat, expect.p_cat) <= 1e-5


# ---------------------------------------------------------------------------
# the likelihood on the homogeneous completeness
# ---------------------------------------------------------------------------

def test_log_like_batch_homogeneous_matches_jax(dark):
    """Kind 'marginalized' (unbinned, cut_grid=None) on a catalog built
    with sumgauss='pbkg' and the homogeneous completeness, 16 events x 128
    samples: the port's ``from_state`` of the JAX object (the completeness
    carried by ``convert``) within 1e-10 of the JAX package's log L over a
    batch in (H0, Om0), and its own build (``create``) the same."""
    cat, zg, inj = dark["cat"], dark["z_grids"], dark["inj"]
    sub = cat.update(**{f: getattr(cat, f)[:, :128] for f in
                        ("m1det", "m2det", "dL", "pe_prior", "ra", "dec",
                         "pixels_pe_opt_nside")})
    jtheta = _jax_theta(sub)
    jcat = j_build(dark["galaxies"], jtheta, jnp.asarray(zg.numpy()), dark["jc"],
                   dark["jh"], sumgauss="pbkg")
    jmass = jax.jit(lambda: JPLP.create(window_deg=16, grid_res=300))()
    jpop = JPop.create(dark["jc"], jmass, JMD.create(), gal_cat=jcat)
    jsel = JSel.create(JInj(**{f: jnp.asarray(getattr(inj, f).numpy()) for f in
                               ("m1det", "m2det", "dL", "p_draw")}),
                       float(dark["n_gen"]))
    jhl = JHL.create(jtheta, jnp.asarray(zg.numpy()), jpop, jsel,
                     kind="marginalized", binning=False, cut_grid=None,
                     kde_engine="xla")
    expect = np.asarray(jhl.log_like_batch({k: jnp.asarray(v)
                                            for k, v in LAMBDA.items()}))
    state = convert.state_from_reference(jhl)
    hl = HyperLikelihood.from_state(state, CPU, F64)
    assert type(hl.population.gal_cat.completeness) is HomogeneousCompleteness
    got = hl.log_like_batch({k: torch.tensor(v, dtype=F64)
                             for k, v in LAMBDA.items()})
    assert np.all(np.isfinite(expect))
    assert _rel(got, expect) <= 1e-10
    assert np.max(np.abs(got.numpy() - expect) / np.abs(expect)) <= 1e-10
    # the port's own build and create on the same inputs
    own_cat = build_pixelated_catalog(dark["galaxies"], sub, zg, dark["tc"],
                                      dark["th"], sumgauss="pbkg")
    own = HyperLikelihood.create(
        sub, zg, hl.population.__class__.create(
            hl.population.cosmo, hl.population.mass, hl.population.rate,
            gal_cat=own_cat), hl.selection, kind="marginalized",
        binning=False, cut_grid=None)
    got = own.log_like_batch({k: torch.tensor(v, dtype=F64)
                              for k, v in LAMBDA.items()})
    assert np.max(np.abs(got.numpy() - expect) / np.abs(expect)) <= 1e-10
