"""HDF5 files between the JAX package and the port, in both directions:
pixelated GW catalogs, PE samples, injections, galaxy catalogs, precomputed
pixelated catalogs, chain files and HMC checkpoints (one package writes
into ``tmp_path``, the other reads, the arrays equal); the random stream
restored from a port checkpoint; and the port's file modules importing
without ``h5py`` (the H100 machine has none).

Data: the repo's dark-siren precision mock (``tests/data/f32_parity_dark
.npz``) and small numpy arrays."""

import subprocess
import sys
import types

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chimera_tpu.catalog import DVdzCompleteness as JDVdz
from chimera_tpu.catalog import build as jbuild
from chimera_tpu.catalog.pixelated import PixelatedCatalog as JPixCat
from chimera_tpu.data import io as jio
from chimera_tpu.data.structs import ThetaPEDet as JTheta
from chimera_tpu.inference import checkpoint as jck
from chimera_tpu.inference.ensemble import EnsembleState as JEnsembleState
from chimera_tpu.inference.hmc import HMCState as JHMCState
from chimera_tpu_torch.catalog import DVdzCompleteness
from chimera_tpu_torch.catalog import build as tbuild
from chimera_tpu_torch.data import io as tio
from chimera_tpu_torch.inference import EnsembleState, checkpoint as tck
from chimera_tpu_torch.inference.hmc import HMCState

CPU = torch.device("cpu")
PE_FIELDS = tio.THETA_PE_PIXELATED_DATASETS + ["pixel_mask"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b, err_msg=""):
    np.testing.assert_array_equal(_np(a), _np(b), err_msg=err_msg)


@pytest.fixture(scope="module")
def dark():
    cat, z_grids, gal_cat, inj, n_gen = chip_smoke.parity_dark_mock(CPU)
    jtheta = JTheta(**{f: jnp.asarray(getattr(cat, f).numpy())
                       for f in PE_FIELDS if getattr(cat, f) is not None
                       and f not in ("theta", "phi")},
                    theta=jnp.asarray(0.5 * np.pi - cat.dec.numpy()),
                    phi=jnp.asarray(cat.ra.numpy()))
    cat = cat.update(theta=torch.as_tensor(np.array(jtheta.theta)),
                     phi=torch.as_tensor(np.array(jtheta.phi)))
    return cat, jtheta, gal_cat


def _raw_files(tmp_path):
    """PE samples, injections and galaxies in the reference schema, each
    written by the other package's generic writer
    (``save_attrs_datasets``)."""
    rng = np.random.default_rng(3)
    pe = {"dL": rng.uniform(0.5, 3.0, (6, 40)), "m1det": rng.uniform(20, 60, (6, 40)),
          "m2det": rng.uniform(5, 20, (6, 40)), "phi": rng.uniform(0, 6, (6, 40)),
          "theta": rng.uniform(0.1, 3.0, (6, 40))}
    z = rng.uniform(0.01, 1.0, 500)
    inj = {"m1src": rng.uniform(20, 60, 500), "m2src": rng.uniform(5, 20, 500),
           "z": z, "dL": rng.uniform(0.1, 5.0, 500),
           "SNR_net": rng.uniform(5, 30, 500),
           "log_p_draw_nospin": rng.normal(-5, 1, 500)}
    gal = {"ra_gal": rng.uniform(0, 360, 300), "dec_gal": rng.uniform(-80, 80, 300),
           "z_cgal": rng.uniform(0, 1, 300)}
    return pe, inj, gal


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_data_files_round_trip(dark, tmp_path, writer):
    """Pixelated GW catalogs (-100 sentinels <-> masks), PE samples with an
    event and sample selection, injections with an SNR cut and a
    subselection, galaxy catalogs in degrees: written by one package, read
    by the other with equal arrays."""
    cat, jtheta, _ = dark
    write_io, read_io = (jio, tio) if writer == "jax" else (tio, jio)
    fname = str(tmp_path / "pix.h5")
    write_io.save_pixelated_gw_catalog(jtheta if writer == "jax" else cat, fname)
    with h5py.File(fname) as f:
        pad = f["ra_pix"][:][~cat.pixel_mask.numpy()]
        assert pad.size and np.all(pad == -100.0)
    kw = {"device": CPU} if writer == "jax" else {}
    got = read_io.load_pixelated_gw_catalog(fname, **kw)
    for f in PE_FIELDS:
        mask = cat.pixel_mask.numpy()
        a, b = _np(getattr(got, f)), _np(getattr(cat, f))
        if a.shape == mask.shape and f != "pixel_mask":
            a, b = a[mask], b[mask]
        np.testing.assert_array_equal(a, b, err_msg=f)

    pe, inj, gal = _raw_files(tmp_path)
    for name, data in (("pe", {"posteriors": pe}), ("inj", inj), ("gal", gal)):
        obj = types.SimpleNamespace(**data)
        write_io.save_attrs_datasets(
            obj, str(tmp_path / f"{name}.h5"),
            datasets=() if name == "pe" else tuple(data),
            groups=("posteriors",) if name == "pe" else ())
    j_pe = jio.load_gw_pe_samples(str(tmp_path / "pe.h5"), nevents=4, nsamples=30,
                                  rng=np.random.default_rng(9))
    t_pe = tio.load_gw_pe_samples(str(tmp_path / "pe.h5"), nevents=4, nsamples=30,
                                  rng=np.random.default_rng(9), device=CPU)
    for f in ("dL", "m1det", "m2det", "ra", "dec", "pe_prior"):
        _same(getattr(t_pe, f), getattr(j_pe, f), f)
    j_inj, j_n = jio.load_injection_data(str(tmp_path / "inj.h5"), snr_cut=12.0,
                                         ninj=100, rng=np.random.default_rng(4))
    t_inj, t_n = tio.load_injection_data(str(tmp_path / "inj.h5"), snr_cut=12.0,
                                         ninj=100, rng=np.random.default_rng(4),
                                         device=CPU)
    assert t_n == j_n == 100
    for f in ("m1det", "m2det", "dL", "p_draw"):
        _same(getattr(t_inj, f), getattr(j_inj, f), f)
    j_gal = jio.load_galaxy_catalog(str(tmp_path / "gal.h5"))
    t_gal = tio.load_galaxy_catalog(str(tmp_path / "gal.h5"), device=CPU)
    for f in ("ra", "dec", "z"):
        _same(t_gal[f], j_gal[f], f)
    assert tio.load_data_h5(str(tmp_path / "gal.h5"), device="numpy").keys() == \
        set(gal)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pixelated_catalog_round_trip(dark, tmp_path, writer):
    """A precomputed pixelated catalog (p_cat, P_compl, pixel_mask, n_gal)
    saved by one package and loaded by the other."""
    _, _, gal_cat = dark
    fname = str(tmp_path / "cat.h5")
    if writer == "jax":
        jbuild.save_pixelated_catalog(fname, JPixCat(
            p_cat=jnp.asarray(gal_cat.p_cat.numpy()),
            P_compl=jnp.asarray(gal_cat.P_compl.numpy()),
            pixel_mask=jnp.asarray(gal_cat.pixel_mask.numpy()),
            n_gal=jnp.asarray(gal_cat.n_gal.numpy())))
        got = tbuild.load_pixelated_catalog(
            fname, DVdzCompleteness.create(z_range=(0.0, 3.0), device=CPU),
            device=CPU)
    else:
        tbuild.save_pixelated_catalog(fname, gal_cat)
        got = jbuild.load_pixelated_catalog(fname, JDVdz.create(z_range=(0.0, 3.0)))
    for f in ("p_cat", "P_compl", "pixel_mask", "n_gal"):
        _same(getattr(got, f), getattr(gal_cat, f), f)


def _history(rng, steps=3, walkers=8, dim=2):
    return {"coords": rng.normal(size=(steps, walkers, dim)),
            "log_prob": rng.normal(size=(steps, walkers))}


def test_chain_files_between_packages(tmp_path):
    """Chain files: the JAX package's (with its PRNG key) read by the
    port's ``load_chain`` and ``load_state`` (no generator state); the
    port's (with its generator's state, no ``state/key``) read by the JAX
    package's ``load_chain``; the numbering helpers on both."""
    rng = np.random.default_rng(1)
    hist = _history(rng)
    prefix = str(tmp_path / "run")
    jstate = JEnsembleState(coords=jnp.asarray(rng.normal(size=(8, 2))),
                            log_prob=jnp.asarray(rng.normal(size=8)),
                            key=jax.random.PRNGKey(3),
                            n_accepted=jnp.arange(8), iteration=jnp.asarray(7))
    path = tck.next_chain_file(prefix)
    assert path == jck.next_chain_file(prefix) == prefix + "_0.h5"
    jck.save_chain(path, jstate, hist, ["H0", "Om0"])
    got = tck.load_chain(path)
    _same(got["chain"], hist["coords"])
    _same(got["log_prob"], hist["log_prob"])
    assert got["param_names"] == ["H0", "Om0"]
    state, names, gen_state = tck.load_state(path, device=CPU)
    assert gen_state is None and names == ["H0", "Om0"] and state.iteration == 7
    for f in ("coords", "log_prob", "n_accepted"):
        _same(getattr(state, f), getattr(jstate, f), f)

    gen = torch.Generator().manual_seed(5)
    tstate = EnsembleState(torch.tensor(rng.normal(size=(8, 2))),
                           torch.tensor(rng.normal(size=8)),
                           torch.arange(8), 4)
    path = tck.next_chain_file(prefix)
    assert path == prefix + "_1.h5" == jck.next_chain_file(prefix)
    tck.save_chain(path, tstate, {k: torch.tensor(v) for k, v in hist.items()},
                   ["H0", "Om0"], generator=gen)
    assert tck.latest_chain_file(prefix) == jck.latest_chain_file(prefix) == path
    got = jck.load_chain(path)
    _same(got["chain"], hist["coords"])
    _same(got["log_prob"], hist["log_prob"])
    with h5py.File(path) as f:
        assert "key" not in f["state"] and tck.GENERATOR_KEY in f["state"]


def test_hmc_checkpoints_between_packages(tmp_path):
    """HMC checkpoints: the JAX package's read by the port's ``load_hmc``
    (no generator state); the port's read by the JAX package's generic
    ``load_attrs_datasets`` (its ``load_hmc`` needs a PRNG key, which the
    port never writes)."""
    rng = np.random.default_rng(2)
    y, logp, grad = rng.normal(size=(4, 2)), rng.normal(size=4), rng.normal(size=(4, 2))
    samples, lp = rng.normal(size=(5, 4, 2)), rng.normal(size=(5, 4))
    stats = {"final_state": JHMCState(y=jnp.asarray(y), logp=jnp.asarray(logp),
                                      grad=jnp.asarray(grad)),
             "log_prob": jnp.asarray(lp), "step_size": jnp.asarray(0.03),
             "inv_mass": jnp.asarray([1.0, 2.0])}
    path = str(tmp_path / "hmc_jax.h5")
    jck.save_hmc(path, jnp.asarray(samples), stats, jax.random.PRNGKey(0),
                 ["H0", "Om0"])
    state, eps, inv_mass, gen_state, names = tck.load_hmc(path, device=CPU)
    assert gen_state is None and names == ["H0", "Om0"]
    _same(state.y, y)
    _same(state.logp, logp)
    _same(state.grad, grad)
    assert float(eps) == 0.03
    _same(inv_mass, [1.0, 2.0])

    gen = torch.Generator().manual_seed(11)
    tstats = {"final_state": HMCState(torch.tensor(y), torch.tensor(logp),
                                      torch.tensor(grad)),
              "log_prob": torch.tensor(lp), "step_size": torch.tensor(0.03),
              "inv_mass": torch.tensor([1.0, 2.0])}
    path = str(tmp_path / "hmc_port.h5")
    tck.save_hmc(path, torch.tensor(samples), tstats, gen, ["H0", "Om0"])
    arrays = {"samples": samples, "log_prob": lp, "state/y": y,
              "state/logp": logp, "state/grad": grad,
              "state/inv_mass": [1.0, 2.0]}
    got = jio.load_attrs_datasets(path, attrs=("param_names",),
                                  datasets=tuple(arrays))
    for k, v in arrays.items():
        _same(got[k], v, k)
    with h5py.File(path) as f:
        assert f["state/step_size"][()] == 0.03 and "key" not in f["state"]
    with pytest.raises(KeyError):
        jck.load_hmc(path)


def test_port_checkpoint_restores_the_stream(tmp_path):
    """A port checkpoint carries its generator: the stream resumed from the
    file continues with the same draws as the original generator (port to
    port)."""
    gen = torch.Generator().manual_seed(123)
    torch.rand(17, generator=gen)
    state = EnsembleState(torch.zeros(4, 2), torch.zeros(4),
                          torch.zeros(4, dtype=torch.int64), 0)
    path = str(tmp_path / "c_0.h5")
    tck.save_chain(path, state, {"coords": torch.zeros(1, 4, 2),
                                 "log_prob": torch.zeros(1, 4)}, ["a", "b"],
                   generator=gen)
    expect = torch.rand(5, generator=gen)
    _, _, gen_state = tck.load_state(path, device=CPU)
    resumed = torch.Generator()
    resumed.set_state(gen_state)
    assert torch.equal(torch.rand(5, generator=resumed), expect)
    hmc = str(tmp_path / "h.h5")
    tck.save_hmc(hmc, torch.zeros(1, 4, 2), {
        "final_state": HMCState(torch.zeros(4, 2), torch.zeros(4), torch.zeros(4, 2)),
        "log_prob": torch.zeros(1, 4), "step_size": torch.tensor(0.1),
        "inv_mass": torch.ones(2)}, resumed, ["a", "b"])
    expect = torch.rand(3, generator=resumed)
    again = torch.Generator()
    again.set_state(tck.load_hmc(hmc, device=CPU)[3])
    assert torch.equal(torch.rand(3, generator=again), expect)


def test_file_modules_import_without_h5py_and_matplotlib():
    """``data.io``, ``inference.checkpoint``, ``runconfig`` and the
    plotting module import with h5py and matplotlib hidden, and pull in
    neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "sys.modules['matplotlib'] = None\n"
        "import chimera_tpu_torch.data.io, chimera_tpu_torch.inference.checkpoint\n"
        "import chimera_tpu_torch.runconfig, chimera_tpu_torch.utils.plotting\n"
        "import chimera_tpu_torch.catalog.build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'chimera_tpu' or m.startswith('chimera_tpu.')]\n"
        "assert not bad, bad\n"
        "try:\n"
        "    chimera_tpu_torch.data.io.load_data_h5('x.h5', device='cpu')\n"
        "except ImportError:\n"
        "    print('raised')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "raised"
