"""The port's data pipeline against the JAX package's, on the CPU.

Catalog, splits, datasets, the native FITS loader, `XmmDataModule.loader`
and `XmmDisplayDataModule` run over the same synthetic FITS trees (written
with the port's codec, images of 30 x 28 px, HR 60 x 56) in both packages.
Bounds: samples bitwise equal, AGN and background draws included; prepared
batches within 1e-6 on [0, 1]; indices, files, batch order and weights
equal. JAX's loader takes a 1-device CPU mesh (2 devices for the world-size
comparison). Each test prints the max|diff| it measured.
"""

import importlib
import pickle
import zipfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_torch import config as tconf
from xmm_superres_denoise_torch.data import catalog as tcat
from xmm_superres_denoise_torch.data import native_loader as tnl
from xmm_superres_denoise_torch.data import splits as tsp
from xmm_superres_denoise_torch.data.datamodule import XmmDataModule as TDataModule
from xmm_superres_denoise_torch.data.datasets import BoringDataset as TBoring
from xmm_superres_denoise_torch.data.datasets import XmmDataset as TDataset
from xmm_superres_denoise_torch.data.display import XmmDisplayDataModule as TDisplay
from xmm_superres_denoise_torch.data.synthetic import write_sim_tree
from xmm_superres_denoise_torch.io.fits import read_image, write_image

jconf = importlib.import_module("xmm_superres_denoise_tpu.config")
jcat = importlib.import_module("xmm_superres_denoise_tpu.data.catalog")
jsp = importlib.import_module("xmm_superres_denoise_tpu.data.splits")
jds = importlib.import_module("xmm_superres_denoise_tpu.data.datasets")
jdm = importlib.import_module("xmm_superres_denoise_tpu.data.datamodule")
jdisp = importlib.import_module("xmm_superres_denoise_tpu.data.display")
jmesh = importlib.import_module("xmm_superres_denoise_tpu.parallel.mesh")

ROOT = Path(__file__).resolve().parents[1]
LR_HW = (30, 28)
PREP_ATOL = 1e-6
N_BASE = 20


@pytest.fixture(scope="module")
def sim_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    write_sim_tree(root, name="simds", n_base=N_BASE, lr_hw=LR_HW, n_agn=3, n_bkg=3, seed=5)
    # detector masks with a zeroed corner, at both resolutions
    for name, hw in (("mask1.fits", LR_HW), ("mask2.fits", (60, 56))):
        m = np.ones(hw, np.float32)
        m[: hw[0] // 4, : hw[1] // 3] = 0.0
        write_image(root / name, m)
    return root


@pytest.fixture(scope="module")
def real_root(tmp_path_factory):
    """A REAL layout: <dir>/<name>/<exp>ks/<base>_image_split_<k>.fits."""
    root = tmp_path_factory.mktemp("real")
    g = np.random.default_rng(9)
    for exp in (20, 50, 100):
        for i in range(12):
            for k in range(2):
                img = (g.poisson(2.0, LR_HW) / (exp * 1e3)).astype(np.float32)
                write_image(root / "realds" / f"{exp}ks" / f"obs{i:03d}_image_split_{k}.fits", img)
    return root


def _sim_kwargs(root, masks=True, batch=3):
    return dict(
        agn=1, batch_size=batch, directory=root, name="simds", scaling="sqrt", type="sim",
        lr=dict(bkg=1, exps=[20], clamp_max=0.0022336, res=32,
                det_mask=(root / "mask1.fits") if masks else None),
        hr=dict(exp=100, clamp_max=0.0005584, res=64,
                det_mask=(root / "mask2.fits") if masks else None),
    )


def _real_kwargs(root):
    return dict(
        agn=1, batch_size=4, directory=root, name="realds", scaling="log", type="real",
        lr=dict(bkg=1, exps=[20, 50], clamp_max=0.0022336, res=32),
        hr=dict(exp=100, clamp_max=0.0005584, res=64),
    )


def _cfgs(kwargs):
    def build(mod):
        kw = dict(kwargs)
        kw["lr"] = mod.LrDatasetCfg(**kw["lr"])
        kw["hr"] = mod.HrDatasetCfg(**kw["hr"])
        return mod.DatasetCfg(**kw)

    return build(tconf), build(jconf)


# --------------------------------------------------------------------------- #
# schema, catalog and splits
# --------------------------------------------------------------------------- #


def test_dataset_dirs_match_jax(sim_root, real_root):
    for kwargs in (_sim_kwargs(sim_root), _real_kwargs(real_root)):
        tc, jc = _cfgs(kwargs)
        assert tc.res_mult == jc.res_mult
        assert tc.img_dir == jc.img_dir
        if kwargs["type"] == "sim":
            assert (tc.agn_dir, tc.bkg_dir) == (jc.agn_dir, jc.bkg_dir)
        else:
            for attr in ("agn_dir", "bkg_dir"):
                with pytest.raises(tconf.ConfigError):
                    getattr(tc, attr)
                with pytest.raises(jconf.ConfigError):
                    getattr(jc, attr)


def test_bkg_dir_falls_back_to_background(tmp_path):
    (tmp_path / "ds" / "background").mkdir(parents=True)
    kw = dict(directory=tmp_path, name="ds", lr=dict(exps=[20], clamp_max=1.0, res=32))
    tc = tconf.DatasetCfg(**{**kw, "lr": tconf.LrDatasetCfg(**kw["lr"])})
    jc = jconf.DatasetCfg(**{**kw, "lr": jconf.LrDatasetCfg(**kw["lr"])})
    assert tc.bkg_dir == jc.bkg_dir == tmp_path / "ds" / "background"
    assert tc.res_mult == jc.res_mult == 1


def test_catalog_matches_jax(sim_root):
    args = (sim_root / "simds" / "img", [20], 100, "1x", "2x", tcat.SPLIT_KEY_SIM)
    ours, ref = tcat.build_catalog(*args), jcat.build_catalog(*args)
    assert ours.base_names == ref.base_names and len(ours.base_names) == N_BASE
    assert ours.lr == ref.lr and ours.hr == ref.hr


@pytest.mark.parametrize("n,fractions,seed", [(100, tsp.SIM_FRACTIONS, 0), (11, tsp.SIM_FRACTIONS, 1),
                                              (37, tsp.REAL_FRACTIONS, 4)])
def test_random_split_indices_match_jax(n, fractions, seed):
    ours, ref = tsp.random_split_indices(n, fractions, seed), jsp.random_split_indices(n, fractions, seed)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_expand_indices_offsets_by_base_count():
    base = np.array([1, 3])
    out = tsp.expand_indices(base, base_count=10, multiplicity=3)
    np.testing.assert_array_equal(out, jsp.expand_indices(base, 10, 3))
    np.testing.assert_array_equal(out, [1, 3, 11, 13, 21, 23])


def test_split_files_are_read_by_the_other_package(tmp_path):
    ours = tsp.ensure_splits(tmp_path / "t", "img.p", 50, seed=3)
    ref = jsp.ensure_splits(tmp_path / "j", "img.p", 50, seed=3)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
        assert (tmp_path / "t" / k / "img.p").read_bytes() == (tmp_path / "j" / k / "img.p").read_bytes()
    # each package reloads the other's files, not regenerated (another seed)
    for a, b in ((tsp, "j"), (jsp, "t")):
        again = a.ensure_splits(tmp_path / b, "img.p", 50, seed=999)
        for k in ref:
            np.testing.assert_array_equal(again[k], ref[k])
    with zipfile.ZipFile(tmp_path / "s.zip", "w") as z:
        for k in ref:
            z.writestr(f"sim/{k}/img.p", pickle.dumps(ref[k]))
    zo, zr = tsp.load_splits_zip(tmp_path / "s.zip"), jsp.load_splits_zip(tmp_path / "s.zip")
    assert sorted(zo) == sorted(zr)
    for k in zr:
        np.testing.assert_array_equal(zo[k], zr[k])


# --------------------------------------------------------------------------- #
# datasets and the native loader
# --------------------------------------------------------------------------- #


def test_boring_samples_are_bitwise_equal():
    ours, ref = TBoring(lr_res=16, seed=4), jds.BoringDataset(lr_res=16, seed=4)
    for i in range(3):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["sim", "real"])
def test_xmm_dataset_samples_are_bitwise_equal(kind, sim_root, real_root):
    kwargs = _sim_kwargs(sim_root) if kind == "sim" else _real_kwargs(real_root)
    tc, jc = _cfgs(kwargs)
    ours = TDataset(tc, rng=np.random.default_rng(11))
    ref = jds.XmmDataset(jc, rng=np.random.default_rng(11))
    assert len(ours) == len(ref)
    if kind == "sim":
        assert ours.agn_catalog is not None and ours.bkg_files is not None
    worst = 0.0
    for i in range(8):  # consecutive samples: the AGN and background draws advance the RNG
        for a, b in zip(ours[i], ref[i]):
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            worst = max(worst, float(np.abs(a - b).max()))
            np.testing.assert_array_equal(a, b)
    assert ours.rng.bit_generator.state == ref.rng.bit_generator.state
    print(f"{kind}: 8 samples, max|diff| {worst}")


def test_native_loader_builds_into_build_and_reads_as_the_python_reader(tmp_path):
    assert tnl.BUILD_DIR == ROOT / "build" / "native"
    if not tnl.native_available():
        pytest.fail("the native FITS reader did not build (g++ and zlib are on this machine)")
    assert tnl._LIB.parent == ROOT / "build" / "native" and tnl._LIB.exists()
    g = np.random.default_rng(1)
    for dtype, name in [(np.int16, "i16.fits"), (np.int32, "i32.fits"),
                        (np.float32, "f32.fits.gz"), (np.float64, "f64.fits")]:
        if np.issubdtype(dtype, np.integer):
            data = g.integers(-100, 1000, (37, 53)).astype(dtype)
        else:
            data = g.normal(size=(37, 53)).astype(dtype)
        p = write_image(tmp_path / name, data)
        ref, _ = read_image(p)
        native = tnl.read_image_native(p)
        np.testing.assert_array_equal(native, ref.astype(np.float32))
        np.testing.assert_array_equal(tnl.load_fits_fast(p), tnl.load_fits(p))
    paths = [write_image(tmp_path / f"b{i}.fits", g.normal(size=(9, 7)).astype(np.float32))
             for i in range(3)]
    batch = tnl.read_batch_native(paths, (9, 7), n_threads=2)
    np.testing.assert_array_equal(batch, np.stack([read_image(p)[0] for p in paths]))


# --------------------------------------------------------------------------- #
# the data module
# --------------------------------------------------------------------------- #


def _mesh(n):
    return jmesh.make_mesh(data=n, fsdp=1, devices=jax.devices()[:n])


def _modules(kwargs, tmp_path, seed=2):
    tc, jc = _cfgs(kwargs)
    ours = TDataModule(tc, splits_root=tmp_path / "ts", seed=seed, device="cpu")
    ref = jdm.XmmDataModule(jc, splits_root=tmp_path / "js", seed=seed)
    return ours, ref


def _compare(ours_batches, ref_batches):
    assert len(ours_batches) == len(ref_batches) > 0
    worst = 0.0
    for o, r in zip(ours_batches, ref_batches):
        np.testing.assert_array_equal(o["weight"].numpy(), np.asarray(r["weight"]))
        for k in ("lr", "hr"):
            a, b = o[k].numpy(), np.asarray(r[k])
            assert a.shape == b.shape and 0.0 <= a.min() and a.max() <= 1.0
            worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= PREP_ATOL
    return worst


@pytest.mark.parametrize("kind", ["sim", "real"])
def test_loader_matches_jax_batches_order_and_weights(kind, sim_root, real_root, tmp_path):
    kwargs = _sim_kwargs(sim_root) if kind == "sim" else _real_kwargs(real_root)
    ours, ref = _modules(kwargs, tmp_path)
    for k in ("train", "val", "test"):
        np.testing.assert_array_equal(ours.split_indices(k), ref.split_indices(k))
    mesh = _mesh(1)
    runs = [("train", 0), ("train", 1), ("val", 0), ("test", 0)]  # one order for both RNGs
    for split, epoch in runs:
        o = list(ours.loader(split, epoch=epoch))
        r = list(ref.loader(split, mesh=mesh, epoch=epoch))
        worst = _compare(o, r)
        print(f"{kind} {split} epoch {epoch}: {len(o)} batches, prepared max|diff| {worst:.3e} "
              f"(tol {PREP_ATOL:.0e})")
    # the shuffle differs between epochs
    e0 = [b["lr"].numpy() for b in ours.loader("train", epoch=0)]
    e1 = [b["lr"].numpy() for b in ours.loader("train", epoch=1)]
    assert not all(np.array_equal(a, b) for a, b in zip(e0, e1))


def test_loader_ranks_concatenate_to_the_jax_global_batch(sim_root, tmp_path):
    ours, ref = _modules(_sim_kwargs(sim_root), tmp_path)
    ranks = [TDataModule(ours.config, splits_root=tmp_path / "ts", seed=2, device="cpu")
             for _ in range(2)]
    r = list(ref.loader("train", mesh=_mesh(2), epoch=0))
    shares = [list(m.loader("train", epoch=0, rank=k, world_size=2)) for k, m in enumerate(ranks)]
    joined = [{key: torch.cat([s0[key], s1[key]]) for key in s0} for s0, s1 in zip(*shares)]
    worst = _compare(joined, r)
    padded = [float((1 - b["weight"]).sum()) for b in joined]
    # 16 train samples in batches of 3, 3, 3, 3, 3, 1: each padded by one row to an even count
    assert padded == [1.0] * 6
    assert [len(s["lr"]) for s in shares[0]] == [2] * 5 + [1]
    for b in joined:  # the padding repeats the last sample, at weight 0
        assert torch.equal(b["lr"][-1], b["lr"][-2]) and b["weight"][-1] == 0.0
    print(f"world size 2: {len(joined)} global batches, padded rows {padded}, max|diff| {worst:.3e}")


def test_loader_raises_what_the_host_side_raised(sim_root, tmp_path):
    ours, _ = _modules(_sim_kwargs(sim_root), tmp_path)

    def broken(i):
        raise OSError(f"cannot read sample {i}")

    ours.dataset.__class__ = type("Broken", (TDataset,), {"__getitem__": lambda self, i: broken(i)})
    with pytest.raises(OSError, match="cannot read sample"):
        list(ours.loader("val"))


def test_boring_loader_matches_jax(tmp_path):
    kw = dict(type="boring", batch_size=4, lr=dict(exps=[20], clamp_max=0.0022336, res=16),
              hr=dict(exp=100, clamp_max=0.0005584, res=32))
    tc, jc = _cfgs(kw)
    ours = TDataModule(tc, seed=1, boring_size=24, device="cpu")
    ref = jdm.XmmDataModule(jc, seed=1, boring_size=24)
    o = list(ours.loader("val"))
    r = list(ref.loader("val", mesh=_mesh(1)))
    assert len(o) == len(r)
    for a, b in zip(o, r):
        np.testing.assert_array_equal(a["lr"].numpy(), np.asarray(b["lr"]))
        np.testing.assert_array_equal(a["hr"].numpy(), np.asarray(b["hr"]))


def test_display_batch_matches_jax_and_leaves_the_rng_alone(sim_root, tmp_path):
    ours, ref = _modules(_sim_kwargs(sim_root), tmp_path)
    before = ours.dataset.rng.bit_generator.state
    od, rd = TDisplay(ours, num_images=2), jdisp.XmmDisplayDataModule(ref, num_images=2)
    assert od.indices == rd.indices
    ob, rb = od.display_batch(), rd.display_batch()
    for k in ("lr", "hr"):
        np.testing.assert_array_equal(ob[k], rb[k])
    assert od.display_batch() is ob  # cached
    assert ours.dataset.rng.bit_generator.state == before
    op, rp = od.prepared_batch(), rd.prepared_batch()
    worst = max(float(np.abs(op[k] - rp[k]).max()) for k in ("lr", "hr"))
    print(f"display: prepared max|diff| {worst:.3e}")
    assert worst <= PREP_ATOL
