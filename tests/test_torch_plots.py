"""The products' PNG plots (`infer/run_file.py: _save_plots`, `--plot`)
against the JAX package's, on the CPU.

`--plot` through the port's `infer`, `serve` and `end2end` writes the PNGs
the JAX CLI writes, under the same names (`plot_in.png` / `plot_out.png`,
`<stem>_` prefixed in the batched path), and leaves the FITS products
bitwise equal to a run without it; `write_products` names them by its
`out_stem`. Serving: the trained esr_gen checkpoint at 32^2 -> 64^2
(the JAX CLI tests' run config); end2end: the 4-filter esr_gen at 416^2 ->
832^2 of `tests/test_torch_end2end.py`. Only the cases that draw a PNG
need matplotlib.
"""

import contextlib
import functools
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from test_cli import _write_run_config
from test_torch_end2end import tiny_setup, write_pps
from xmm_superres_denoise_torch import cli as tcli
from xmm_superres_denoise_torch.infer.run_file import write_products
from xmm_superres_denoise_torch.io.fits import read_image, write_image
from xmm_superres_denoise_tpu import cli as jcli
from xmm_superres_denoise_tpu.infer.run_file import write_products as jax_write_products

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "docs/convergence_esr_gen/best_params.npz"


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([str(a) for a in argv])
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("plots")
    g = np.random.default_rng(0)
    for i in range(2):
        hdr = {"EXPOSURE": 20_000.0, "CRPIX1": 10.0, "CRPIX2": 12.0, "CRVAL1": 150.0,
               "CRVAL2": 2.0, "CDELT1": -0.001111, "CDELT2": 0.001111, "PA_PNT": 65.0}
        write_image(tmp / f"det{i}.fits", g.poisson(2.0, (28, 30)).astype(np.int32), hdr)
    return tmp, _write_run_config(tmp)


def _pngs(directory):
    return sorted(p.name for p in Path(directory).glob("*.png"))


def _fits_equal(a, b):
    """The FITS products of two runs, by name: bitwise equal data."""
    names = sorted(p.name for p in Path(a).glob("*.fits*"))
    assert names and names == sorted(p.name for p in Path(b).glob("*.fits*"))
    for n in names:
        np.testing.assert_array_equal(read_image(Path(a) / n)[0], read_image(Path(b) / n)[0])
    return names


@pytest.mark.parametrize("cmd", ["infer", "serve"])
def test_plot_flag_writes_the_jax_clis_pngs(serving, tmp_path, cmd):
    pytest.importorskip("matplotlib")
    tmp, run = serving
    src = (["--fits", tmp / "det0.fits"] if cmd == "infer" else [tmp / "det*.fits"])
    common = [cmd, *src, "--checkpoint", CKPT, "--run_config", run]
    rc_p, _ = _run(tcli.main, [*common, "--out", tmp_path / "plot", "--plot", "--device", "cpu"])
    rc_n, _ = _run(tcli.main, [*common, "--out", tmp_path / "none", "--device", "cpu"])
    rc_j, _ = _run(jcli.main, [*common, "--out", tmp_path / "jax", "--plot"])
    assert rc_p == rc_n == rc_j == 0
    want = (["plot_in.png", "plot_out.png"] if cmd == "infer" else
            [f"det{i}_plot_{k}.png" for i in range(2) for k in ("in", "out")])
    names = _fits_equal(tmp_path / "plot", tmp_path / "none")
    print(f"{cmd} --plot: PNGs {_pngs(tmp_path / 'plot')}, JAX's {_pngs(tmp_path / 'jax')}; "
          f"FITS {names} bitwise equal to a run without --plot")
    assert _pngs(tmp_path / "plot") == _pngs(tmp_path / "jax") == want
    assert _pngs(tmp_path / "none") == []
    assert all((tmp_path / "plot" / n).stat().st_size > 0 for n in want)


def test_end2end_plot_writes_the_jax_clis_pngs(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    run, res, npz = tiny_setup(tmp_path)
    pps = write_pps(tmp_path / "pps")
    monkeypatch.setattr(tcli, "load_run_config", functools.partial(tcli.load_run_config,
                                                                   res_dir=res))
    monkeypatch.setattr(jcli, "load_run_config", functools.partial(jcli.load_run_config,
                                                                   res_dir=res))
    common = ["end2end", "--pps", pps, "--checkpoint", npz, "--run_config", run]
    rc_p, out_p = _run(tcli.main, [*common, "--out", tmp_path / "plot", "--plot",
                                   "--device", "cpu"])
    rc_n, _ = _run(tcli.main, [*common, "--out", tmp_path / "none", "--device", "cpu"])
    rc_j, _ = _run(jcli.main, [*common, "--out", tmp_path / "jax", "--plot"])
    assert rc_p == rc_n == rc_j == 0
    names = _fits_equal(tmp_path / "plot", tmp_path / "none")
    print(f"end2end --plot: PNGs {_pngs(tmp_path / 'plot')}, JAX's {_pngs(tmp_path / 'jax')}; "
          f"FITS {names} bitwise equal to a run without --plot")
    assert _pngs(tmp_path / "plot") == _pngs(tmp_path / "jax") == ["plot_in.png", "plot_out.png"]
    assert Path(out_p["prediction"]).parent == tmp_path / "plot"


@pytest.mark.parametrize("out_stem", [None, "obsA_img"])
def test_write_products_names_its_plots_as_jax(tmp_path, out_stem):
    pytest.importorskip("matplotlib")
    g = np.random.default_rng(1)
    inp = g.uniform(0, 1e-4, (32, 32)).astype(np.float32)
    pred = g.uniform(0, 1e-4, (64, 64)).astype(np.float32)
    hdr = {"EXPOSURE": 20_000.0, "CRPIX1": 10.0, "CRPIX2": 12.0, "CRVAL1": 150.0,
           "CRVAL2": 2.0, "CDELT1": -0.001111, "CDELT2": 0.001111, "PA_PNT": 65.0}
    args = (inp, pred)
    rest = (Path("pn_detxy.fits"), 20_000.0, 100.0, "esr_gen", hdr)
    got = write_products(*args, tmp_path / "port", *rest, plot=True, out_stem=out_stem)
    want = jax_write_products(*args, tmp_path / "jax", *rest, plot=True, out_stem=out_stem)
    prefix = f"{out_stem}_" if out_stem else ""
    assert [p.name for p in got] == [p.name for p in want]
    assert _pngs(tmp_path / "port") == _pngs(tmp_path / "jax") == [
        f"{prefix}plot_in.png", f"{prefix}plot_out.png"]


def test_write_products_draws_nothing_without_plot(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # not imported without plot
    inp = np.ones((32, 32), np.float32)
    hdr = {"EXPOSURE": 20_000.0, "CDELT1": -0.001111, "CDELT2": 0.001111}
    got = write_products(inp, np.ones((64, 64), np.float32), tmp_path, Path("a.fits"),
                         20_000.0, 100.0, "esr_gen", hdr)
    assert [p.name for p in got] == ["a_input_wcs.fits.gz", "a_predict_wcs.fits.gz"]
    assert _pngs(tmp_path) == []
