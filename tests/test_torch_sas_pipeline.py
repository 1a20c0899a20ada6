"""The port's SAS subprocess wrappers against the JAX package's, under a fake SAS.

The SAS binaries are absent here; both packages' `run_sas_command` are
replaced by the same recording fake (the JAX package's
`tests/test_sas_pipeline.py` FakeSAS, copied), which synthesizes plausible
outputs. The argument lists the port's wrappers build must equal JAX's,
call for call, and the ecoordconv WCS fixup must write the same header
values; the native fallback of `make_gti_pps` writes the same GTI files.
`check_pps_dir` indexes a PPS directory as JAX's does, and `get_pps_nxsa`
raises the same clear offline error through a faked opener (no network).
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

import xmm_superres_denoise_tpu.sas.pipeline as jsas
import xmm_superres_denoise_torch.sas.pipeline as tsas
from xmm_superres_denoise_torch.io.fits import read_bintable, read_image, write_bintable, write_image


class FakeSAS:
    def __init__(self):
        self.calls = []

    def __call__(self, args):
        self.calls.append(list(args))
        kv = dict(a.split("=", 1) for a in args[1:] if "=" in a)
        tool = args[0]
        if tool == "tabgtigen":
            write_bintable(
                Path(kv["gtiset"]),
                {"START": np.array([0.0, 5000.0]), "STOP": np.array([4000.0, 20000.0])},
                extname="STDGTI", header={"METHOD": "fake"},
            )
        elif tool == "evselect" and "filteredset" in kv:
            Path(kv["filteredset"]).write_bytes(Path(kv["table"]).read_bytes())
        elif tool == "evselect" and "imageset" in kv:
            hdr = {"REFXCDLT": -1.38889e-5, "REFYCDLT": 1.38889e-5, "PA_PNT": 80.0}
            write_image(Path(kv["imageset"]), np.zeros((411, 403), np.float32), hdr)
        out = b""
        if tool == "ecoordconv":
            out = b" IM_X: IM_Y: 206.5 200.5\n RA: DEC: 10.25 -5.5\n"
        return subprocess.CompletedProcess(args, 0, stdout=out, stderr=b"")


@pytest.fixture
def fakes(monkeypatch):
    out = {}
    for name, mod in (("port", tsas), ("jax", jsas)):
        fake = FakeSAS()
        monkeypatch.setattr(mod, "sas_available", lambda: True)
        monkeypatch.setattr(mod, "run_sas_command", fake)
        out[name] = fake
    monkeypatch.delenv("SAS_CCF", raising=False)
    monkeypatch.delenv("SAS_ODF", raising=False)
    return out


def _event_file(d: Path, instrume="EPN"):
    d.mkdir(parents=True, exist_ok=True)
    return write_bintable(
        d / "P0PNS003PIEVLI0.FTZ",
        {"TIME": np.array([1.0, 2.0]), "DETX": np.array([0, 1], np.int32),
         "DETY": np.array([0, 1], np.int32), "PI": np.array([600, 900], np.int32)},
        extname="EVENTS",
        header={"INSTRUME": instrume, "REFXCDLT": -1.38889e-5, "REFYCDLT": 1.38889e-5,
                "PA_PNT": 80.0},
    )


def _pps(d: Path):
    ccf = d / "P0OBX000CALIND0.FTZ"
    ccf.write_bytes(b"\x00")
    return {"pps_dir": d, "ccf_file": ccf, "fbk_files": [], "evl_files": []}


def _relative(calls, root: Path):
    """Argument lists with the per-package directory made relative."""
    return [[a.replace(str(root), "<dir>") for a in c] for c in calls]


@pytest.mark.parametrize("inst", ["EPN", "EMOS1"])
def test_filter_events_arguments_equal_to_jax(fakes, tmp_path, inst):
    outs = {}
    for name, mod in (("port", tsas), ("jax", jsas)):
        d = tmp_path / name
        evl = _event_file(d, inst)
        outs[name] = mod.filter_events_gti(evl, d / "pn.gti", _pps(d), d)
        assert outs[name].exists()
    assert outs["port"].name == outs["jax"].name
    assert _relative(fakes["port"].calls, tmp_path / "port") == _relative(
        fakes["jax"].calls, tmp_path / "jax")
    expr = [a for a in fakes["port"].calls[0] if a.startswith("expression=")][0]
    assert ("#XMMEA_EM" in expr) == (inst == "EMOS1")


def test_make_detxy_image_arguments_and_wcs_equal_to_jax(fakes, tmp_path):
    imgs = {}
    for name, mod in (("port", tsas), ("jax", jsas)):
        d = tmp_path / name
        out = mod.make_detxy_image(_event_file(d), d, _pps(d))
        imgs[name] = read_image(out)
    assert _relative(fakes["port"].calls, tmp_path / "port") == _relative(
        fakes["jax"].calls, tmp_path / "jax")
    assert fakes["port"].calls[1][0] == "ecoordconv"
    (img_p, hdr_p), (img_j, hdr_j) = imgs["port"], imgs["jax"]
    np.testing.assert_array_equal(img_p, img_j)
    assert dict(hdr_p) == dict(hdr_j)
    assert hdr_p["CRPIX1"] == 206.5 and hdr_p["CRVAL2"] == -5.5


@pytest.mark.parametrize("sas", [True, False])
def test_make_gti_pps_equal_to_jax(fakes, monkeypatch, tmp_path, sas):
    """tabgtigen under the fake, and the native GTI derivation without SAS."""
    got = {}
    for name, mod in (("port", tsas), ("jax", jsas)):
        if not sas:
            monkeypatch.setattr(mod, "sas_available", lambda: False)
        d = tmp_path / name
        d.mkdir()
        t = np.arange(0, 30_000, 100.0)
        rate = np.full_like(t, 0.2)
        rate[100:150] = 9.0
        fbk = write_bintable(d / "P0PNS003FBKTSR0.FTZ", {"TIME": t, "RATE": rate},
                             extname="RATE", header={"FLCUTTHR": 0.5},
                             primary_header={"INSTRUME": "EPN"})
        pps = dict(_pps(d), fbk_files=[fbk])
        names = mod.make_gti_pps(pps, "all", d / "gti", max_expo=20.0)
        got[name] = [(p.name, read_bintable(p, extname="STDGTI")[0]) for p in names]
    assert [n for n, _ in got["port"]] == [n for n, _ in got["jax"]] == ["pn_pps_20.0ks.gti"]
    for (_, a), (_, b) in zip(got["port"], got["jax"]):
        for k in ("START", "STOP"):
            np.testing.assert_array_equal(a[k], b[k])
    assert len(fakes["port"].calls) == (1 if sas else 0)


def test_check_pps_dir_equal_to_jax(tmp_path):
    for name in ("P0PNS003PIEVLI0000.FTZ", "P0PNS003FBKTSR0000.FTZ",
                 "P0OBX000CALIND0000.FTZ", "P0OBX000ATTTSR0000.FTZ"):
        (tmp_path / name).write_bytes(b"\x00")
    assert tsas.check_pps_dir(tmp_path) == jsas.check_pps_dir(tmp_path)
    (tmp_path / "P0OBX000CALIND0000.FTZ").unlink()
    with pytest.raises(FileNotFoundError, match="CALIND"):
        tsas.check_pps_dir(tmp_path)
    with pytest.raises(FileNotFoundError):
        tsas.check_pps_dir(tmp_path / "missing")


def test_sas_wrappers_refuse_without_sas(monkeypatch, tmp_path):
    monkeypatch.delenv("SAS_DIR", raising=False)
    assert tsas.sas_available() is False and jsas.sas_available() is False
    with pytest.raises(RuntimeError, match="SAS not available"):
        tsas.make_detxy_image(tmp_path / "e.fits", tmp_path, _pps(tmp_path))
    with pytest.raises(RuntimeError, match="SAS not available"):
        tsas.filter_events_gti(tmp_path / "e.fits", tmp_path / "g", _pps(tmp_path), tmp_path)


def test_get_pps_nxsa_offline_error(tmp_path):
    def offline(url):
        assert url == tsas.NXSA_AIO_URL.format(obs_id="0123456789") == jsas.NXSA_AIO_URL.format(
            obs_id="0123456789")
        raise OSError("network unreachable")

    msgs = []
    for mod in (tsas, jsas):
        w = tmp_path / mod.__name__.split(".")[0]
        w.mkdir()
        with pytest.raises(RuntimeError, match="offline environment") as e:
            mod.get_pps_nxsa("0123456789", w, opener=offline)
        msgs.append(str(e.value).replace(str(w), "<dir>"))
        assert not (w / "PPS_nxsa.tar").exists()
    assert msgs[0] == msgs[1]
    # an existing PPS dir is indexed, not downloaded
    pps = tmp_path / "0123456789" / "pps"
    pps.mkdir(parents=True)
    for name in ("P0PNS003PIEVLI0000.FTZ", "P0OBX000CALIND0000.FTZ"):
        (pps / name).write_bytes(b"\x00")
    got = tsas.get_pps_nxsa("0123456789", tmp_path / "0123456789", opener=offline)
    assert got["evl_files"] == [pps / "P0PNS003PIEVLI0000.FTZ"]


def test_get_pps_nxsa_default_opener_with_faked_urlopen(tmp_path, monkeypatch):
    """The default opener imports urllib inside the function; a faked
    `urlopen` that fails as an offline machine does gives the clear error."""
    import urllib.request

    seen = []

    def urlopen(url, timeout=None):
        seen.append((url, timeout))
        raise urllib.error.URLError("no route to host")

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    with pytest.raises(RuntimeError, match="NXSA download for 0123456789 failed"):
        tsas.get_pps_nxsa("0123456789", tmp_path)
    assert seen == [(tsas.NXSA_AIO_URL.format(obs_id="0123456789"), 120)]
    assert not (tmp_path / "PPS_nxsa.tar").exists()
