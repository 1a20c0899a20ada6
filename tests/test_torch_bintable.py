"""The port's binary-table codec against the JAX package's, on the CPU.

* `write_bintable`: the port's file is byte-identical to the JAX package's
  for the same columns, table header, `column_limits` and primary header,
  plain and gzip (the gzip members differ only in the header's mtime; the
  count of differing bytes is printed, 0);
* each package reads the other's file: the same columns (bitwise) and the
  same header cards;
* the port's native reader (`io/native_bintable.py`, the C reader built by
  `data/native_loader.get_lib`) against its Python reader: equal arrays and
  header values, and the fallback when the native path steps aside.
"""

from pathlib import Path

import numpy as np
import pytest

from xmm_superres_denoise_tpu.io import fits as jfits
from xmm_superres_denoise_torch.data.native_loader import native_available
from xmm_superres_denoise_torch.io import fits as tfits
from xmm_superres_denoise_torch.io import native_bintable as tnb

COLS = ["TIME", "DETX", "DETY", "PI", "PATTERN", "FLAG", "X", "Y"]


def _columns(seed=7, n=4321):
    """Every column type the writer takes, at mission times."""
    g = np.random.default_rng(seed)
    return {
        "TIME": np.sort(g.uniform(5.6e8, 5.6e8 + 3e4, n)),  # f8
        "DETX": g.integers(-16120, 16120, n).astype(np.int16),  # i2
        "DETY": g.integers(-16440, 16440, n).astype(np.int32),  # i4
        "PI": g.integers(150, 12000, n).astype(np.int64),  # i8
        "PATTERN": g.integers(0, 13, n).astype(np.uint8),  # u1
        "FLAG": g.normal(size=n).astype(np.float32),  # f4
        "RAWX": g.integers(0, 64, n).astype(np.uint16),  # written as f8
    }


def _write(mod, path, cols):
    return mod.write_bintable(
        path, cols, extname="EVENTS",
        header={"INSTRUME": "EPN", "ONTIME": 30000.0, "RA_PNT": 187.70187500000001,
                "OBJECT": "a long object name " * 6},
        column_limits={"DETX": (-16120, 16119), "DETY": (-16440, 16439)},
        primary_header={"OBS_ID": "0123456789", "TELESCOP": "XMM"},
    )


@pytest.mark.parametrize("suffix", ["ev.fits", "ev.fits.gz"])
def test_write_bintable_byte_identical_to_jax(tmp_path, suffix):
    cols = _columns()
    a = _write(tfits, tmp_path / f"port_{suffix}", cols).read_bytes()
    b = _write(jfits, tmp_path / f"jax_{suffix}", cols).read_bytes()
    if suffix.endswith(".gz"):
        import gzip

        # the gzip members are equal but for the header's mtime (bytes 4-7)
        assert a[:2] == b"\x1f\x8b" and a[:4] == b[:4] and a[8:] == b[8:]
        a, b = gzip.decompress(a), gzip.decompress(b)
    n_diff = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    print(f"{suffix}: {len(a)} bytes, differing bytes {n_diff}")
    assert a == b


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_file(tmp_path, writer):
    cols = _columns(seed=3)
    mod_w, mod_r = (tfits, jfits) if writer == "port" else (jfits, tfits)
    path = _write(mod_w, tmp_path / "ev.fits.gz", cols)
    got, hdr = mod_r.read_bintable(path, extname="EVENTS")
    want, want_hdr = mod_w.read_bintable(path, extname="EVENTS")
    assert sorted(got) == sorted(want) == sorted(cols)
    for k in cols:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], np.asarray(cols[k]).astype(got[k].dtype))
    assert dict(hdr) == dict(want_hdr)
    assert hdr["TLMIN2"] == -16120 and hdr["OBJECT"] == ("a long object name " * 6).rstrip()
    prim, _ = mod_r.read_hdus(path)[0]
    assert prim["OBS_ID"] == "0123456789"


def test_read_bintable_column_subset_and_extname(tmp_path):
    path = tfits.write_bintable(
        tmp_path / "gti.fits", {"START": np.array([0.0, 5.0]), "STOP": np.array([4.0, 9.0])},
        extname="STDGTI", header={"METHOD": "pps"})
    for mod in (tfits, jfits):
        cols, hdr = mod.read_bintable(path, columns=["STOP"], extname="STDGTI")
        assert list(cols) == ["STOP"] and hdr["METHOD"] == "pps"
        with pytest.raises(ValueError, match="No BINTABLE"):
            mod.read_bintable(path, extname="EVENTS")


def test_load_fits_matches_jax(tmp_path):
    img = np.random.default_rng(1).poisson(2.0, (28, 30)).astype(np.int32)
    path = tfits.write_image(tmp_path / "det.fits.gz", img, {"EXPOSURE": 2e4})
    got, want = tfits.load_fits(path), jfits.load_fits(path)
    assert got.shape == (1, 28, 30) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


needs_native = pytest.mark.skipif(not native_available(),
                                  reason="the native FITS library did not build here")


@needs_native
@pytest.mark.parametrize("suffix", ["ev.fits", "ev.fits.gz"])
def test_native_reader_equals_python_reader(tmp_path, suffix):
    cols = _columns()
    path = _write(tfits, tmp_path / suffix, cols)
    want, want_hdr = tfits.read_bintable(path, columns=COLS, extname="EVENTS")
    res = tnb.read_bintable_native(path, COLS, extname="EVENTS")
    assert res is not None
    got, hdr = res
    assert sorted(got) == sorted(want)  # X/Y absent from both
    for k in want:
        assert got[k].dtype == want[k].dtype.newbyteorder("=")
        np.testing.assert_array_equal(got[k], want[k])
    for key in ("TFIELDS", "NAXIS1", "NAXIS2", "INSTRUME", "ONTIME", "RA_PNT",
                "TLMIN2", "TLMAX2", "TLMIN3", "TLMAX3", "EXTNAME"):
        assert hdr.get(key) == want_hdr.get(key), key
    fast, _ = tnb.read_bintable_fast(path, COLS, extname="EVENTS")
    for k in want:
        np.testing.assert_array_equal(fast[k], want[k])


@needs_native
def test_native_reader_steps_aside_and_fast_falls_back(tmp_path, monkeypatch):
    path = _write(tfits, tmp_path / "ev.fits", _columns())
    assert tnb.read_bintable_native(path, ["TIME"], extname="NOPE") is None
    assert tnb.read_bintable_native(tmp_path / "missing.fits", ["TIME"]) is None
    native, _ = tnb.read_bintable_fast(path, COLS, extname="EVENTS")
    monkeypatch.setattr(tnb, "read_bintable_native", lambda *a, **k: None)
    fallback, _ = tnb.read_bintable_fast(path, COLS, extname="EVENTS")
    assert sorted(native) == sorted(fallback)
    for k in native:
        np.testing.assert_array_equal(native[k], fallback[k])
