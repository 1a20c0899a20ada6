"""The port's WCS and attitude modules against the JAX package's, on the CPU.

The math is the same Python float64 in both packages, so every value is
held EXACTLY equal (max|diff| printed, 0):

* `det_to_sky` / `sky_to_det` over a seeded sweep (poles, RA wrap, the full
  PA range), and their round trip (1e-3 DET units, JAX's own tolerance);
* `native_ecoordconv` for EPN, and for MOS with its zero-offset warning;
* `detxy_wcs_header`, `write_xmm_product` and `write_xmm_product_wcs`:
  equal headers, and byte-identical files (gzip members equal but for the
  header's mtime);
* `pointing_from_atthk` (the circular median, wrap-safe at RA 0/360) and
  `ensure_pointing` (header first, else the attitude file, else a refusal).
"""

import gzip
import logging

import numpy as np
import pytest

from xmm_superres_denoise_tpu.io import atthk as jatt
from xmm_superres_denoise_tpu.io import wcs as jwcs
from xmm_superres_denoise_torch.io import atthk as tatt
from xmm_superres_denoise_torch.io import fits as tfits
from xmm_superres_denoise_torch.io import wcs as twcs

EV_HDR = {"INSTRUME": "EPN", "RA_PNT": 187.701875, "DEC_PNT": 12.389, "PA_PNT": 109.3,
          "REFXCDLT": -1.38888888888889e-05, "REFYCDLT": 1.38888888888889e-05,
          "TTYPE1": "TIME", "TFORM1": "D", "XTENSION": "BINTABLE", "PCOUNT": 0,
          "EXPOSURE": 1.0, "OBJECT": "M87"}
META = {"bin_size": 80, "x0": -16120, "y0": -16440, "nx": 403, "ny": 411, "exposure": 19_000.0}


def test_det_to_sky_and_back_equal_to_jax():
    rng = np.random.default_rng(0)
    worst = 0.0
    for i in range(200):
        detx, dety = rng.uniform(-16000, 16000, 2)
        ra_p = float(rng.choice([0.0, 359.99, rng.uniform(0, 360)]))
        dec_p = float(rng.uniform(-89.5, 89.5))
        pa = float(rng.uniform(0, 360))
        got = twcs.det_to_sky(detx, dety, ra_p, dec_p, pa)
        assert got == jwcs.det_to_sky(detx, dety, ra_p, dec_p, pa)
        back = twcs.sky_to_det(*got, ra_p, dec_p, pa)
        assert back == jwcs.sky_to_det(*got, ra_p, dec_p, pa)
        worst = max(worst, abs(back[0] - detx), abs(back[1] - dety))
    print(f"round trip: max|DET diff| {worst:.3e} (tol 1e-3); port vs JAX max|diff| 0")
    assert worst < 1e-3
    assert twcs.det_to_sky(0.0, 0.0, 10.0, 20.0, 30.0, (0.0, 0.0)) == (10.0, 20.0)
    assert twcs.EPN_DET0_OFFSET_ARCSEC == jwcs.EPN_DET0_OFFSET_ARCSEC


@pytest.mark.parametrize("inst", ["EPN", "EMOS1"])
def test_native_ecoordconv_equal_to_jax(inst, caplog):
    hdr = dict(EV_HDR, INSTRUME=inst)
    with caplog.at_level(logging.WARNING, logger="xmmsr"):
        got = twcs.native_ecoordconv(META, hdr)
    want = jwcs.native_ecoordconv(META, hdr)
    assert got == want
    warned = any("calibrated for EPN" in r.message for r in caplog.records)
    assert warned == (inst != "EPN")
    assert twcs.native_ecoordconv(META, {"INSTRUME": inst}) is None
    # the reference frames' LTV keywords (JAX's grid-convention case)
    ltv = twcs.native_ecoordconv({"bin_size": 80, "x0": -18283, "y0": -17527},
                                 {"RA_PNT": 10.0, "DEC_PNT": 10.0, "PA_PNT": 0.0})
    assert (ltv["xima"], ltv["yima"]) == (229.04375, 219.59375)


def test_detxy_wcs_header_equal_to_jax():
    hdr = tfits.Header(EV_HDR)
    got, want = twcs.detxy_wcs_header(META, hdr), jwcs.detxy_wcs_header(META, hdr)
    assert list(got) == list(want) and dict(got) == dict(want)
    assert "XTENSION" not in got and got["CD1_1"] == want["CD1_1"]
    ref = {"xima": 1.5, "yima": 2.5, "ra": 3.0, "dec": 4.0}
    assert dict(twcs.detxy_wcs_header(META, hdr, ref)) == dict(
        jwcs.detxy_wcs_header(META, hdr, ref))


def _members_equal(a: bytes, b: bytes) -> bytes:
    assert a[:4] == b[:4] and a[8:] == b[8:]  # all but the gzip header's mtime
    return gzip.decompress(a)


@pytest.mark.parametrize("writer", ["write_xmm_product", "write_xmm_product_wcs"])
@pytest.mark.parametrize("res_mult", [1, 2])
def test_product_writers_byte_identical(tmp_path, writer, res_mult):
    img = np.random.default_rng(res_mult).uniform(0, 1e-3, (32 * res_mult,) * 2)
    img = img.astype(np.float32)
    in_hdr = tfits.Header(dict(twcs.detxy_wcs_header(META, tfits.Header(EV_HDR)),
                               CRPIX1=200.0, CRPIX2=205.0, CDELT1=-0.001111,
                               CDELT2=0.001111, ONTIME01=5.0))
    kw = dict(comment="Input image padded and WCS aligned. " * 3, in_header=in_hdr)
    pt = getattr(twcs, writer)(img, tmp_path / "port", "det.fits", res_mult, 2e4, **kw)
    pj = getattr(jwcs, writer)(img, tmp_path / "jax", "det.fits", res_mult, 2e4, **kw)
    assert pt.name == pj.name
    raw = _members_equal(pt.read_bytes(), pj.read_bytes())
    assert raw == gzip.decompress(pj.read_bytes())
    _, h = tfits.read_image(pt)
    assert "ONTIME01" not in h and h["EXPOSURE"] == 2e4


def _att_file(tmp_path, ra0=187.7, n=500, cols=("AHFRA", "AHFDEC", "AHFPA")):
    rng = np.random.default_rng(3)
    t = np.linspace(0, 50_000, n)
    ra = (ra0 + rng.normal(0, 1e-3, n)) % 360.0
    return tfits.write_bintable(
        tmp_path / f"att_{ra0}.fits",
        {"TIME": t, cols[0]: ra, cols[1]: 12.39 + rng.normal(0, 1e-3, n),
         cols[2]: 109.3 + rng.normal(0, 1e-2, n)},
        extname="ATTHK")


@pytest.mark.parametrize("ra0", [187.7, 0.0005])  # the second straddles RA 0/360
def test_pointing_from_atthk_equal_to_jax(tmp_path, ra0):
    path = _att_file(tmp_path, ra0)
    got, want = tatt.pointing_from_atthk(path), jatt.pointing_from_atthk(path)
    assert got == want
    assert abs(((got["RA_PNT"] - ra0 + 180) % 360) - 180) < 1e-3
    win = (10_000.0, 20_000.0)
    assert tatt.pointing_from_atthk(path, *win) == jatt.pointing_from_atthk(path, *win)
    with pytest.raises(ValueError, match="no attitude samples"):
        tatt.pointing_from_atthk(path, 6e4, 7e4)
    bare = _att_file(tmp_path, 5.0, cols=("RA", "DEC", "POSANG"))
    assert tatt.pointing_from_atthk(bare) == jatt.pointing_from_atthk(bare)


def test_ensure_pointing_equal_to_jax(tmp_path):
    path = _att_file(tmp_path)
    hdr = {"TSTART": 0.0, "TSTOP": 30_000.0}
    assert tatt.ensure_pointing(hdr, path) == jatt.ensure_pointing(hdr, path)
    full = {"RA_PNT": 1.0, "DEC_PNT": 2.0, "PA_PNT": 3.0}
    assert tatt.ensure_pointing(full) == full == jatt.ensure_pointing(full)
    with pytest.raises(ValueError, match="ATTTSR"):
        tatt.ensure_pointing(hdr)
