"""The port's FITS and WCS copies against the JAX package's codec: files
written by one read back identically through the other, and the product
writer emits the same header cards."""

import gzip

import numpy as np
import pytest

from xmm_superres_denoise_torch.io import fits as tfits
from xmm_superres_denoise_torch.io.wcs import write_xmm_product_wcs
from xmm_superres_denoise_tpu.io import fits as jfits
from xmm_superres_denoise_tpu.io.wcs import write_xmm_product_wcs as jax_write_product

HEADER = {
    "EXPOSURE": 20_000.0, "CRPIX1": 200.0, "CRPIX2": 205.0, "CRVAL1": 150.0,
    "CRVAL2": 2.0, "CDELT1": -0.001111, "CDELT2": 0.001111, "PA_PNT": 65.0,
    "CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN", "OBJECT": ("it's a long " * 12).rstrip(),
    "FLAG": True, "COUNT": 7, "ONTIME01": 1.0, "PCOUNT": 4, "TTYPE1": "X",
}


@pytest.mark.parametrize(
    "dtype,name",
    [(np.float32, "a.fits"), (np.int32, "b.fits.gz"), (np.uint16, "c.fits"),
     (np.float64, "d.fits.gz"), (np.int16, "e.fits")],
)
def test_images_round_trip_between_the_two_codecs(tmp_path, dtype, name):
    data = (np.random.default_rng(0).uniform(0, 5e4, (11, 7))).astype(dtype)
    hdr = {k: v for k, v in HEADER.items() if k not in ("PCOUNT", "TTYPE1")}
    for write, read, sub in ((tfits.write_image, jfits.read_image, "t2j"),
                             (jfits.write_image, tfits.read_image, "j2t")):
        path = write(tmp_path / sub / name, data, hdr)
        img, got = read(path)
        np.testing.assert_array_equal(img, data)
        for k, v in hdr.items():
            assert got[k] == v, k
    a, b = ((tmp_path / sub / name).read_bytes() for sub in ("t2j", "j2t"))
    if name.endswith(".gz"):  # gzip headers carry a timestamp
        a, b = gzip.decompress(a), gzip.decompress(b)
    assert a == b


def test_read_header_skips_the_data(tmp_path):
    path = tfits.write_image(tmp_path / "x.fits.gz", np.zeros((411, 403), np.int32), HEADER)
    hdr = tfits.read_header(path)
    assert (hdr["NAXIS1"], hdr["NAXIS2"]) == (403, 411)
    assert gzip.decompress(path.read_bytes())[:6] == b"SIMPLE"


@pytest.mark.parametrize("res_mult", [1, 2])
def test_product_headers_match_jax(tmp_path, res_mult):
    img = np.random.default_rng(1).uniform(0, 1e-3, (8 * res_mult,) * 2).astype(np.float32)
    src = jfits.Header(HEADER)
    args = ("pn_detxy.fits", res_mult, 1e5)
    kw = dict(comment="XMM esr_gen model prediction. " * 4, out_file_name="p", in_header=src)
    ours = write_xmm_product_wcs(img, tmp_path / "t", *args, **kw)
    theirs = jax_write_product(img, tmp_path / "j", *args, **kw)
    a, ha = jfits.read_image(ours)
    b, hb = jfits.read_image(theirs)
    np.testing.assert_array_equal(a, b)
    assert list(ha.items()) == list(hb.items())
    assert "PCOUNT" not in ha and "TTYPE1" not in ha and "ONTIME01" not in ha
