"""XMM output-product FITS writing with reconstructed WCS (numpy only).

The port's own copy of the JAX package's `io/wcs.py`, the reference's
product writers (`utils/filehandling.py:9-247`) on the dependency-free FITS
layer, and the SAS-free ecoordconv:

  * `write_xmm_product`: sim-centred WCS (CRPIX at the boresight of the
    padded frame, CDELT 4"/res_mult, RA/DEC = 0; filehandling.py:82-104).
  * `write_xmm_product_wcs`: carries the input detxy image's WCS through:
    the empirical pad shift CRPIX+=(6, 2) (the 416-pad offset of the native
    403x411 frame; filehandling.py:207-209), and for 2x outputs the
    CRPIX/CDELT rescale plus the CROTA2/CD matrix from `PA_PNT`
    (filehandling.py:211-230).
  * `det_to_sky` / `sky_to_det` / `native_ecoordconv` / `detxy_wcs_header`:
    the absolute sky WCS of a natively binned detxy image, in Python
    float64, the same arithmetic as the JAX package's, so the values are
    equal bit for bit.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from .fits import Header, write_image

# Keys never propagated from the source header (filehandling.py:25-72).
_OMIT_BASE = [
    "SIMPLE", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "EXTEND", "XPROC0",
    "XDAL0", "CREATOR", "DATE",
    "CTYPE1L", "CRPIX1L", "CRVAL1L", "CDELT1L", "LTV1", "LTM1_1",
    "CTYPE2L", "CRPIX2L", "CRVAL2L", "CDELT2L", "LTV2", "LTM2_2",
    "LTM1_2", "LTM2_1",
] + [f"ONTIME{i:02d}" for i in range(1, 13)] + ["EXPOSURE", "DURATION"]

# The non-WCS writer additionally drops the sky WCS keys and rebuilds them.
_OMIT_WCS_TOO = _OMIT_BASE + [
    "CTYPE1", "CRPIX1", "CRVAL1", "CDELT1",
    "CTYPE2", "CRPIX2", "CRVAL2", "CDELT2",
]


# Bintable-structure cards (from an EVENTS extension header) that must
# never reach a primary IMAGE product: a copied nonzero PCOUNT makes the
# product unreadable (data size = image + heap), and XTENSION/TTYPEn/...
# are table keywords with no meaning in an image HDU.
_TABLE_CARD_RE = re.compile(
    r"^(XTENSION|PCOUNT|GCOUNT|TFIELDS|EXTNAME|CHECKSUM|DATASUM|THEAP|"
    r"T(?:TYPE|FORM|UNIT|LMIN|LMAX|SCAL|ZERO|NULL|DISP|DIM|"
    r"CTYP|CRPX|CRVL|CDLT|CUNI)\d+)$"
)


def is_table_card(key: str) -> bool:
    return bool(_TABLE_CARD_RE.match(str(key).upper()))


def _carry_header(in_header: Optional[Header], omit) -> Header:
    out = Header()
    if in_header:
        for k, v in in_header.items():
            if k not in omit and not is_table_card(k):
                out[k] = v
    return out


def write_xmm_product(
    img: np.ndarray,
    output_dir: Path,
    source_file_name: str,
    res_mult: int,
    exposure: float,
    comment: Optional[str] = None,
    out_file_name: Optional[str] = None,
    in_header: Optional[Header] = None,
) -> Path:
    """Sim-centered-WCS product (filehandling.py:9-120)."""
    header = _carry_header(in_header, _OMIT_WCS_TOO)
    header["IMG_FILE"] = source_file_name
    header["EXPOSURE"] = exposure
    header["CDELT1"] = -0.00111111113801599 / res_mult
    header["CDELT2"] = 0.00111111113801599 / res_mult
    if res_mult == 1:
        header["CRPIX1"] = 244.0
        header["CRPIX2"] = 224.0
    elif res_mult == 2:
        header["CRPIX1"] = 487.5
        header["CRPIX2"] = 447.5
    header["CUNIT1"] = "deg"
    header["CUNIT2"] = "deg"
    header["CRVAL1"] = 0.0
    header["CRVAL2"] = 0.0
    header["CTYPE1"] = "RA---TAN"
    # Deliberate deviation: the reference writes the malformed 9-char
    # "DEC---TAN" here (filehandling.py:103); the FITS-standard 4-3 form
    # is "DEC--TAN" (8 chars), which WCS libraries parse.
    header["CTYPE2"] = "DEC--TAN"
    if comment:
        header["COMMENT"] = comment

    name = out_file_name or source_file_name
    return write_image(Path(output_dir) / f"{name}.fits.gz", np.asarray(img), header)


def write_xmm_product_wcs(
    img: np.ndarray,
    output_dir: Path,
    source_file_name: str,
    res_mult: int,
    exposure: float,
    comment: Optional[str] = None,
    out_file_name: Optional[str] = None,
    in_header: Optional[Header] = None,
) -> Path:
    """WCS-carrying product (filehandling.py:131-247).

    CRPIX shift (+6, +2) aligns the detxy WCS with the 416^2 zero-padding of
    the native (403, 411) frame; 2x products rescale CRPIX/CDELT and add the
    CROTA2/CD matrix from PA_PNT.
    """
    header = _carry_header(in_header, _OMIT_BASE)
    header["IMG_FILE"] = source_file_name
    header["EXPOSURE"] = exposure

    crpix1 = float(header.get("CRPIX1", 0.0)) + 6.0
    crpix2 = float(header.get("CRPIX2", 0.0)) + 2.0
    header["CRPIX1"] = crpix1
    header["CRPIX2"] = crpix2
    if res_mult == 2:
        header["CRPIX1"] = res_mult * crpix1 + 0.5
        header["CRPIX2"] = res_mult * crpix2 + 0.5
        cdelt1 = float(header["CDELT1"]) / res_mult
        cdelt2 = float(header["CDELT2"]) / res_mult
        header["CDELT1"] = cdelt1
        header["CDELT2"] = cdelt2
        if "PA_PNT" in header:
            crota2 = 90.0 - float(header["PA_PNT"])
            header["CROT2"] = crota2
            r = math.radians(crota2)
            header["CD1_1"] = cdelt1 * math.cos(r)
            header["CD1_2"] = -1.0 * cdelt2 * math.sin(r)
            header["CD2_1"] = cdelt1 * math.sin(r)
            header["CD2_2"] = cdelt2 * math.cos(r)

    if comment:
        header["COMMENT"] = comment
    name = out_file_name or f"{source_file_name.replace('.fits', '')}_sr_predict"
    return write_image(Path(output_dir) / f"{name}.fits.gz", np.asarray(img), header)


# ------------------------------------------------------------------------- #
# Native ecoordconv: DET(0,0) -> sky without SAS
# ------------------------------------------------------------------------- #

# Fixed offset of the EPN DET(0,0) origin from the telescope optical axis
# (the instrument-misalignment constant SAS reads from the CCF), expressed
# in the DETECTOR frame in arcsec. Derived empirically in this repo from
# the example real observations (data/example_data/real/full): the source
# centroid of each point-like target was matched against its catalog
# RA_OBJ/DEC_OBJ under the reference's rotation convention
# (CROTA2 = 90 - PA_PNT, CD recipe of xmmsas_tools.py:589-618); the three
# point-source observations (0085110101, 0400620101, 0781350101 — position
# angles 262/69/216 deg) agree on this constant to <= 1.7 arcsec, which
# simultaneously validates the rotation convention (a wrong parity could
# not be PA-invariant). See tests/test_native_ecoordconv.py.
EPN_DET0_OFFSET_ARCSEC = (52.106, -75.435)

_DET_UNIT_DEG = 0.05 / 3600.0  # CAMCOORD2 unit = 0.05 arcsec


def det_to_sky(
    detx: float,
    dety: float,
    ra_pnt: float,
    dec_pnt: float,
    pa_pnt: float,
    offset_arcsec: tuple = EPN_DET0_OFFSET_ARCSEC,
) -> tuple:
    """Detector coordinates -> (ra, dec) deg, the `ecoordconv coordtype=det`
    conversion done natively: rotate the detector-frame position (plus the
    fixed DET-origin offset) by 90-PA into tangent-plane offsets from the
    pointing axis, then gnomonic-unproject around (RA_PNT, DEC_PNT)."""
    rho = math.radians(90.0 - pa_pnt)
    c, s = math.cos(rho), math.sin(rho)
    dx = detx * _DET_UNIT_DEG + offset_arcsec[0] / 3600.0
    dy = dety * _DET_UNIT_DEG + offset_arcsec[1] / 3600.0
    xi = math.radians(c * dx - s * dy)  # toward +RA (east)
    eta = math.radians(s * dx + c * dy)  # toward +DEC (north)
    ra0, dec0 = math.radians(ra_pnt), math.radians(dec_pnt)
    # inverse gnomonic (TAN) projection
    rho_t = math.hypot(xi, eta)
    if rho_t == 0.0:
        return ra_pnt, dec_pnt
    cdist = math.atan(rho_t)
    sin_c, cos_c = math.sin(cdist), math.cos(cdist)
    dec = math.asin(cos_c * math.sin(dec0) + eta * sin_c * math.cos(dec0) / rho_t)
    ra = ra0 + math.atan2(
        xi * sin_c,
        rho_t * math.cos(dec0) * cos_c - eta * math.sin(dec0) * sin_c,
    )
    return math.degrees(ra) % 360.0, math.degrees(dec)


def sky_to_det(
    ra: float,
    dec: float,
    ra_pnt: float,
    dec_pnt: float,
    pa_pnt: float,
    offset_arcsec: tuple = EPN_DET0_OFFSET_ARCSEC,
) -> tuple:
    """Inverse of `det_to_sky`: (ra, dec) deg -> (detx, dety) DET units."""
    ra0, dec0 = math.radians(ra_pnt), math.radians(dec_pnt)
    ra_r, dec_r = math.radians(ra), math.radians(dec)
    cos_c = math.sin(dec0) * math.sin(dec_r) + math.cos(dec0) * math.cos(
        dec_r
    ) * math.cos(ra_r - ra0)
    xi = math.cos(dec_r) * math.sin(ra_r - ra0) / cos_c
    eta = (
        math.cos(dec0) * math.sin(dec_r)
        - math.sin(dec0) * math.cos(dec_r) * math.cos(ra_r - ra0)
    ) / cos_c
    xi, eta = math.degrees(xi), math.degrees(eta)
    rho = math.radians(90.0 - pa_pnt)
    c, s = math.cos(rho), math.sin(rho)
    dx = c * xi + s * eta
    dy = -s * xi + c * eta
    detx = (dx - offset_arcsec[0] / 3600.0) / _DET_UNIT_DEG
    dety = (dy - offset_arcsec[1] / 3600.0) / _DET_UNIT_DEG
    return detx, dety


def native_ecoordconv(meta: Dict[str, Any], in_header: Header) -> Optional[Dict[str, float]]:
    """Compute the ecoordconv reference pixel {xima, yima, ra, dec} for a
    natively binned detxy image — SAS-free (xmmsas_tools.py:578-588).

    `meta` is the `bin_events` metadata (bin_size/x0/y0 — the binning grid),
    `in_header` the event-list header carrying the pointing (RA_PNT/DEC_PNT/
    PA_PNT, the AHF-median attitude SAS itself uses via AVRG_PNT=MEDIAN).
    Returns None when the pointing keywords are absent (caller may derive
    them from the ATTTSR product via `io.atthk.pointing_from_atthk`).

    The DET-origin offset constant is calibrated for EPN; other instruments
    fall back to zero offset (pointing axis) with a log warning.
    """
    for k in ("RA_PNT", "DEC_PNT", "PA_PNT"):
        if k not in in_header:
            return None
    inst = str(in_header.get("INSTRUME", "EPN")).strip().upper()
    offset = EPN_DET0_OFFSET_ARCSEC
    if inst != "EPN":
        import logging

        logging.getLogger("xmmsr").warning(
            "native ecoordconv: DET-origin offset is calibrated for EPN "
            "only; using zero offset for %s (arcmin-level WCS error).", inst,
        )
        offset = (0.0, 0.0)
    ra, dec = det_to_sky(
        0.0, 0.0,
        float(in_header["RA_PNT"]),
        float(in_header["DEC_PNT"]),
        float(in_header["PA_PNT"]),
        offset,
    )
    # evselect binSize pixel centers: pixel p (1-based) spans the integer
    # DET values [x0+(p-1)b, x0+pb-1], center x0+(p-1)b+(b-1)/2 — matches
    # the reference images' LTV/CRVAL grid (e.g. LTV1=229.04375 for the
    # (403,411) EPN frame).
    b = float(meta["bin_size"])
    return {
        "xima": (0.0 - float(meta["x0"]) - (b - 1.0) / 2.0) / b + 1.0,
        "yima": (0.0 - float(meta["y0"]) - (b - 1.0) / 2.0) / b + 1.0,
        "ra": ra,
        "dec": dec,
    }


def detxy_wcs_header(
    meta: Dict[str, Any], in_header: Header, ref_pix: Optional[Dict[str, float]] = None
) -> Header:
    """WCS header for a freshly binned detxy image (make_detxy_image's
    ecoordconv step, xmmsas_tools.py:567-618).

    `ref_pix` ({"xima", "yima", "ra", "dec"}) overrides; when omitted it is
    computed NATIVELY from the pointing keywords via `native_ecoordconv`
    (SAS-free — the flagship path emits absolute sky coordinates without
    `ecoordconv`). REFX/REFY CDELTs come from the event header when present.
    """
    hdr = Header()
    for k, v in in_header.items():
        if not is_table_card(k):
            hdr[k] = v
    if ref_pix is None:
        ref_pix = native_ecoordconv(meta, in_header)
    if ref_pix is not None:
        hdr["CRVAL1"] = float(ref_pix["ra"])
        hdr["CRVAL2"] = float(ref_pix["dec"])
        hdr["CRPIX1"] = float(ref_pix["xima"])
        hdr["CRPIX2"] = float(ref_pix["yima"])
    if "REFYCDLT" in in_header and "REFXCDLT" in in_header:
        cdelt1 = meta["bin_size"] * float(in_header["REFYCDLT"])
        cdelt2 = -meta["bin_size"] * float(in_header["REFXCDLT"])
        hdr["CDELT1"] = cdelt1
        hdr["CDELT2"] = cdelt2
        hdr["CTYPE1"] = "RA---TAN"
        hdr["CTYPE2"] = "DEC--TAN"
        if "PA_PNT" in in_header:
            crota2 = 90.0 - float(in_header["PA_PNT"])
            hdr["CROT2"] = crota2
            r = math.radians(crota2)
            hdr["CD1_1"] = cdelt1 * math.cos(r)
            hdr["CD1_2"] = -1.0 * cdelt2 * math.sin(r)
            hdr["CD2_1"] = cdelt1 * math.sin(r)
            hdr["CD2_2"] = cdelt2 * math.cos(r)
    hdr["EXPOSURE"] = meta.get("exposure", 0.0)
    return hdr
