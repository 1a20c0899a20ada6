"""XMM output-product FITS writing with the input's WCS carried through.

The port's own numpy-only copy of `write_xmm_product_wcs` and the helpers it
calls from the JAX package's `io/wcs.py`: the
empirical pad shift CRPIX+=(6, 2) (the 416-pad offset of the native 403x411
frame), and for 2x outputs the CRPIX/CDELT rescale plus the CROTA2/CD matrix
from `PA_PNT`.
"""

from __future__ import annotations

import math
import re
from pathlib import Path
from typing import Optional

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
