"""Attitude-history (ATTTSR / ATTHK) pointing extraction.

The port's copy of the JAX package's `io/atthk.py`. The PPS attitude
timeseries product (globbed as `*ATTTSR*` by the reference's PPS validator,
`utils/xmmsas_tools.py:99-158`) carries the spacecraft RA/DEC/position-angle
history. SAS summarizes it as the MEDIAN over the observation (event headers
record `AVRG_PNT = MEDIAN` next to RA_PNT/DEC_PNT/PA_PNT); this module
reproduces that summary natively, so the SAS-free detxy pipeline recovers
absolute pointing even for event lists whose headers lack the *_PNT keywords.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from .fits import read_bintable

# Column-name variants across ATTHK generations (AHF* is the atthkgen
# output; bare names appear in some reprocessed products).
_RA_COLS = ("AHFRA", "RA", "MAHFRA")
_DEC_COLS = ("AHFDEC", "DEC", "MAHFDEC")
_PA_COLS = ("AHFPA", "PA", "POSANG", "MAHFPA")


def _pick(cols: Dict[str, np.ndarray], names) -> Optional[np.ndarray]:
    for n in names:
        if n in cols:
            return np.asarray(cols[n], np.float64)
    return None


def pointing_from_atthk(
    path: Path,
    tstart: Optional[float] = None,
    tstop: Optional[float] = None,
) -> Dict[str, float]:
    """Median RA/DEC/PA over [tstart, tstop] (whole file when unbounded).

    Returns {"RA_PNT", "DEC_PNT", "PA_PNT"} in degrees — drop-in values for
    `io.wcs.native_ecoordconv` when the event header lacks them. The median
    matches the AVRG_PNT=MEDIAN convention of the PPS products. RA is
    medianed on the unit circle (wrap-safe); PA likewise.
    """
    cols, _ = read_bintable(path)
    ra = _pick(cols, _RA_COLS)
    dec = _pick(cols, _DEC_COLS)
    pa = _pick(cols, _PA_COLS)
    if ra is None or dec is None or pa is None:
        raise ValueError(
            f"{path}: attitude table lacks RA/DEC/PA columns "
            f"(have {sorted(cols)})"
        )
    sel = np.isfinite(ra) & np.isfinite(dec) & np.isfinite(pa)
    time = _pick(cols, ("TIME",))
    if time is not None and (tstart is not None or tstop is not None):
        if tstart is not None:
            sel &= time >= tstart
        if tstop is not None:
            sel &= time <= tstop
    if not sel.any():
        raise ValueError(f"{path}: no attitude samples in the requested window")

    def _circ_median(deg: np.ndarray) -> float:
        rad = np.radians(deg)
        # rotate so the circular mean sits at 0, median there, rotate back
        mean = np.arctan2(np.sin(rad).mean(), np.cos(rad).mean())
        centered = np.angle(np.exp(1j * (rad - mean)))
        return float((np.degrees(mean + np.median(centered))) % 360.0)

    return {
        "RA_PNT": _circ_median(ra[sel]),
        "DEC_PNT": float(np.median(dec[sel])),
        "PA_PNT": _circ_median(pa[sel]),
    }


def ensure_pointing(
    header,
    atthk_path: Optional[Path] = None,
    window: Optional[Tuple[float, float]] = None,
) -> Dict[str, float]:
    """Pointing from the event header, else derived from the attitude file.

    Raises when neither source is available — absolute WCS cannot be
    constructed without attitude knowledge.
    """
    if all(k in header for k in ("RA_PNT", "DEC_PNT", "PA_PNT")):
        return {k: float(header[k]) for k in ("RA_PNT", "DEC_PNT", "PA_PNT")}
    if atthk_path is None:
        raise ValueError(
            "Event header lacks RA_PNT/DEC_PNT/PA_PNT and no attitude "
            "(ATTTSR) product was provided"
        )
    t0, t1 = window if window is not None else (
        float(header["TSTART"]) if "TSTART" in header else None,
        float(header["TSTOP"]) if "TSTOP" in header else None,
    )
    return pointing_from_atthk(atthk_path, t0, t1)
