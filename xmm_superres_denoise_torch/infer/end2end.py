"""End-to-end obsid inference: raw event list -> detxy -> SR/DN products.

The port of the JAX package's `infer/end2end.py`, the reference's
`inference_end2end_obsid.py` + `produce_detxy_image_for_inference.py:27-92`:
given a PPS directory, derive GTIs, filter + bin events into the native
(411, 403) detxy image, then run the model through the port's
`InferenceEngine` and write WCS-carrying FITS.

Routing: the NATIVE pipeline (ops.events, binning on the host as in the JAX
package); SAS subprocesses only when explicitly requested and available.
`plot=True` adds the products' PNGs (`infer/run_file.py: write_products`).
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict

import numpy as np

from ..io.fits import write_image
from ..io.wcs import detxy_wcs_header
from ..sas.pipeline import check_pps_dir, sas_available
from .run_file import InferenceEngine, infer_file

log = logging.getLogger("xmmsr")


def detxy_for_obsid(
    pps_dir: Path,
    proc_dir: Path,
    instrument: str = "pn",
    max_expo_ks: float = 20.0,
    use_sas: bool = False,
    sky_image: bool = True,
) -> Path:
    """PPS dir -> detxy image FITS (get_detxy_for_obs_id semantics).

    The native path also emits the sky-coordinate (RA/DEC-binned) companion
    image when the event list carries X/Y columns — the reference's
    `radec_image=True` second evselect call (xmmsas_tools.py:552-565) —
    and recovers absolute pointing from the ATTTSR attitude product when
    the event header lacks RA_PNT/DEC_PNT/PA_PNT, so every product carries
    absolute sky WCS SAS-free.
    """
    proc_dir = Path(proc_dir)
    proc_dir.mkdir(parents=True, exist_ok=True)
    pps = check_pps_dir(Path(pps_dir))

    if use_sas and sas_available():
        from ..sas.pipeline import filter_events_gti, make_detxy_image, make_gti_pps

        gtis = make_gti_pps(pps, instrument, proc_dir, max_expo_ks)
        if not gtis:
            raise RuntimeError("No GTIs found.")
        evl = _pick(pps["evl_files"], instrument)
        gti = _pick(gtis, instrument)
        filtered = filter_events_gti(evl, gti, pps, proc_dir)
        return make_detxy_image(filtered, proc_dir, pps)

    # Native path: GTI + filter + bin in one pass.
    evl = _pick(pps["evl_files"], instrument)
    fbk = _pick(pps["fbk_files"], instrument) if pps["fbk_files"] else None
    from ..ops.events import products_from_event_file

    prods = products_from_event_file(
        evl, fbk, max_expo_ks=max_expo_ks, instrument=instrument,
        sky=sky_image,
    )
    img, meta = prods["detxy"]
    hdr = prods["header"]
    if not all(k in hdr for k in ("RA_PNT", "DEC_PNT", "PA_PNT")):
        # Derive the pointing from the attitude timeseries (AVRG_PNT=MEDIAN
        # semantics) so native ecoordconv can still fill the sky WCS.
        att_files = pps.get("att_files") or []
        if att_files:
            from ..io.atthk import ensure_pointing

            try:
                for k, v in ensure_pointing(hdr, att_files[0]).items():
                    hdr[k] = v
            except Exception as e:  # pointing stays absent; header-only WCS
                log.warning("attitude-derived pointing failed: %s", e)
    suffix = f"{max_expo_ks:.0f}ks" if max_expo_ks > 0 else "full"
    out = proc_dir / f"{instrument}_500_2000_detxy_image_{suffix}.fits"
    out_hdr = detxy_wcs_header(meta, hdr)
    write_image(out, img.astype(np.int32), out_hdr)
    log.info(
        "Native detxy image: %s (%.1f ks exposure, %d counts)",
        out, meta.get("exposure", 0) / 1000.0, int(img.sum()),
    )
    if "sky" in prods:
        from ..ops.events import sky_wcs_header

        sky, smeta = prods["sky"]
        sky_out = proc_dir / f"{instrument}_500_2000_radec_image_{suffix}.fits"
        write_image(sky_out, sky.astype(np.int32), sky_wcs_header(smeta, hdr))
        log.info("Native sky (radec) image: %s", sky_out)
    return out


def _pick(files, instrument: str) -> Path:
    key = {"pn": "PN", "m1": "M1", "m2": "M2"}.get(instrument, instrument.upper())
    for f in files:
        if key in f.stem.upper():
            return f
    raise FileNotFoundError(f"No {instrument} file among {files}")


def run_end2end(
    pps_dir: Path,
    engine: InferenceEngine,
    out_dir: Path,
    hr_exp_ks: float,
    model_name: str,
    instrument: str = "pn",
    max_expo_ks: float = 20.0,
    plot: bool = False,
    use_sas: bool = False,
) -> Dict[str, object]:
    """Full obsid chain with its latency breakdown in seconds (binning,
    inference, total; host clock). `plot` adds the products' PNGs."""
    t0 = time.perf_counter()
    detxy = detxy_for_obsid(pps_dir, Path(out_dir) / "proc", instrument,
                            max_expo_ks, use_sas)
    t1 = time.perf_counter()
    p_in, p_pred = infer_file(detxy, engine, out_dir, hr_exp_ks, model_name, plot=plot)
    t2 = time.perf_counter()
    return {
        "detxy": detxy,
        "input": p_in,
        "prediction": p_pred,
        "latency_s": {
            "binning": t1 - t0,
            "inference": t2 - t1,
            "total": t2 - t0,
        },
    }
