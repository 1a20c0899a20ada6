"""XMM-SAS subprocess wrappers (optional path) + PPS directory handling.

The port of the JAX package's `sas/pipeline.py`, the rebuild of the
reference's SAS toolchain layer (`utils/xmmsas_tools.py`): PPS archive
directory validation, GTI generation via `tabgtigen`, event filtering and
DETX/DETY image binning via `evselect`, and the `ecoordconv` WCS fixup,
with the same argument lists.

The SAS binaries are an external dependency; without them, the NATIVE path
(`ops.events.products_from_event_file`) performs the same GTI -> filter ->
bin chain from the FITS bintables, and `infer.end2end` takes it unless
`use_sas` is asked for and SAS is available. Archive download
(`get_pps_nxsa`) talks to the public NXSA AIO endpoint over urllib; offline
it raises a clear error, and pre-downloaded PPS directories remain the
supported path. `subprocess` and `urllib` are imported inside the
functions that use them.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Union

from ..io.fits import read_bintable, read_image
from ..ops.events import GTI, cap_gti_exposure, gti_from_rate

PPSFiles = Dict[str, Union[Path, List[Path]]]

INST_SHORT = {"EMOS1": "m1", "EMOS2": "m2", "EPN": "pn"}

# Hardcoded per-instrument event-selection expressions
# (filter_events_gti, xmmsas_tools.py:437-444)
FILTER_EXPR = {
    "EMOS": "#XMMEA_EM && gti({gti},TIME) && (PI>150) && (PATTERN <= 12)",
    "EPN": "(FLAG == 0) && gti({gti},TIME) && (PI>150) && (PATTERN <= 4)",
}
# Image-selection expressions (make_detxy_image, xmmsas_tools.py:536-539)
IMAGE_EXPR = {
    "EMOS": "PI in [{lo}:{hi}] &&  (FLAG & 0x766ba000)==0 && PATTERN in [0:12]",
    "EPN": "PI in [{lo}:{hi}] &&  FLAG==0 && PATTERN in [0:4]",
}


def sas_available() -> bool:
    """True when the SAS toolchain is initialized (check_sas equivalent,
    xmmsas_tools.py:45-58)."""
    return shutil.which("evselect") is not None and "SAS_DIR" in os.environ


def run_sas_command(args: List[str]) -> "subprocess.CompletedProcess":
    import subprocess

    proc = subprocess.run(args, shell=False, capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"SAS command failed ({args[0]}): {proc.stderr.decode(errors='replace')}"
        )
    return proc


# NXSA "archive inter-operability" endpoint — the same service astroquery's
# XMMNewton.download_data wraps (reference get_pps_nxsa, xmmsas_tools.py:61-96).
NXSA_AIO_URL = (
    "https://nxsa.esac.esa.int/nxsa-sl/servlet/data-action-aio"
    "?obsno={obs_id}&level=PPS&extension=FTZ"
)


def get_pps_nxsa(
    obs_id: str,
    w_dir: Path = Path("."),
    skip: bool = True,
    keeptar: bool = False,
    opener=None,
) -> PPSFiles:
    """Download an observation's PPS products (FTZ only) from the XMM
    archive and index them (get_pps_nxsa semantics, xmmsas_tools.py:61-96).

    `opener(url) -> bytes` is injectable for tests; the default uses
    urllib against the public NXSA AIO endpoint. Zero-egress environments
    get a clear RuntimeError pointing at the pre-downloaded-PPS path.

    Archives carry `<obsid>/pps/...` members. The reference unpacks into
    `w_dir.parent` and reads `w_dir/pps` — a layout that only resolves
    when `w_dir` is itself named after the observation (its default
    `w_dir=cwd` is broken). That working case is preserved exactly;
    any other `w_dir` extracts INSIDE it and indexes
    `w_dir/<obsid>/pps`, so the products always land under the
    requested working dir. The tar is deleted unless `keeptar`.
    """
    import tarfile
    import warnings

    w_dir = Path(w_dir)
    if not w_dir.exists():
        warnings.warn(
            f"The working dir {w_dir} does not exist. Will use the current dir."
        )
        w_dir = Path(".")
    if w_dir.name == obs_id:  # reference layout: <...>/<obsid>/pps
        extract_root, pps_dir = w_dir.parent, w_dir / "pps"
    else:
        extract_root, pps_dir = w_dir, w_dir / obs_id / "pps"

    if pps_dir.exists() and skip:
        return check_pps_dir(pps_dir)
    if pps_dir.exists():
        warnings.warn(
            f"Found an already existing folder {pps_dir} and skip flag is "
            "not set => files will be overwritten!"
        )

    if opener is None:
        def opener(url: str) -> bytes:
            from urllib.request import urlopen

            with urlopen(url, timeout=120) as resp:
                return resp.read()

    tar_path = w_dir / "PPS_nxsa.tar"
    try:
        tar_path.write_bytes(opener(NXSA_AIO_URL.format(obs_id=obs_id)))
    except OSError as e:
        raise RuntimeError(
            f"NXSA download for {obs_id} failed ({e}); in an offline "
            "environment place the PPS products under "
            f"{pps_dir} and rerun."
        ) from e
    try:
        if not tarfile.is_tarfile(tar_path):
            raise RuntimeError(
                f"Downloaded file from NXSA {tar_path} does not look like "
                "tar file."
            )
        with tarfile.open(tar_path, "r") as tar:
            tar.extractall(path=extract_root, filter="data")
    finally:
        # delete-unless-keeptar holds on the failure paths too (an HTML
        # error page or a truncated multi-GB tar must not linger)
        if not keeptar and tar_path.exists():
            tar_path.unlink()
    if not pps_dir.is_dir():
        tops = sorted(p.name for p in extract_root.iterdir() if p.is_dir())
        raise RuntimeError(
            f"NXSA tar for {obs_id} did not contain {pps_dir} "
            f"(extracted top-level dirs: {tops})"
        )
    return check_pps_dir(pps_dir)


def check_pps_dir(pps_dir: Path) -> PPSFiles:
    """Validate a PPS directory and index the needed products
    (xmmsas_tools.py:99-158): calibration index (CALIND), flaring-background
    time series (FBKTSR), imaging event lists (IEVLI), attitude (ATTTSR)."""
    pps_dir = Path(pps_dir)
    if not pps_dir.is_dir():
        raise FileNotFoundError(f"PPS dir {pps_dir} not found")

    def globs(pat: str) -> List[Path]:
        return sorted(pps_dir.glob(pat))

    ccf = globs("*CALIND*")
    fbk = globs("*FBKTSR*")
    evl = globs("*IEVLI*")
    att = globs("*ATTTSR*")
    if not ccf:
        raise FileNotFoundError(f"No calibration index (CALIND) in {pps_dir}")
    if not evl:
        raise FileNotFoundError(f"No imaging event lists (IEVLI) in {pps_dir}")
    return {
        "ccf_file": ccf[0],
        "fbk_files": fbk,
        "evl_files": evl,
        "att_files": att,
        "pps_dir": pps_dir,
    }


def make_gti_pps(
    pps_files: PPSFiles,
    instrument: str = "all",
    out_dir: Path = Path("."),
    max_expo: float = -1.0,
) -> List[Path]:
    """GTIs from the PPS flaring-background threshold (xmmsas_tools.py:216-379).

    Uses `tabgtigen` when SAS is available; otherwise derives the GTI natively
    (ops.events.gti_from_rate) and writes a minimal GTI FITS."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gti_names: List[Path] = []
    for fbk in pps_files["fbk_files"]:
        stem = fbk.stem.upper()
        if instrument.upper() not in stem and instrument.upper() != "ALL":
            continue
        cols, hdr = read_bintable(fbk, columns=["TIME", "RATE"], extname="RATE")
        if "FLCUTTHR" not in hdr:
            continue
        # instrument from the primary header
        from ..io.fits import read_hdus

        inst = read_hdus(fbk)[0][0].get("INSTRUME", "").strip()
        if inst not in INST_SHORT:
            continue
        thr = float(hdr["FLCUTTHR"])
        gti_name = out_dir / f"{INST_SHORT[inst]}_pps.gti"

        if sas_available():
            run_sas_command(
                [
                    "tabgtigen",
                    f"table={fbk}",
                    f"expression=RATE<={thr}",
                    f"gtiset={gti_name}",
                    "mingtisize=50.0",
                ]
            )
            gti = _read_gti_file(gti_name)
        else:
            gti = gti_from_rate(cols["TIME"], cols["RATE"], thr)
            _write_gti_file(gti_name, gti, method="pps", rlim=thr)

        if max_expo > 0:
            gti = cap_gti_exposure(gti, max_expo)
            xname = out_dir / f"{INST_SHORT[inst]}_pps_{max_expo:.1f}ks.gti"
            _write_gti_file(xname, gti, method="pps", rlim=thr)
            gti_names.append(xname)
        else:
            gti_names.append(gti_name)
    return gti_names


def _read_gti_file(path: Path) -> GTI:
    cols, _ = read_bintable(path, columns=["START", "STOP"], extname="STDGTI")
    return GTI(cols["START"].astype(float), cols["STOP"].astype(float))


def _write_gti_file(path: Path, gti: GTI, method: str, rlim: float) -> None:
    """Minimal STDGTI bintable (enough for the native pipeline + bookkeeping)."""
    import numpy as np

    from ..io.fits import write_bintable

    write_bintable(
        path,
        {"START": np.asarray(gti.start, np.float64),
         "STOP": np.asarray(gti.stop, np.float64)},
        extname="STDGTI",
        header={"METHOD": method, "RLIM": rlim},
    )


def filter_events_gti(
    event_list: Path,
    gti_file: Path,
    pps_files: PPSFiles,
    w_dir: Path,
    output_name: Optional[str] = None,
) -> Path:
    """GTI-filter an event list via SAS evselect (xmmsas_tools.py:382-466).

    SAS-only: the native path skips the intermediate filtered event file and
    applies the same predicates inside the binning kernel."""
    if not sas_available():
        raise RuntimeError(
            "SAS not available — use ops.events.detxy_image_from_event_file "
            "for the native filter+bin path"
        )
    os.environ["SAS_CCF"] = str(pps_files["ccf_file"])
    from ..io.fits import read_hdus

    hdus = read_hdus(event_list)
    inst = ""
    for hdr, _ in hdus:
        if hdr.get("EXTNAME", "").strip() == "EVENTS":
            inst = hdr.get("INSTRUME", "").strip()
            break
    family = "EMOS" if "MOS" in inst else "EPN"
    expr = FILTER_EXPR[family].format(gti=gti_file)
    out = Path(w_dir) / (output_name or f"{INST_SHORT.get(inst, 'pn')}_pps_clean.evl")
    run_sas_command(
        [
            "evselect",
            f"table={event_list}",
            "withfilteredset=Y",
            f"filteredset={out}",
            "destruct=Y",
            "keepfilteroutput=Y",
            f"expression={expr}",
        ]
    )
    return out


def make_detxy_image(
    event_list: Path,
    w_dir: Path,
    pps_files: PPSFiles,
    output_name: Optional[str] = None,
    low_energy: int = 500,
    high_energy: int = 2000,
    bin_size: int = 80,
) -> Path:
    """DETX/DETY image via SAS evselect + ecoordconv WCS (xmmsas_tools.py:469-618)."""
    if not sas_available():
        raise RuntimeError(
            "SAS not available — use ops.events.detxy_image_from_event_file"
        )
    from ..io.fits import read_hdus

    inst = ""
    for hdr, _ in read_hdus(event_list):
        if hdr.get("EXTNAME", "").strip() == "EVENTS":
            inst = hdr.get("INSTRUME", "").strip()
            break
    family = "EMOS" if "MOS" in inst else "EPN"
    expr = IMAGE_EXPR[family].format(lo=low_energy, hi=high_energy)
    out = Path(w_dir) / (
        output_name
        or f"{INST_SHORT.get(inst, 'pn')}_{low_energy}_{high_energy}_detxy_image.fits"
    )
    os.environ["SAS_ODF"] = str(pps_files["pps_dir"])
    os.environ["SAS_CCF"] = str(pps_files["ccf_file"])
    run_sas_command(
        [
            "evselect",
            f"table={event_list}",
            "xcolumn=DETX",
            "ycolumn=DETY",
            "imagebinning=binSize",
            f"ximagebinsize={bin_size}",
            f"yimagebinsize={bin_size}",
            "squarepixels=yes",
            f"expression={expr}",
            "withimageset=true",
            f"imageset={out}",
        ]
    )
    # WCS fixup via ecoordconv at DETX,DETY = 0,0 (xmmsas_tools.py:567-618)
    status = run_sas_command(
        ["ecoordconv", f"imageset={out}", "x=0", "y=0", "coordtype=det"]
    )
    xima = yima = ra = dec = None
    for line in status.stdout.decode().split("\n"):
        parts = line.split()
        if "IM_X:" in line and len(parts) >= 4:
            xima, yima = parts[2], parts[3]
        if "DEC:" in line and len(parts) >= 4:
            ra, dec = parts[2], parts[3]
    if xima is not None:
        import math

        img, hdr = read_image(out)
        hdr["CRVAL1"] = float(ra)
        hdr["CRVAL2"] = float(dec)
        hdr["CRPIX1"] = float(xima)
        hdr["CRPIX2"] = float(yima)
        cdelt1 = bin_size * float(hdr["REFYCDLT"])
        cdelt2 = -bin_size * float(hdr["REFXCDLT"])
        hdr["CDELT1"] = cdelt1
        hdr["CDELT2"] = cdelt2
        hdr["CTYPE1"] = "RA---TAN"
        hdr["CTYPE2"] = "DEC--TAN"
        crota2 = 90.0 - float(hdr["PA_PNT"])
        hdr["CROT2"] = crota2
        r = math.radians(crota2)
        hdr["CD1_1"] = cdelt1 * math.cos(r)
        hdr["CD1_2"] = -1.0 * cdelt2 * math.sin(r)
        hdr["CD2_1"] = cdelt1 * math.sin(r)
        hdr["CD2_2"] = cdelt2 * math.cos(r)
        from ..io.fits import write_image

        write_image(out, img, hdr)
    return out


