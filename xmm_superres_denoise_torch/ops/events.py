"""Native event-list -> detector-coordinate image pipeline (SAS-free).

The port of the JAX package's `ops/events.py`, which replaces the
reference's subprocess chain around XMM-SAS (`utils/xmmsas_tools.py`) with
direct FITS bintable reads and a binning pass, so the end-to-end obsid path
runs without the SAS toolchain:

  1. GTI derivation: flaring-background RATE curve vs the PPS `FLCUTTHR`
     threshold, contiguous below-threshold runs >= mingtisize (the
     `tabgtigen expression="RATE<=thr" mingtisize=50` semantics,
     xmmsas_tools.py:282-290).
  2. Exposure capping at max_expo ks, largest-GTI-first accumulation
     (max_expo_gti, xmmsas_tools.py:160-213, including its keep-the-
     overshoot quirk on the last accumulated GTI, preserved deliberately).
  3. Event filtering per instrument family + GTI membership: EPN
     `FLAG==0 && PATTERN<=4`, EMOS `(FLAG & 0x766ba000)==0 && PATTERN<=12`
     (filter_events_gti, xmmsas_tools.py:437-444; INSTRUMENT_FILTERS below).
  4. DETX/DETY binning with `PI in [500,2000]` + the instrument cuts at bin
     80 (=4"/px) over the detector's TLMIN/TLMAX bounds, the `evselect
     imagebinning=binSize` geometry (make_detxy_image,
     xmmsas_tools.py:469-547).

The binning runs on the host (numpy `bincount`, `bin_events(device=None)`,
the route `products_from_event_file` and the end-to-end chain take, as in
the JAX package) or on a torch device (`bin_events(device=...)`): the same
predicates, a flat pixel index with an overflow bin for rejected events and
`torch.bincount`, bitwise equal to the host route.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..io.fits import Header, read_bintable
from ..io.native_bintable import read_bintable_fast

PN_BIN_SIZE = 80  # in 0.05" units -> 4"/pixel
PN_PI_BAND = (500, 2000)  # eV

# Per-instrument event-quality filters (reference xmmsas_tools.py:437-444,
# 536-539): EPN uses `FLAG==0 && PATTERN<=4`; EMOS uses the #XMMEA_EM-style
# mask `(FLAG & 0x766ba000)==0 && PATTERN<=12`. FLAG==0 is expressed
# uniformly as (FLAG & mask)==0 with an all-ones mask.
INSTRUMENT_FILTERS = {
    "EPN": {"flag_mask": -1, "pattern_max": 4},
    "EMOS1": {"flag_mask": 0x766BA000, "pattern_max": 12},
    "EMOS2": {"flag_mask": 0x766BA000, "pattern_max": 12},
}
_INSTRUMENT_ALIASES = {
    "pn": "EPN", "m1": "EMOS1", "m2": "EMOS2",
    "mos1": "EMOS1", "mos2": "EMOS2",
}


def instrument_filter(name: str) -> dict:
    """Look up the quality-filter family for an instrument name or alias
    ('pn'/'m1'/'m2' or an event header's INSTRUME value)."""
    key = _INSTRUMENT_ALIASES.get(str(name).strip().lower(), str(name).strip().upper())
    if key not in INSTRUMENT_FILTERS:
        raise ValueError(
            f"Unknown EPIC instrument {name!r}; expected one of "
            f"{sorted(INSTRUMENT_FILTERS) + sorted(_INSTRUMENT_ALIASES)}"
        )
    return INSTRUMENT_FILTERS[key]


# --------------------------------------------------------------------------- #
# 1-2. GTI derivation and exposure capping
# --------------------------------------------------------------------------- #


@dataclass
class GTI:
    start: np.ndarray  # (n,) seconds
    stop: np.ndarray

    @property
    def exposure(self) -> float:
        return float(np.sum(self.stop - self.start))


def gti_from_rate(
    time: np.ndarray,
    rate: np.ndarray,
    threshold: float,
    mingtisize: float = 50.0,
) -> GTI:
    """Below-threshold runs of the flaring-background curve as GTIs.

    tabgtigen semantics: contiguous samples with RATE <= threshold form an
    interval [t_first, t_last + dt); intervals shorter than `mingtisize`
    seconds are dropped (xmmsas_tools.py:286-290).
    """
    time = np.asarray(time, np.float64)
    rate = np.asarray(rate, np.float64)
    good = rate <= threshold
    if not good.any():
        return GTI(np.empty(0), np.empty(0))
    dt = float(np.median(np.diff(time))) if len(time) > 1 else 0.0

    stops_idx = []
    run_start = None
    for i, g in enumerate(good):
        if g and run_start is None:
            run_start = i
        elif not g and run_start is not None:
            stops_idx.append((run_start, i - 1))
            run_start = None
    if run_start is not None:
        stops_idx.append((run_start, len(good) - 1))

    start_t = np.array([time[a] for a, _ in stops_idx])
    stop_t = np.array([time[b] + dt for _, b in stops_idx])
    keep = (stop_t - start_t) >= mingtisize
    return GTI(start_t[keep], stop_t[keep])


def cap_gti_exposure(gti: GTI, max_expo_ks: float) -> GTI:
    """Cap total GTI exposure at max_expo ks (max_expo_gti semantics,
    xmmsas_tools.py:160-213).

    Reproduces the reference's behavior exactly, including the documented
    quirk (SURVEY.md §2.4): in the accumulate branch the final GTI's stop is
    set to start + (sum - max_expo) — i.e. the *overshoot* — rather than the
    remainder needed to reach max_expo. Preserved because downstream exposure
    bookkeeping in shipped products was produced with this behavior.
    """
    if max_expo_ks <= 0:
        return gti
    max_sec = max_expo_ks * 1000.0
    start, stop = gti.start.copy(), gti.stop.copy()
    delta = stop - start
    n = len(delta)
    mask = np.zeros(n, bool)

    ix = np.where(delta >= max_sec)[0]
    if len(ix) == 1:
        mask[ix] = True
        stop[ix] = start[ix] + max_sec
    elif len(ix) > 1:
        imax = int(np.argmax(delta))
        mask[imax] = True
        stop[imax] = start[imax] + max_sec
    else:
        order = np.argsort(delta)[::-1]
        total = 0.0
        for j in order:
            total += delta[j]
            if total >= max_sec:
                mask[j] = True
                stop[j] = start[j] + (total - max_sec)  # reference quirk
                break
            mask[j] = True
    return GTI(start[mask], stop[mask])


# --------------------------------------------------------------------------- #
# 3-4. Event filtering + on-device binning
# --------------------------------------------------------------------------- #


@dataclass
class EventList:
    """Columns of an EPIC EVENTS extension + detector-coordinate bounds.

    `x`/`y` are the sky-pixel columns (attcalc output, 0.05"/unit TAN grid
    around the pointing) when present — consumed by the sky-image product
    (reference make_detxy_image radec_image=True, xmmsas_tools.py:552-565)."""

    time: np.ndarray
    detx: np.ndarray
    dety: np.ndarray
    pi: np.ndarray
    pattern: np.ndarray
    flag: np.ndarray
    header: Header
    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None

    @property
    def detx_bounds(self) -> Tuple[int, int]:
        return self._bounds("DETX")

    @property
    def dety_bounds(self) -> Tuple[int, int]:
        return self._bounds("DETY")

    @property
    def x_bounds(self) -> Tuple[int, int]:
        return self._bounds("X")

    @property
    def y_bounds(self) -> Tuple[int, int]:
        return self._bounds("Y")

    def _bounds(self, col: str) -> Tuple[int, int]:
        idx = None
        for i in range(1, int(self.header["TFIELDS"]) + 1):
            if str(self.header.get(f"TTYPE{i}", "")).strip() == col:
                idx = i
                break
        if idx is None or f"TLMIN{idx}" not in self.header:
            arr = {"DETX": self.detx, "DETY": self.dety,
                   "X": self.x, "Y": self.y}[col]
            if arr is None:
                raise ValueError(f"No {col} column or TLMIN/TLMAX bounds")
            return int(arr.min()), int(arr.max())
        return int(self.header[f"TLMIN{idx}"]), int(self.header[f"TLMAX{idx}"])


def load_event_list(path: Path) -> EventList:
    # Native C column reader when available (multithreaded single-pass
    # decode, native/fits_reader.cc); transparent pure-Python fallback.
    cols, hdr = read_bintable_fast(
        path,
        columns=["TIME", "DETX", "DETY", "PI", "PATTERN", "FLAG", "X", "Y"],
        extname="EVENTS",
    )
    missing = [c for c in ("TIME", "DETX", "DETY", "PI") if c not in cols]
    if missing:
        raise ValueError(f"{path}: EVENTS table missing columns {missing}")
    n = len(cols["TIME"])
    return EventList(
        time=np.asarray(cols["TIME"], np.float64),
        detx=np.asarray(cols["DETX"], np.int32),
        dety=np.asarray(cols["DETY"], np.int32),
        pi=np.asarray(cols["PI"], np.int32),
        pattern=np.asarray(cols.get("PATTERN", np.zeros(n)), np.int32),
        flag=np.asarray(cols.get("FLAG", np.zeros(n)), np.int32),
        header=hdr,
        x=np.asarray(cols["X"], np.int32) if "X" in cols else None,
        y=np.asarray(cols["Y"], np.int32) if "Y" in cols else None,
    )


# elements of the (events, GTIs) membership comparison held at once: the
# comparison runs over chunks of events, so a flare-heavy list does not
# allocate N x G booleans in one piece (the result is the same)
GTI_CHUNK_ELEMENTS = 1 << 26
OVERFLOW_BINS = 1024


def _bin_events_device(
    detx: torch.Tensor,
    dety: torch.Tensor,
    pi: torch.Tensor,
    pattern: torch.Tensor,
    flag: torch.Tensor,
    time: torch.Tensor,
    gti_start: torch.Tensor,  # (G,) padded with +inf (never-true intervals)
    gti_stop: torch.Tensor,  # (G,) padded with -inf
    *,
    nx: int,
    ny: int,
    bin_size: int,
    x0: int,
    y0: int,
    pi_lo: int,
    pi_hi: int,
    pattern_max: int,
    flag_mask: int = -1,
) -> torch.Tensor:
    """Filter + histogram events into an (ny, nx) f32 image on the tensors'
    device.

    One pass: predicates (PI band, (FLAG & mask)==0, PATTERN, GTI
    membership) -> flat pixel index, an overflow bin past the image for a
    rejected event -> `torch.bincount`. `time` and the GTI bounds are the
    host's float64 mission times, so GTI membership is the host route's
    comparison, bit for bit. (The JAX package rebases them to the first
    event and casts to f32, its device's type: an event within half an f32
    ulp — ~1 ms at 2e4 s after the origin — of a GTI edge then lands on the
    wrong side; chip_smoke.py's 4 M-event list holds such events.)
    flag_mask=-1 (all ones) is the EPN FLAG==0 cut; EMOS uses 0x766ba000
    (xmmsas_tools.py:536-539).
    """
    n, g = time.shape[0], gti_start.shape[0]
    step = max(1, GTI_CHUNK_ELEMENTS // max(g, 1))
    in_gti = torch.empty(n, dtype=torch.bool, device=time.device)
    for s in range(0, n, step):
        t = time[s : s + step, None]
        in_gti[s : s + step] = torch.any(
            (t >= gti_start[None, :]) & (t < gti_stop[None, :]), dim=1)

    valid = (
        (pi >= pi_lo)
        & (pi <= pi_hi)
        & (torch.bitwise_and(flag, flag_mask) == 0)
        & (pattern <= pattern_max)
        & in_gti
    )
    ix = torch.div(detx - x0, bin_size, rounding_mode="floor")
    iy = torch.div(dety - y0, bin_size, rounding_mode="floor")
    valid &= (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    # a rejected event goes to one of OVERFLOW_BINS bins past the image, by
    # its row: most events fail a cut, and one shared overflow bin would
    # serialize their atomic increments on one address
    spill = nx * ny + torch.arange(n, device=detx.device) % OVERFLOW_BINS
    flat = torch.where(valid, iy * nx + ix, spill)
    counts = torch.bincount(flat, minlength=nx * ny + OVERFLOW_BINS)
    return counts[: nx * ny].reshape(ny, nx).to(torch.float32)


def _event_selection(
    events: EventList,
    gti: Optional[GTI],
    pi_band: Tuple[int, int],
    pattern_max: int,
    flag_mask: int = -1,
) -> np.ndarray:
    """Quality + band + GTI predicate shared by the detxy and sky binners."""
    sel = (
        (events.pi >= pi_band[0])
        & (events.pi <= pi_band[1])
        & ((events.flag & np.int32(flag_mask)) == 0)
        & (events.pattern <= pattern_max)
    )
    if gti is not None:
        # An EMPTY GTI selects zero events (SAS evselect with an empty GTI
        # table keeps nothing) — the all-False init handles it; only
        # gti=None means "no time filtering".
        in_gti = np.zeros(events.time.shape, bool)
        for s, e in zip(gti.start, gti.stop):
            in_gti |= (events.time >= s) & (events.time < e)
        sel &= in_gti
    return sel


def _bincount_image(
    cx: np.ndarray, cy: np.ndarray, nx: int, ny: int, bin_size: int,
    x0: int, y0: int,
) -> np.ndarray:
    ix = (cx - x0) // bin_size
    iy = (cy - y0) // bin_size
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    flat = (iy[inside] * nx + ix[inside]).astype(np.int64)
    return (
        np.bincount(flat, minlength=nx * ny).reshape(ny, nx).astype(np.float32)
    )


def _bin_events_host(
    events: EventList,
    gti: Optional[GTI],
    nx: int,
    ny: int,
    bin_size: int,
    x0: int,
    y0: int,
    pi_band: Tuple[int, int],
    pattern_max: int,
    flag_mask: int = -1,
) -> np.ndarray:
    """Vectorized numpy filter + bincount: the route for events that live on
    the host (`bin_events(device=None)`)."""
    sel = _event_selection(events, gti, pi_band, pattern_max, flag_mask)
    return _bincount_image(
        events.detx[sel], events.dety[sel], nx, ny, bin_size, x0, y0
    )


def bin_events_sky(
    events: EventList,
    gti: Optional[GTI] = None,
    bin_size: int = PN_BIN_SIZE,
    pi_band: Tuple[int, int] = PN_PI_BAND,
    pattern_max: int = 4,
    flag_mask: int = -1,
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Sky-coordinate (X/Y) count image — the reference's second evselect
    call (make_detxy_image radec_image=True, xmmsas_tools.py:552-565).

    X/Y are attcalc sky pixels (0.05"/unit TAN grid around the pointing);
    binning over the column TLMIN/TLMAX bounds at the same bin size yields
    the RA/DEC-aligned product. The returned meta carries the grid origin
    for `sky_wcs_header`.
    """
    if events.x is None or events.y is None:
        raise ValueError(
            "Event list has no X/Y sky columns — an un-attcalc'd event "
            "list can only produce the detxy product"
        )
    x0, x1 = events.x_bounds
    y0, y1 = events.y_bounds
    nx = (x1 - x0 + 1) // bin_size
    ny = (y1 - y0 + 1) // bin_size
    sel = _event_selection(events, gti, pi_band, pattern_max, flag_mask)
    img = _bincount_image(
        events.x[sel], events.y[sel], nx, ny, bin_size, x0, y0
    )
    return img, {
        "bin_size": bin_size, "x0": x0, "y0": y0, "nx": nx, "ny": ny,
        "exposure": gti.exposure if gti is not None else float("nan"),
    }


def sky_wcs_header(meta: Dict[str, float], in_header: Header) -> Header:
    """RA/DEC WCS for a sky-binned image, from the event header's REFX/REFY
    sky-frame keywords (the attcalc TAN grid: CRPIX 25921 at the pointing,
    0.05"/unit) rescaled to the binned grid."""
    from ..io.wcs import is_table_card

    hdr = Header()
    for k, v in in_header.items():
        if not is_table_card(k):  # no EVENTS bintable cards in an image
            hdr[k] = v
    b = float(meta["bin_size"])
    if "REFXCRPX" in in_header:
        hdr["CTYPE1"] = "RA---TAN"
        hdr["CTYPE2"] = "DEC--TAN"
        hdr["CRVAL1"] = float(in_header["REFXCRVL"])
        hdr["CRVAL2"] = float(in_header["REFYCRVL"])
        # Binned pixel p (1-based) covers unbinned coords
        # [x0 + (p-1)b - 0.5, x0 + pb - 0.5), so the continuous mapping is
        # P(u) = (u - x0 - (b-1)/2)/b + 1 — the same convention as the
        # detxy product's logical-coordinate keywords (io/wcs.py).
        hdr["CRPIX1"] = (
            float(in_header["REFXCRPX"]) - meta["x0"] - (b - 1.0) / 2.0
        ) / b + 1.0
        hdr["CRPIX2"] = (
            float(in_header["REFYCRPX"]) - meta["y0"] - (b - 1.0) / 2.0
        ) / b + 1.0
        hdr["CDELT1"] = b * float(in_header["REFXCDLT"])
        hdr["CDELT2"] = b * float(in_header["REFYCDLT"])
        hdr["CUNIT1"] = "deg"
        hdr["CUNIT2"] = "deg"
    hdr["EXPOSURE"] = meta.get("exposure", 0.0)
    return hdr


def _device_inputs(
    events: EventList,
    gti: Optional[GTI],
    pad_to: int,
    device: torch.device,
) -> Tuple[torch.Tensor, ...]:
    """The positional arguments of `_bin_events_device` on `device`: the
    event columns padded to a power of two >= `pad_to` with rows that fail
    the cuts, and the float64 times and GTI bounds."""
    n = len(events.time)
    size = pad_to
    while size < n:
        size *= 2

    def pad(a, fill=0):
        out = np.full((size,), fill, a.dtype)
        out[:n] = a
        return out

    if gti is None:  # no time filtering: one open interval
        gti_start = np.array([-np.inf])
        gti_stop = np.array([np.inf])
    elif len(gti.start) == 0:
        # an empty GTI selects ZERO events (matches _event_selection / SAS)
        gti_start = np.array([np.inf])
        gti_stop = np.array([-np.inf])
    else:
        gti_start, gti_stop = gti.start, gti.stop

    gti_start = np.asarray(gti_start, np.float64)
    gti_stop = np.asarray(gti_stop, np.float64)

    # Pad the GTI table to a power-of-two bucket with never-true intervals,
    # as the JAX package does (there so that flare-heavy observations reuse
    # a handful of compiled kernels); the counts do not depend on it.
    g_bucket = max(1, 1 << (len(gti_start) - 1).bit_length())
    g_pad = g_bucket - len(gti_start)
    if g_pad:
        gti_start = np.concatenate([gti_start, np.full(g_pad, np.inf)])
        gti_stop = np.concatenate([gti_stop, np.full(g_pad, -np.inf)])

    host = (
        pad(events.detx),
        pad(events.dety),
        pad(events.pi, fill=-1),  # padded rows fail the PI cut
        pad(events.pattern, fill=99),
        pad(events.flag, fill=1),
        pad(events.time.astype(np.float64), fill=np.inf),
        gti_start,
        gti_stop,
    )
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in host)


def bin_events(
    events: EventList,
    gti: Optional[GTI] = None,
    bin_size: int = PN_BIN_SIZE,
    pi_band: Tuple[int, int] = PN_PI_BAND,
    pattern_max: int = 4,
    flag_mask: int = -1,
    pad_to: int = 2**20,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, Dict[str, float]]:
    """Produce the (ny, nx) detxy count image + WCS-ish metadata.

    Geometry follows evselect binSize mode over the detector TLMIN/TLMAX
    bounds: nx = floor((xmax - xmin + 1) / bin) etc., pixel (0,0) at
    (TLMIN, TLMIN). For EPN at bin 80 this yields the (411, 403) native
    image the models expect.

    `device=None` bins on the host (numpy bincount). A torch device (or its
    name) copies the padded columns there and bins with
    `_bin_events_device`; on a CUDA device that runs on the card or raises.
    Both routes give the same image, bit for bit.
    """
    x0, x1 = events.detx_bounds
    y0, y1 = events.dety_bounds
    nx = (x1 - x0 + 1) // bin_size
    ny = (y1 - y0 + 1) // bin_size
    meta = {
        "bin_size": bin_size, "x0": x0, "y0": y0, "nx": nx, "ny": ny,
        "exposure": gti.exposure if gti is not None else float("nan"),
    }
    if device is None:
        img = _bin_events_host(
            events, gti, nx, ny, bin_size, x0, y0, pi_band, pattern_max,
            flag_mask,
        )
        return img, meta

    img = _bin_events_device(
        *_device_inputs(events, gti, pad_to, torch.device(device)),
        nx=nx, ny=ny, bin_size=bin_size, x0=x0, y0=y0,
        pi_lo=pi_band[0], pi_hi=pi_band[1], pattern_max=pattern_max,
        flag_mask=flag_mask,
    )
    return img.cpu().numpy(), meta


def products_from_event_file(
    event_path: Path,
    fbk_path: Optional[Path] = None,
    max_expo_ks: float = 20.0,
    bin_size: int = PN_BIN_SIZE,
    pi_band: Tuple[int, int] = PN_PI_BAND,
    instrument: Optional[str] = None,
    sky: bool = True,
) -> Dict[str, object]:
    """Full native chain: event FITS (+ optional FBKTSR) -> image products.

    The native equivalent of produce_detxy_image_for_inference.py's
    get_detxy_for_obs_id (GTI -> filter -> bin), minus the subprocess hops;
    it bins on the host, as the JAX package does.
    Returns {"detxy": (img, meta), "header": Header[, "sky": (img, meta)]}:
    the sky product (reference radec_image=True) shares the same GTI/filter
    pass and appears whenever the event list carries X/Y columns.
    """
    events = load_event_list(event_path)
    inst = instrument or str(events.header.get("INSTRUME", "EPN"))
    filt = instrument_filter(inst)

    gti = None
    if fbk_path is not None:
        cols, fbk_hdr = read_bintable(
            fbk_path, columns=["TIME", "RATE"], extname="RATE"
        )
        thr = fbk_hdr.get("FLCUTTHR")
        if thr is not None:
            gti = gti_from_rate(cols["TIME"], cols["RATE"], float(thr))
            gti = cap_gti_exposure(gti, max_expo_ks)

    img, meta = bin_events(
        events, gti, bin_size=bin_size, pi_band=pi_band,
        pattern_max=filt["pattern_max"], flag_mask=filt["flag_mask"],
    )
    if gti is None:
        meta["exposure"] = float(events.header.get("ONTIME", float("nan")))
    out: Dict[str, object] = {"detxy": (img, meta), "header": events.header}
    if sky and events.x is not None and events.y is not None:
        sky_img, sky_meta = bin_events_sky(
            events, gti, bin_size=bin_size, pi_band=pi_band,
            pattern_max=filt["pattern_max"], flag_mask=filt["flag_mask"],
        )
        sky_meta["exposure"] = meta["exposure"]
        out["sky"] = (sky_img, sky_meta)
    return out


def detxy_image_from_event_file(
    event_path: Path,
    fbk_path: Optional[Path] = None,
    max_expo_ks: float = 20.0,
    bin_size: int = PN_BIN_SIZE,
    pi_band: Tuple[int, int] = PN_PI_BAND,
    instrument: Optional[str] = None,
) -> Tuple[np.ndarray, Dict[str, float], Header]:
    """detxy-only wrapper over `products_from_event_file` (stable API)."""
    prods = products_from_event_file(
        event_path, fbk_path, max_expo_ks=max_expo_ks, bin_size=bin_size,
        pi_band=pi_band, instrument=instrument, sky=False,
    )
    img, meta = prods["detxy"]
    return img, meta, prods["header"]
