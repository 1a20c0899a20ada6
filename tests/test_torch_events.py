"""The port's event pipeline (`ops/events.py`) against the JAX package's, on the CPU.

The same seeded numpy event lists go through both packages:

* `gti_from_rate` and `cap_gti_exposure` (including the reference's
  overshoot quirk): equal arrays, bit for bit;
* `bin_events` on the host (`device=None`) and through the torch route with
  `device="cpu"`: both bitwise equal to JAX's host route and to its
  `device=True` (jitted XLA scatter-add) route, for the EPN cuts and the
  EMOS mask, with a GTI, an empty GTI, no GTI, events 1 s either side of
  GTI edges at mission time (~5.6e8 s, where an f32 ulp is 64 s: the torch
  route compares the float64 times) and many GTIs (the power-of-two GTI
  bucket padding); the chunked GTI comparison gives the same image;
* an event within half an f32 ulp of a GTI edge after JAX's rebase: the
  torch route follows the host route, where JAX's device route (f32) does
  not;
* `bin_events_sky` with `sky_wcs_header`, and `products_from_event_file`
  with an FBKTSR rate curve: equal images and equal header values;
* a property sweep over seeds against JAX's host route and an independent
  `np.add.at` count;
* a CUDA device without a card raises: the torch route never falls back.
"""

import numpy as np
import pytest
import torch

import _torch_workers  # noqa: F401  (one share of the cores per xdist worker)

from xmm_superres_denoise_tpu.io import fits as jfits
from xmm_superres_denoise_tpu.ops import events as je
from xmm_superres_denoise_torch.io import fits as tfits
from xmm_superres_denoise_torch.ops import events as te

X0, X1, Y0, Y1 = -16120, 16119, -16440, 16439  # EPN at bin 80: 403 x 411
MISSION_T0 = 5.6e8
PAD = 2**12  # event padding of both device routes (JAX's default is 2**20)
FILTERS = {"EPN": -1, "EMOS1": 0x766BA000}


def _cols(seed, n=3000, t0=0.0, flags=(0, 0, 0, 1, 0x10, 0x2000)):
    g = np.random.default_rng(seed)
    return {
        "TIME": np.sort(g.uniform(t0, t0 + 30_000, n)),
        "DETX": g.integers(X0 - 200, X1 + 200, n).astype(np.int32),  # some off the detector
        "DETY": g.integers(Y0 - 200, Y1 + 200, n).astype(np.int32),
        "PI": g.integers(150, 12_000, n).astype(np.int32),
        "PATTERN": g.integers(0, 13, n).astype(np.int32),
        "FLAG": g.choice(np.array(flags, np.int32), n),
        "X": g.integers(20_000, 32_000, n).astype(np.int32),
        "Y": g.integers(20_000, 32_000, n).astype(np.int32),
    }


def _write(tmp_path, cols, instrume="EPN", name="events.fits"):
    return tfits.write_bintable(
        tmp_path / name, cols, extname="EVENTS",
        header={"INSTRUME": instrume, "ONTIME": 30_000.0, "REFXCRPX": 25921,
                "REFYCRPX": 25921, "REFXCRVL": 187.701875, "REFYCRVL": 12.389,
                "REFXCDLT": -1.38888888888889e-05, "REFYCDLT": 1.38888888888889e-05},
        column_limits={"DETX": (X0, X1), "DETY": (Y0, Y1), "X": (1, 51840), "Y": (1, 51840)},
    )


def _both(path):
    return je.load_event_list(path), te.load_event_list(path)


def _gtis(kind, t0=0.0):
    """(JAX GTI, port GTI) or (None, None)."""
    if kind == "none":
        return None, None
    if kind == "empty":
        s = e = np.array([], float)
    elif kind == "one":
        s, e = np.array([2_000.0]), np.array([25_000.0])
    elif kind == "many":  # 37 GTIs: padded to a bucket of 64
        s = np.arange(37) * 800.0 + 100.0
        e = s + 500.0
    else:
        raise ValueError(kind)
    return je.GTI(s + t0, e + t0), te.GTI(s + t0, e + t0)


def _all_routes(ev_j, ev_t, gj, gt, flag_mask, **kw):
    out = {
        "jax host": je.bin_events(ev_j, gj, flag_mask=flag_mask, **kw)[0],
        "jax device": je.bin_events(ev_j, gj, flag_mask=flag_mask, device=True, pad_to=PAD,
                                    **kw)[0],
        "port host": te.bin_events(ev_t, gt, flag_mask=flag_mask, **kw)[0],
        "port cpu": te.bin_events(ev_t, gt, flag_mask=flag_mask, device="cpu", pad_to=PAD,
                                  **kw)[0],
    }
    return out


def _assert_all_equal(out):
    ref = out["jax host"]
    for k, v in out.items():
        assert v.dtype == np.float32 and v.shape == ref.shape, k
        print(f"{k}: {int(v.sum())} counts, max|diff| vs jax host {np.abs(v - ref).max()}")
        np.testing.assert_array_equal(v, ref, err_msg=k)


@pytest.mark.parametrize("instrument", list(FILTERS))
@pytest.mark.parametrize("gti", ["one", "empty", "none", "many"])
def test_bin_events_all_routes_bitwise_equal(tmp_path, instrument, gti):
    ev_j, ev_t = _both(_write(tmp_path, _cols(seed=len(gti)), instrument))
    gj, gt = _gtis(gti)
    filt = te.instrument_filter(instrument)
    assert filt == je.instrument_filter(instrument)
    out = _all_routes(ev_j, ev_t, gj, gt, filt["flag_mask"], pattern_max=filt["pattern_max"])
    _assert_all_equal(out)
    assert out["port host"].shape == (411, 403)
    if gti == "empty":
        assert out["port host"].sum() == 0
    else:
        assert out["port host"].sum() > 0


@pytest.mark.parametrize("instrument", list(FILTERS))
def test_bin_events_gti_edges_at_mission_time(tmp_path, instrument):
    """Events 1 s either side of each GTI edge at ~5.6e8 s (JAX's
    tests/test_events.py case); JAX's device route with its default event
    padding."""
    cols = _cols(seed=11, n=512, t0=MISSION_T0, flags=(0,))
    t = cols["TIME"]
    t[:64] = MISSION_T0 + 2_000.0 - 1.0
    t[64:128] = MISSION_T0 + 2_000.0 + 1.0
    t[128:192] = MISSION_T0 + 25_000.0 - 1.0
    t[192:256] = MISSION_T0 + 25_000.0 + 1.0
    cols["TIME"] = np.sort(t)
    cols["PI"][:] = 1_000
    cols["PATTERN"][:] = 0
    ev_j, ev_t = _both(_write(tmp_path, cols, instrument))
    gj, gt = _gtis("one", MISSION_T0)
    fm = FILTERS[instrument]
    out = _all_routes(ev_j, ev_t, gj, gt, fm)
    out["jax device, pad 2**20"] = je.bin_events(ev_j, gj, flag_mask=fm, device=True)[0]
    out["port cpu, pad 2**20"] = te.bin_events(ev_t, gt, flag_mask=fm, device="cpu")[0]
    _assert_all_equal(out)
    # an f32 cast of the raw mission times would misplace the edge events
    t32 = cols["TIME"].astype(np.float32).astype(np.float64)
    assert np.any((t32 >= gt.start[0]) != (cols["TIME"] >= gt.start[0]))


@pytest.mark.parametrize("edge", ["start", "stop"])
def test_event_within_half_an_f32_ulp_of_a_gti_edge_follows_the_host(tmp_path, edge):
    """0.4 ms inside (stop) or outside (start) an edge 2e4 s after the first
    event, where the f32 ulp of the rebased time is 1.95 ms: JAX's device
    route rounds it onto the edge and misplaces it; the torch route keeps
    the host's float64 comparison."""
    cols = _cols(seed=13, n=64, t0=MISSION_T0, flags=(0,))
    cols["PI"][:], cols["PATTERN"][:] = 1_000, 0
    cols["DETX"][:], cols["DETY"][:] = 0, 0
    t = np.sort(cols["TIME"])
    t[0] = MISSION_T0
    edge_t = MISSION_T0 + 20_000.0
    s, e = (edge_t - 15_000.0, edge_t) if edge == "stop" else (edge_t, edge_t + 5_000.0)
    t[-1] = edge_t - 0.0004
    cols["TIME"] = np.sort(t)
    ev_j, ev_t = _both(_write(tmp_path, cols))
    gj, gt = je.GTI(np.array([s]), np.array([e])), te.GTI(np.array([s]), np.array([e]))
    host = je.bin_events(ev_j, gj)[0]
    jax_dev = je.bin_events(ev_j, gj, device=True, pad_to=PAD)[0]
    port = te.bin_events(ev_t, gt, device="cpu", pad_to=PAD)[0]
    print(f"{edge}: host {host.sum()}, JAX device route {jax_dev.sum()}, port {port.sum()}")
    np.testing.assert_array_equal(port, host)
    np.testing.assert_array_equal(te.bin_events(ev_t, gt)[0], host)
    assert jax_dev.sum() != host.sum()  # the f32 rounding the port does not inherit


def test_gti_chunking_gives_the_same_image(tmp_path, monkeypatch):
    ev_j, ev_t = _both(_write(tmp_path, _cols(seed=5)))
    gj, gt = _gtis("many")
    whole = te.bin_events(ev_t, gt, device="cpu", pad_to=PAD)[0]
    monkeypatch.setattr(te, "GTI_CHUNK_ELEMENTS", 1000)  # 15 events of 64 GTIs per chunk
    chunked = te.bin_events(ev_t, gt, device="cpu", pad_to=PAD)[0]
    np.testing.assert_array_equal(chunked, whole)
    np.testing.assert_array_equal(chunked, je.bin_events(ev_j, gj)[0])


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cuda_route_raises_without_a_card(tmp_path):
    _, ev_t = _both(_write(tmp_path, _cols(seed=1, n=100)))
    with pytest.raises((RuntimeError, AssertionError)):
        te.bin_events(ev_t, None, device="cuda:0", pad_to=PAD)


@pytest.mark.parametrize(
    "case", [("flare", 0.5), ("no-clean-sample", 0.01), ("short-runs", 0.5)])
def test_gti_from_rate_and_cap_equal_to_jax(case):
    name, thr = case
    t = np.arange(0, 60_000, 10.0)
    rate = np.full_like(t, 0.2)
    rate[3000:3500] = 5.0
    if name == "short-runs":
        rate[::7] = 9.0  # runs of 6 samples = 60 s and the mingtisize cut
    gj = je.gti_from_rate(t, rate, thr)
    gt = te.gti_from_rate(t, rate, thr)
    np.testing.assert_array_equal(gt.start, gj.start)
    np.testing.assert_array_equal(gt.stop, gj.stop)
    for cap in (-1.0, 20.0, 45.0, 1e3):
        cj, ct = je.cap_gti_exposure(gj, cap), te.cap_gti_exposure(gt, cap)
        np.testing.assert_array_equal(ct.start, cj.start)
        np.testing.assert_array_equal(ct.stop, cj.stop)
        assert ct.exposure == cj.exposure


def test_cap_gti_keeps_the_reference_overshoot_quirk():
    # 9 + 8 = 17 ks, then + 5 reaches 22 >= 20: the last GTI keeps 22 - 20 = 2 ks
    gti = te.GTI(np.array([0.0, 20_000.0, 40_000.0]), np.array([9_000.0, 28_000.0, 45_000.0]))
    capped = te.cap_gti_exposure(gti, 20.0)
    want = je.cap_gti_exposure(je.GTI(gti.start, gti.stop), 20.0)
    assert capped.exposure == want.exposure == 19_000.0
    np.testing.assert_array_equal(capped.stop, want.stop)


def test_bin_events_sky_and_wcs_equal_to_jax(tmp_path):
    ev_j, ev_t = _both(_write(tmp_path, _cols(seed=9)))
    gj, gt = _gtis("one")
    sj, mj = je.bin_events_sky(ev_j, gj)
    st, mt = te.bin_events_sky(ev_t, gt)
    assert st.shape == (51840 // 80, 51840 // 80) and mt == mj
    np.testing.assert_array_equal(st, sj)
    hj, ht = je.sky_wcs_header(mj, ev_j.header), te.sky_wcs_header(mt, ev_t.header)
    assert list(ht) == list(hj) and dict(ht) == dict(hj)
    assert ht["CRPIX1"] == (25921 - 1 - 79 / 2) / 80 + 1


@pytest.mark.parametrize("instrument", ["pn", "m1"])
def test_products_from_event_file_with_fbktsr(tmp_path, instrument):
    inst = {"pn": "EPN", "m1": "EMOS1"}[instrument]
    path = _write(tmp_path, _cols(seed=2, t0=MISSION_T0), inst)
    t = MISSION_T0 + np.arange(0, 30_000, 100.0)
    rate = np.full_like(t, 0.2)
    rate[(t >= MISSION_T0 + 10_000) & (t < MISSION_T0 + 15_000)] = 9.0
    rate[::37] = 3.0  # more flares: more GTIs
    fbk = tfits.write_bintable(tmp_path / "fbk.fits", {"TIME": t, "RATE": rate},
                               extname="RATE", header={"FLCUTTHR": 0.5},
                               primary_header={"INSTRUME": inst, "OBS_ID": "0000000000"})
    pj = je.products_from_event_file(path, fbk, max_expo_ks=20.0, instrument=instrument)
    pt = te.products_from_event_file(path, fbk, max_expo_ks=20.0, instrument=instrument)
    assert sorted(pt) == sorted(pj) == ["detxy", "header", "sky"]
    for k in ("detxy", "sky"):
        np.testing.assert_array_equal(pt[k][0], pj[k][0])
        assert pt[k][1] == pj[k][1]
    assert 0 < pt["detxy"][1]["exposure"] <= 20_000.0
    assert dict(pt["header"]) == dict(pj["header"])
    img, meta, hdr = te.detxy_image_from_event_file(path, fbk, instrument=instrument)
    np.testing.assert_array_equal(img, pj["detxy"][0])


def _np_add_at(ev, gti, pi_band, pattern_max, flag_mask, bin_size, x0, y0, nx, ny):
    """An independent count: a per-event selection loop and np.add.at."""
    keep = []
    for i in range(len(ev.time)):
        ok = (pi_band[0] <= ev.pi[i] <= pi_band[1] and (int(ev.flag[i]) & flag_mask) == 0
              and ev.pattern[i] <= pattern_max)
        if ok and gti is not None:
            ok = any(s <= ev.time[i] < e for s, e in zip(gti.start, gti.stop))
        if ok:
            keep.append(i)
    keep = np.array(keep, np.int64)
    ix = (ev.detx[keep].astype(np.int64) - x0) // bin_size
    iy = (ev.dety[keep].astype(np.int64) - y0) // bin_size
    inside = (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny)
    img = np.zeros((ny, nx), np.float32)
    np.add.at(img, (iy[inside], ix[inside]), 1.0)
    return img


def test_binning_property_sweep():
    """24 seeded cases at bin 16 on a small grid: the port's host and torch
    routes against JAX's host route and an independent count."""
    rng = np.random.default_rng(31)
    bin_size, x0, x1, y0, y1 = 16, -200, 199, -120, 135
    hdr = tfits.Header(TFIELDS=2, TTYPE1="DETX", TLMIN1=x0, TLMAX1=x1,
                       TTYPE2="DETY", TLMIN2=y0, TLMAX2=y1)
    for case in range(24):
        n = int(rng.integers(50, 400))
        cols = dict(
            time=np.sort(rng.uniform(0.0, 10_000.0, n)),
            detx=rng.integers(x0 - 40, x1 + 40, n).astype(np.int32),
            dety=rng.integers(y0 - 40, y1 + 40, n).astype(np.int32),
            pi=rng.integers(100, 4000, n).astype(np.int32),
            pattern=rng.integers(0, 13, n).astype(np.int32),
            flag=rng.choice(np.array([0, 0, 0, 1, 0x10, 0x20000], np.int32), n),
        )
        ev_t, ev_j = te.EventList(header=hdr, **cols), je.EventList(header=hdr, **cols)
        n_gti = int(rng.integers(0, 7))
        if n_gti == 0 and rng.random() < 0.5:
            gt = gj = None
        else:
            cuts = np.sort(rng.uniform(0.0, 10_000.0, 2 * n_gti))
            gt, gj = te.GTI(cuts[0::2], cuts[1::2]), je.GTI(cuts[0::2], cuts[1::2])
        kw = dict(bin_size=bin_size, pi_band=(int(rng.integers(100, 900)),
                                              int(rng.integers(1000, 4000))),
                  pattern_max=int(rng.integers(0, 13)),
                  flag_mask=int(rng.choice([-1, 0x20010])))
        want = je.bin_events(ev_j, gj, **kw)[0]
        host = te.bin_events(ev_t, gt, **kw)[0]
        dev = te.bin_events(ev_t, gt, device="cpu", pad_to=256, **kw)[0]
        oracle = _np_add_at(ev_t, gt, kw["pi_band"], kw["pattern_max"], kw["flag_mask"],
                            bin_size, x0, y0, (x1 - x0 + 1) // bin_size,
                            (y1 - y0 + 1) // bin_size)
        for got in (host, dev, oracle):
            np.testing.assert_array_equal(got, want, err_msg=f"case {case}")
