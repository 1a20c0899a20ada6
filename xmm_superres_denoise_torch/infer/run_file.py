"""Single-file and batched inference: detxy FITS -> model -> SR/DN FITS
(+ PNG plots).

The port of the JAX package's `infer/run_file.py`. The engine's
pipeline is the JAX one, step for step: mask -> pad -> (crop) -> normalize
-> model -> clip -> denormalize. PyTorch runs it eagerly on `device`
(`cuda:0` unless the caller asks for the CPU) for any model of the
registry; an RRDB model's dense blocks run on the hand-written kernel when
the device is a card, a transformer of the zoo runs PyTorch's ops.
`quantize=True` serves the RRDB models through the int8 space-to-depth
forward (`ops/int8_forward.py`, every int8 convolution on the K3 kernel).

`mesh` serves each batch over a data axis of devices, one model replica
each, as JAX's `NamedSharding(mesh, P("data"))` does from one process.
Chunks are pipelined: up to `_INFLIGHT` chunks' device work is queued
ahead of the host readback of the oldest, which lands in pinned buffers
through non-blocking copies, each guarded by a CUDA event. As each chunk
is read back its rows are copied into the call's output arrays, while the
later chunks still run on the card; every call's arrays are fresh, and no
later call reuses them.

`serve_files` serves a set of files through one warm engine and
`watch_and_serve` polls directories as a daemon; the HTTP service is
`infer/http_server.py` and the command line `cli.py`, which also binds saved
int8 scales to the checkpoint. `plot=True` adds the 99.5-percentile plasma
PNGs beside the products (matplotlib, imported when a plot is drawn). The
port's library functions default to `plot=False`, the CLI's default in both
packages: JAX's library functions default to True, and the port runs on
machines without matplotlib.
"""

from __future__ import annotations

import json
import logging
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config.schema import DatasetCfg, ModelCfg
from ..io.fits import read_header, read_image
from ..io.wcs import write_xmm_product_wcs
from ..models.registry import build_model
from ..ops.precision import true_f32
from ..ops.preprocess import crop, crop_fractions, pad_to_res
from ..ops.stretch import Normalizer
from ..utils.profiling import annotate

log = logging.getLogger("xmmsr")

EXPOSURE_WINDOW_KS = (15.0, 25.0)  # training regime sanity band


class _Replica:
    """One entry of the data axis: a device with its own copy of the model,
    the detector mask and (int8) the built forward."""

    def __init__(self, device: torch.device, model: torch.nn.Module, mask):
        self.device = device
        self.model = model
        self.mask = mask
        self.forward_i8 = None


class _Readback:
    """The host copies of one launched chunk: per shard, its output buffers
    (pinned on a card, final on the CPU) and the CUDA event recorded after
    their copies (None on the CPU). `result()` waits for each event before
    the bytes are read. A chunk of one shard read back on its own returns
    views of its buffers; otherwise each shard is copied into its rows of
    the output arrays, the mesh padding trimmed, and the buffers are left to
    the caching host allocator for a later chunk."""

    def __init__(self, parts, valid: int):
        self.parts = parts
        self.valid = valid

    def empty(self, rows: int) -> Tuple[np.ndarray, ...]:
        """Fresh host arrays of `rows` images, one per output of the chunk."""
        return tuple(np.empty((rows, *b.shape[1:]), np.float32) for b in self.parts[0][0])

    def result(self, outs: Optional[Tuple[np.ndarray, ...]] = None,
               row: int = 0) -> Tuple[np.ndarray, ...]:
        """The chunk's outputs, trimmed to its valid images. With `outs`
        they are copied into rows `row:` of those arrays, which are
        returned; without, a chunk of one shard returns views of its
        buffers, one of several shards fresh arrays."""
        with annotate("engine.readback"):
            if outs is None and len(self.parts) == 1:
                (bufs, event), = self.parts
                self._wait(event)
                return tuple(b.numpy()[: self.valid] for b in bufs)
            if outs is None:
                outs = self.empty(self.valid)
            dst = [torch.from_numpy(o[row : row + self.valid]) for o in outs]
            with annotate("engine.first_touch"):
                for d in dst:
                    # fresh pages fault on first touch: take that cost while the
                    # card still runs this chunk, so the copy after the wait does not
                    d.zero_()
            for _, event in self.parts:
                self._wait(event)
            with annotate("engine.gather"):
                lo = 0
                for bufs, _ in self.parts:
                    n = min(len(bufs[0]), self.valid - lo)
                    if n <= 0:
                        break  # the rest is mesh padding
                    for d, b in zip(dst, bufs):
                        d[lo : lo + n].copy_(b[:n])
                    lo += n
            return outs

    @staticmethod
    def _wait(event) -> None:
        if event is not None:
            with annotate("engine.readback_wait"):
                # a non-blocking copy read before its event completes
                # yields stale bytes, and nothing reports it
                event.synchronize()


class InferenceEngine:
    """A detxy-image -> prediction pipeline with the weights resident on
    `device`, or on each device of `mesh`.

    `params` is a state_dict for the configured model (`params_from_flax`
    converts the JAX package's Flax tree). `dtype=torch.bfloat16` runs the
    model in bf16 (params cast once; normalization and denormalization stay
    f32 for product fidelity), the serving configuration. f32 (default) is
    the parity configuration and runs with TF32 off (`ops/precision.py`).
    `crop_p` < 1 crops the padded input to that fraction before
    normalization, origin per `dataset_config.crop_mode`.

    `quantize=True` serves through the statically calibrated w8a8 S2D
    forward (`ops/int8_forward.py`) with epilogues in `dtype`. Activation
    scales are calibrated lazily from the first batch passed to the engine,
    or taken from `int8_scales` (a `calibrate_int8_scales` dict, the same
    JSON the JAX package writes); after first use they are in
    `self.int8_scales`. Only the RRDB generators quantise.

    `mesh`, a sequence of devices, replaces `device`: one replica of the
    model per entry, built from the same state_dict. A batch of B > 1 is
    padded to a multiple of the mesh size by repeating its last tile, split
    into equal shards, shard i run on replica i, and the outputs gathered
    in order and trimmed; a batch of 1 runs on `mesh[0]`. Every shard is
    launched before any is read back. Repeated devices are allowed (two
    replicas on one card, or on the CPU). int8 scales are calibrated once,
    on `mesh[0]` over the whole first batch, and every replica's forward is
    built from them.

    `run_tiles` and `predict_tiles` return arrays allocated fresh for the
    call, each chunk copied in as it is read back; no later call writes
    them. `__call__` returns views of the batch's pinned buffers (fresh
    arrays on a mesh).

    The engine marks its stages as `engine.*` spans (`utils/profiling.py:
    annotate`) for a profiler that records.
    """

    # chunks whose device work stays queued ahead of the host readback of
    # the oldest; the pinned host buffers then hold _INFLIGHT + 1 chunks
    _INFLIGHT = 2

    def __init__(
        self,
        model_config: ModelCfg,
        dataset_config: DatasetCfg,
        params: Mapping[str, torch.Tensor],
        det_mask: Optional[np.ndarray] = None,
        dtype: torch.dtype = torch.float32,
        crop_p: float = 1.0,
        quantize: bool = False,
        int8_scales: Optional[dict] = None,
        mesh: Optional[Sequence[Union[str, torch.device]]] = None,
        device: Union[str, torch.device] = "cuda:0",
    ):
        if int8_scales is not None and not quantize:
            raise ValueError("int8_scales is for quantize=True")
        if mesh is not None:
            if isinstance(mesh, (str, torch.device)) or not isinstance(mesh, Sequence):
                raise TypeError(f"mesh must be a sequence of devices, got {type(mesh).__name__}")
            if not mesh:
                raise ValueError("mesh must hold at least one device")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if not 0.0 < crop_p <= 1.0:
            raise ValueError(f"crop_p must be in (0, 1], got {crop_p}")
        cfg = dataset_config
        devices = [torch.device(d) for d in (mesh if mesh is not None else [device])]
        self.dtype = dtype
        self.lr_res = cfg.lr.res
        self.hr_res = cfg.hr.res if cfg.hr else cfg.lr.res
        self.normalizer = Normalizer(
            lr_max=cfg.lr.clamp_max,
            hr_max=cfg.hr.clamp_max if cfg.hr else cfg.lr.clamp_max,
            mode=cfg.scaling,
        )
        self.quantize = bool(quantize)
        self.int8_scales = dict(int8_scales) if int8_scales is not None else None
        self._replicas: List[_Replica] = []
        for dev in devices:
            model = build_model(
                model_config, (self.lr_res, self.lr_res), (self.hr_res, self.hr_res)
            )
            model.load_state_dict(params)
            if self.quantize and not self._replicas:
                from ..models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR
                from ..ops.int8_forward import check_scales

                if not isinstance(model, (GeneratorRRDB_SR, GeneratorRRDB_DN)):
                    raise ValueError(
                        "quantize=True is supported for the RRDB models only "
                        f"(got {type(model).__name__})"
                    )
                if self.int8_scales is not None:
                    check_scales(model, self.int8_scales)
            mask = None
            if det_mask is not None:
                mask = torch.as_tensor(np.asarray(det_mask, np.float32), device=dev)
            self._replicas.append(_Replica(dev, model.to(device=dev, dtype=dtype).eval(), mask))
        if self.quantize:
            self._f32_params = params
        self._crop_args = None
        if crop_p < 1.0:
            self._crop_args = (crop_p, *crop_fractions(cfg.crop_mode, crop_p))
        self._serve_batch_cap: Optional[int] = None
        self._cuda = any(d.type == "cuda" for d in devices)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The data axis: one device per replica (one entry without a mesh)."""
        return tuple(r.device for r in self._replicas)

    @property
    def device(self) -> torch.device:
        return self._replicas[0].device

    @property
    def model(self) -> torch.nn.Module:
        return self._replicas[0].model

    def _prepare(self, rep: _Replica, raw: torch.Tensor) -> torch.Tensor:
        x = raw
        if rep.mask is not None:
            x = x * rep.mask
        x = pad_to_res(x, self.lr_res)
        if self._crop_args is not None:
            x = crop(x, *self._crop_args)
        return self.normalizer.normalize_lr(x[..., None])

    def prepare(self, raw: torch.Tensor) -> torch.Tensor:
        """(B, H, W) f32 rate images on `device` -> normalized NHWC input."""
        return self._prepare(self._replicas[0], raw)

    def _ensure_int8(self, x: torch.Tensor) -> None:
        """Quantized path: calibrate the scales from this prepared batch on
        `mesh[0]` (unless given) and build every replica's int8 forward
        from them, once."""
        if self._replicas[0].forward_i8 is not None:
            return
        from ..ops.int8_forward import calibrate_int8_scales, make_int8_s2d_forward

        if self.int8_scales is None:
            self.int8_scales = calibrate_int8_scales(
                self.model, self._f32_params, x, device=self.device
            )
        for rep in self._replicas:
            rep.forward_i8 = make_int8_s2d_forward(
                rep.model, self._f32_params, dtype=self.dtype,
                scales=self.int8_scales, device=rep.device,
            )

    def _predict(self, rep: _Replica, x: torch.Tensor) -> torch.Tensor:
        if self.quantize:
            self._ensure_int8(x)
            pred = rep.forward_i8(x).float()
        elif self.dtype == torch.float32:
            with true_f32():
                pred = rep.model(x)
        else:
            pred = rep.model(x.to(self.dtype)).float()
        return torch.clamp(pred, 0.0, 1.0)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC input -> model output clipped to [0, 1], f32."""
        return self._predict(self._replicas[0], x)

    def _launch(self, rep: _Replica, host: torch.Tensor, with_input: bool):
        """One shard's device work, queued: the upload, the pipeline and the
        copies of its outputs into pinned buffers, then an event. Returns
        (host outputs, event); on the CPU the outputs are final and the
        event is None."""
        on_card = rep.device.type == "cuda"
        with annotate("engine.upload"):
            t = host.to(rep.device, non_blocking=True) if on_card else host
        with annotate("engine.forward"):
            x = self._prepare(rep, t)
            outs = [self.normalizer.denormalize_hr(self._predict(rep, x))[..., 0]]
            if with_input:
                outs.append(self.normalizer.denormalize_lr(x)[..., 0])
        if not on_card:
            return outs, None
        with annotate("engine.readback_enqueue"):
            pinned = []
            for o in outs:
                buf = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                buf.copy_(o, non_blocking=True)
                pinned.append(buf)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(rep.device))
        return pinned, event

    @torch.inference_mode()
    def _run(self, raw: np.ndarray, with_input: bool) -> _Readback:
        """Launch one batch, (B, H, W) host rates, on the replicas; returns
        its readback, whose `result()` is (pred[, denormalized input])."""
        with annotate("engine.launch"):
            raw = np.ascontiguousarray(raw, np.float32)
            b = raw.shape[0]
            reps = self._replicas
            if len(reps) == 1 or b == 1:
                reps = reps[:1]
            else:
                if self.quantize and reps[0].forward_i8 is None:
                    # calibrate once, on the whole batch before it is sharded
                    first = torch.from_numpy(raw).to(reps[0].device)
                    self._ensure_int8(self._prepare(reps[0], first))
                pad = (-b) % len(reps)
                if pad:
                    raw = np.concatenate([raw, np.repeat(raw[-1:], pad, axis=0)], axis=0)
            with annotate("engine.upload"):
                host = torch.from_numpy(raw)
                if self._cuda:
                    host = host.pin_memory()
            step = host.shape[0] // len(reps)
            parts = [self._launch(rep, host[i * step : (i + 1) * step], with_input)
                     for i, rep in enumerate(reps)]
            return _Readback(parts, b)

    def __call__(self, raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """raw (H, W) or (B, H, W) -> (prediction, denormalized padded input)."""
        single = raw.ndim == 2
        pred, inp = self._run(raw[None] if single else raw, with_input=True).result()
        return (pred[0], inp[0]) if single else (pred, inp)

    def _tiles_pipeline(self, raw, batch_size: int, with_input: bool):
        """Chunked serving with graceful OOM degradation: on a device
        out-of-memory error on any replica the batch is halved and the whole
        request rerun until a size fits (floor 1). The working cap is
        remembered so later calls start there."""
        bs = min(batch_size, self._serve_batch_cap or batch_size)
        with annotate("engine.call"):
            while True:
                try:
                    out = self._tiles_pipeline_once(raw, bs, with_input)
                    if bs < batch_size:
                        self._serve_batch_cap = bs
                    return out
                except torch.cuda.OutOfMemoryError as e:
                    if bs <= 1:
                        raise RuntimeError(
                            "device out of memory serving even batch_size=1 with "
                            f"{self._INFLIGHT + 1} chunks in flight"
                        ) from e
                    failed, bs = bs, max(1, bs // 2)
                    for dev in dict.fromkeys(self.devices):
                        if dev.type == "cuda":
                            with torch.cuda.device(dev):
                                torch.cuda.empty_cache()
                    log.warning(
                        "serve: device out of memory at batch %d; retrying at %d",
                        failed, bs,
                    )

    def _tiles_pipeline_once(self, raw, batch_size: int, with_input: bool):
        """Split (N, ...) into `batch_size` chunks and launch each; once
        more than `_INFLIGHT` chunks are queued, read back the oldest into
        its rows of the call's output arrays. The arrays are allocated once
        the card has the first chunk, fresh for each call; they are
        returned."""
        outs = None
        pending: deque = deque()  # (first row, readback)

        def drain(limit: int) -> None:
            while len(pending) > limit:
                row, chunk = pending.popleft()
                chunk.result(outs, row)

        for i in range(0, raw.shape[0], batch_size):
            pending.append((i, self._run(raw[i : i + batch_size], with_input)))
            if outs is None:
                outs = pending[0][1].empty(raw.shape[0])
            drain(self._INFLIGHT)
        drain(0)
        return outs

    def predict_tiles(self, raw: np.ndarray, batch_size: int = 32) -> np.ndarray:
        """Chunked batched serving: (N, H, W) -> (N, H', W') predictions."""
        return self._tiles_pipeline(raw, batch_size, with_input=False)[0]

    def run_tiles(
        self, raw: np.ndarray, batch_size: int = 32
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Chunked batched serving returning both halves of `__call__`'s
        output: (N, H, W) -> (predictions, denormalized padded inputs)."""
        return self._tiles_pipeline(raw, batch_size, with_input=True)


def load_rate_image(fits_file: Union[Path, bytes]) -> Tuple[np.ndarray, dict, float]:
    """detxy FITS (a path, or the file's bytes) -> (rate image counts/s,
    header, exposure seconds), with a warning when the exposure is outside
    the training regime."""
    img, hdr = read_image(fits_file)
    exposure = float(hdr.get("EXPOSURE", hdr.get("ONTIME", 0.0)))
    ontime_ks = exposure / 1000.0
    lo, hi = EXPOSURE_WINDOW_KS
    if ontime_ks <= lo or ontime_ks >= hi:
        log.warning(
            "The networks were trained on 20 ks exposure images; "
            "the exposure time of the input image is %.2f ks.",
            ontime_ks,
        )
    else:
        log.info("Input exposure: %.2f ks", ontime_ks)
    rate = img.astype(np.float32)
    if exposure > 0:
        rate = rate / exposure
    return rate, hdr, exposure


def infer_file(
    fits_file: Path,
    engine: InferenceEngine,
    out_path: Path,
    hr_exp_ks: float,
    model_name: str,
    plot: bool = False,
) -> Tuple[Path, Path]:
    """detxy FITS -> {input, prediction} WCS FITS products (+ `plot_in.png`
    and `plot_out.png` with `plot`)."""
    fits_file = Path(fits_file)
    if not fits_file.exists():
        raise FileNotFoundError(f"File {fits_file} not found!")
    out_path = Path(out_path)
    out_path.mkdir(parents=True, exist_ok=True)
    rate, hdr, exposure = load_rate_image(fits_file)
    pred, inp = engine(rate)
    return write_products(
        inp, pred, out_path, fits_file, exposure, hr_exp_ks, model_name, hdr, plot=plot
    )


def serve_files(
    files,
    engine: InferenceEngine,
    out_path: Path,
    hr_exp_ks: float,
    model_name: str,
    batch_size: int = 32,
    plot: bool = False,
):
    """Batched serving: many detxy FITS -> product pairs.

    Inputs are grouped by native geometry (header-only reads), run through
    `engine.run_tiles` a sub-batch at a time, and their products written by
    a small writer pool while the next sub-batch runs; the pool is closed by
    its `with` block before this returns. Colliding basenames get distinct
    product stems, and `plot` adds `<stem>_plot_in.png` and
    `<stem>_plot_out.png`, drawn by one writer thread (matplotlib is not
    thread-safe). Returns [(input_product, prediction_product), ...]
    aligned with `files`."""
    files = [Path(f) for f in files]
    out_path = Path(out_path)
    out_path.mkdir(parents=True, exist_ok=True)

    bases = [f.stem.replace(".fits", "") for f in files]
    seen: dict = {}
    stems: list = []
    for b in bases:
        k = seen.get(b, 0)
        seen[b] = k + 1
        stems.append(b if k == 0 else f"{b}__{k + 1}")

    groups: dict = {}
    for idx, f in enumerate(files):
        hdr = read_header(f)
        shape = tuple(int(hdr[f"NAXIS{i}"]) for i in range(int(hdr["NAXIS"]), 0, -1))
        groups.setdefault(shape, []).append(idx)

    results: list = [None] * len(files)
    sub_cap = batch_size * 4  # a few chunks per resident stack
    with ThreadPoolExecutor(max_workers=1 if plot else 4) as pool:
        pending: list = []
        for idxs in groups.values():
            for s in range(0, len(idxs), sub_cap):
                sub = idxs[s : s + sub_cap]
                metas = [load_rate_image(files[i]) for i in sub]
                stack = np.stack([m[0] for m in metas])
                preds, inps = engine.run_tiles(stack, batch_size=batch_size)
                for i, fut in pending:  # previous sub-batch's writes
                    results[i] = fut.result()
                pending = [
                    (
                        i,
                        pool.submit(
                            write_products,
                            inps[j], preds[j], out_path, files[i],
                            metas[j][2], hr_exp_ks, model_name, metas[j][1],
                            plot=plot, out_stem=stems[i],
                        ),
                    )
                    for j, i in enumerate(sub)
                ]
        for i, fut in pending:
            results[i] = fut.result()
    return results


def watch_and_serve(
    watch_dirs,
    engine: InferenceEngine,
    out_path: Path,
    hr_exp_ks: float,
    model_name: str,
    batch_size: int = 32,
    poll_s: float = 2.0,
    pattern: str = "*.fits*",
    state_path: Optional[Path] = None,
    stop: Optional[threading.Event] = None,
    max_polls: Optional[int] = None,
    plot: bool = False,
) -> int:
    """Directory-watching serving daemon over one warm engine.

    * A file is picked up only once its (size, mtime) is unchanged between
      two consecutive polls: a writer mid-copy is left for the next poll.
    * Work identity is (path, size, mtime): an overwritten input is served
      again; a re-poll of an already-served file is not.
    * `state_path` keeps the served set as JSON (replaced atomically after
      each batch), so a restarted daemon does not serve history again;
      entries of deleted or overwritten inputs are pruned.
    * A failed batch is served again file by file at batch size 1, so one
      corrupt input cannot wedge the queue and a batch too large for the
      device degrades to single tiles; a file that still fails is recorded
      as failed and skipped thereafter.
    * `stop` ends the loop at the next poll boundary; `max_polls` bounds it.

    Returns the number of files served."""
    watch_dirs = [Path(d) for d in (
        watch_dirs if isinstance(watch_dirs, (list, tuple)) else [watch_dirs]
    )]
    stop = stop or threading.Event()

    served: dict = {}
    if state_path is not None and Path(state_path).exists():
        try:
            served = json.loads(Path(state_path).read_text())
        except (OSError, ValueError) as e:
            log.warning("watch: unreadable state %s (%s); starting fresh", state_path, e)

    def _persist() -> None:
        if state_path is None:
            return
        tmp = Path(str(state_path) + ".tmp")
        tmp.write_text(json.dumps(served))
        tmp.replace(state_path)

    n_served = 0
    pending: dict = {}  # path -> (size, mtime_ns) seen at the last poll
    polls = 0
    while not stop.is_set() and (max_polls is None or polls < max_polls):
        polls += 1
        snapshot: dict = {}
        live_keys: set = set()
        for d in watch_dirs:
            for f in sorted(d.glob(pattern)):
                try:
                    st = f.stat()
                except OSError:
                    continue  # vanished between glob and stat
                k = f"{f}|{st.st_size}|{st.st_mtime_ns}"
                live_keys.add(k)
                if k not in served:
                    snapshot[f] = (st.st_size, st.st_mtime_ns, k)

        stale = [k for k in served if k not in live_keys]
        if stale:
            for k in stale:
                del served[k]
            _persist()

        ready = [f for f, (size, mt, _) in snapshot.items() if pending.get(f) == (size, mt)]
        if ready:
            try:
                serve_files(ready, engine, out_path, hr_exp_ks, model_name,
                            batch_size=batch_size, plot=plot)
                for f in ready:
                    served[snapshot[f][2]] = "ok"
                n_served += len(ready)
            except Exception as batch_err:  # isolate the bad input
                log.warning("watch: batch failed (%s); serving per-file", batch_err)
                for f in ready:
                    try:
                        serve_files([f], engine, out_path, hr_exp_ks, model_name,
                                    batch_size=1, plot=plot)
                        served[snapshot[f][2]] = "ok"
                        n_served += 1
                    except Exception as e:
                        log.error("watch: %s failed permanently: %s", f, e)
                        served[snapshot[f][2]] = f"error: {e}"
            _persist()

        pending = {f: (size, mt) for f, (size, mt, _) in snapshot.items()}
        if stop.is_set() or (max_polls is not None and polls >= max_polls):
            break
        stop.wait(poll_s)
    return n_served


def write_products(
    inp: np.ndarray,
    pred: np.ndarray,
    out_path: Path,
    fits_file: Path,
    exposure: float,
    hr_exp_ks: float,
    model_name: str,
    hdr: dict,
    plot: bool = False,
    out_stem: Optional[str] = None,
) -> Tuple[Path, Path]:
    """Write the {input, prediction} WCS FITS product pair for one source
    file, and with `plot` its PNGs: `plot_in.png` and `plot_out.png`, or
    with `out_stem` (which overrides the product stem) `<out_stem>_plot_in.png`
    and `<out_stem>_plot_out.png`."""
    stem = out_stem or fits_file.stem.replace(".fits", "")
    res_mult = pred.shape[0] // inp.shape[0]
    p_in = write_xmm_product_wcs(
        inp, out_path, fits_file.name, 1, exposure,
        comment="Input image padded and WCS aligned. Needs to be multiplied by exposure.",
        out_file_name=f"{stem}_input_wcs", in_header=hdr,
    )
    p_pred = write_xmm_product_wcs(
        pred, out_path, fits_file.name, res_mult, hr_exp_ks * 1000.0,
        comment=(
            f"XMM {model_name} model prediction. Needs to be multiplied by "
            "exposure. It's possible that the given exposure is not correctly "
            "calculated so take care."
        ),
        out_file_name=f"{stem}_predict_wcs", in_header=hdr,
    )
    if plot:
        _save_plots(p_in, p_pred, out_path, prefix=f"{out_stem}_" if out_stem else "")
    return p_in, p_pred


def _save_plots(p_in: Path, p_pred: Path, out: Path, prefix: str = "") -> None:
    """99.5-percentile plasma plots of the two products."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for path, name in ((p_in, f"{prefix}plot_in.png"), (p_pred, f"{prefix}plot_out.png")):
        img, _ = read_image(path)
        finite = img[np.isfinite(img)]
        lo, hi = np.percentile(finite, [0.25, 99.75])
        plt.figure()
        plt.imshow(np.clip(img, lo, hi), cmap="plasma", origin="lower",
                   interpolation="nearest")
        plt.savefig(out / name)
        plt.close()
