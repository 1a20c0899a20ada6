"""Single-file and batched inference: detxy FITS -> model -> SR/DN FITS.

The port of the JAX package's `infer/run_file.py`. The engine's
pipeline is the JAX one, step for step: mask -> pad -> (crop) -> normalize
-> model -> clip -> denormalize. PyTorch runs it eagerly on `device`
(`cuda:0` unless the caller asks for the CPU); the model's dense blocks
run on the hand-written kernel when the device is a card.

Left out of this slice, and refused loudly rather than ignored: int8
serving (`quantize`, `int8_scales`), the device mesh (`mesh`), the watch
daemon and the HTTP server. Products are FITS only: no PNG plots.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..config.schema import DatasetCfg, ModelCfg
from ..io.fits import read_header, read_image
from ..io.wcs import write_xmm_product_wcs
from ..models.registry import build_model
from ..ops.precision import true_f32
from ..ops.preprocess import crop, crop_fractions, pad_to_res
from ..ops.stretch import Normalizer

log = logging.getLogger("xmmsr")

EXPOSURE_WINDOW_KS = (15.0, 25.0)  # training regime sanity band


class InferenceEngine:
    """A detxy-image -> prediction pipeline with the weights resident on
    `device`.

    `params` is a state_dict for the configured model (`params_from_flax`
    converts the JAX package's Flax tree). `dtype=torch.bfloat16` runs the
    model in bf16 (params cast once; normalization and denormalization stay
    f32 for product fidelity), the serving configuration. f32 (default) is
    the parity configuration and runs with TF32 off (`ops/precision.py`).
    `crop_p` < 1 crops the padded input to that fraction before
    normalization, origin per `dataset_config.crop_mode`.
    """

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
        mesh=None,
        device: Union[str, torch.device] = "cuda:0",
    ):
        if quantize or int8_scales is not None:
            raise NotImplementedError(
                "int8 serving is not ported yet (ROADMAP.md Queue 1 item 8, "
                "Queue 2 K3)"
            )
        if mesh is not None:
            raise NotImplementedError(
                "multi-device serving is not ported yet (ROADMAP.md Queue 1, "
                "training harness and parallel/*)"
            )
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if not 0.0 < crop_p <= 1.0:
            raise ValueError(f"crop_p must be in (0, 1], got {crop_p}")
        cfg = dataset_config
        self.device = torch.device(device)
        self.dtype = dtype
        self.lr_res = cfg.lr.res
        self.hr_res = cfg.hr.res if cfg.hr else cfg.lr.res
        self.normalizer = Normalizer(
            lr_max=cfg.lr.clamp_max,
            hr_max=cfg.hr.clamp_max if cfg.hr else cfg.lr.clamp_max,
            mode=cfg.scaling,
        )
        model = build_model(
            model_config, (self.lr_res, self.lr_res), (self.hr_res, self.hr_res)
        )
        model.load_state_dict(params)
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.mask = None
        if det_mask is not None:
            self.mask = torch.as_tensor(
                np.asarray(det_mask, np.float32), device=self.device
            )
        self._crop_args = None
        if crop_p < 1.0:
            self._crop_args = (crop_p, *crop_fractions(cfg.crop_mode, crop_p))
        self._serve_batch_cap: Optional[int] = None

    def prepare(self, raw: torch.Tensor) -> torch.Tensor:
        """(B, H, W) f32 rate images on `device` -> normalized NHWC input."""
        x = raw
        if self.mask is not None:
            x = x * self.mask
        x = pad_to_res(x, self.lr_res)
        if self._crop_args is not None:
            x = crop(x, *self._crop_args)
        return self.normalizer.normalize_lr(x[..., None])

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized NHWC input -> model output clipped to [0, 1], f32."""
        if self.dtype == torch.float32:
            with true_f32():
                pred = self.model(x)
        else:
            pred = self.model(x.to(self.dtype)).float()
        return torch.clamp(pred, 0.0, 1.0)

    @torch.inference_mode()
    def _run(self, raw: np.ndarray, with_input: bool):
        """One batch: (B, H, W) host rates -> host (pred[, denormalized input])."""
        t = torch.from_numpy(np.ascontiguousarray(raw, np.float32)).to(self.device)
        x = self.prepare(t)
        pred = self.normalizer.denormalize_hr(self.predict(x))[..., 0]
        if not with_input:
            return (pred.cpu().numpy(),)
        inp = self.normalizer.denormalize_lr(x)[..., 0]
        return pred.cpu().numpy(), inp.cpu().numpy()

    def __call__(self, raw: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """raw (H, W) or (B, H, W) -> (prediction, denormalized padded input)."""
        single = raw.ndim == 2
        pred, inp = self._run(raw[None] if single else raw, with_input=True)
        return (pred[0], inp[0]) if single else (pred, inp)

    def _tiles_pipeline(self, raw, batch_size: int, with_input: bool):
        """Chunked serving with graceful OOM degradation: on a device
        out-of-memory error the batch is halved and the whole request rerun
        until a size fits (floor 1). The working cap is remembered so later
        calls start there."""
        bs = min(batch_size, self._serve_batch_cap or batch_size)
        while True:
            try:
                out = self._tiles_pipeline_once(raw, bs, with_input)
                if bs < batch_size:
                    self._serve_batch_cap = bs
                return out
            except torch.cuda.OutOfMemoryError as e:
                if bs <= 1:
                    raise RuntimeError(
                        "device out of memory serving even batch_size=1"
                    ) from e
                failed, bs = bs, max(1, bs // 2)
                if self.device.type == "cuda":
                    torch.cuda.empty_cache()
                log.warning(
                    "serve: device out of memory at batch %d; retrying at %d",
                    failed, bs,
                )

    def _tiles_pipeline_once(self, raw, batch_size: int, with_input: bool):
        """Split (N, ...) into `batch_size` chunks, run each, concatenate."""
        outs: List[list] = [[], []] if with_input else [[]]
        for i in range(0, raw.shape[0], batch_size):
            for lst, arr in zip(outs, self._run(raw[i : i + batch_size], with_input)):
                lst.append(arr)
        return tuple(np.concatenate(lst, axis=0) for lst in outs)

    def predict_tiles(self, raw: np.ndarray, batch_size: int = 32) -> np.ndarray:
        """Chunked batched serving: (N, H, W) -> (N, H', W') predictions."""
        return self._tiles_pipeline(raw, batch_size, with_input=False)[0]

    def run_tiles(
        self, raw: np.ndarray, batch_size: int = 32
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Chunked batched serving returning both halves of `__call__`'s
        output: (N, H, W) -> (predictions, denormalized padded inputs)."""
        return self._tiles_pipeline(raw, batch_size, with_input=True)


def load_rate_image(fits_file: Path) -> Tuple[np.ndarray, dict, float]:
    """detxy FITS -> (rate image counts/s, header, exposure seconds), with a
    warning when the exposure is outside the training regime."""
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
) -> Tuple[Path, Path]:
    """detxy FITS -> {input, prediction} WCS FITS products."""
    fits_file = Path(fits_file)
    if not fits_file.exists():
        raise FileNotFoundError(f"File {fits_file} not found!")
    out_path = Path(out_path)
    out_path.mkdir(parents=True, exist_ok=True)
    rate, hdr, exposure = load_rate_image(fits_file)
    pred, inp = engine(rate)
    return write_products(
        inp, pred, out_path, fits_file, exposure, hr_exp_ks, model_name, hdr
    )


def serve_files(
    files,
    engine: InferenceEngine,
    out_path: Path,
    hr_exp_ks: float,
    model_name: str,
    batch_size: int = 32,
):
    """Batched serving: many detxy FITS -> product pairs.

    Inputs are grouped by native geometry (header-only reads), run through
    `engine.run_tiles` a sub-batch at a time, and their products written by
    a small writer pool while the next sub-batch runs; the pool is closed by
    its `with` block before this returns. Colliding basenames get distinct
    product stems. Returns [(input_product, prediction_product), ...]
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
    with ThreadPoolExecutor(max_workers=4) as pool:
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
                            out_stem=stems[i],
                        ),
                    )
                    for j, i in enumerate(sub)
                ]
        for i, fut in pending:
            results[i] = fut.result()
    return results


def write_products(
    inp: np.ndarray,
    pred: np.ndarray,
    out_path: Path,
    fits_file: Path,
    exposure: float,
    hr_exp_ks: float,
    model_name: str,
    hdr: dict,
    out_stem: Optional[str] = None,
) -> Tuple[Path, Path]:
    """Write the {input, prediction} WCS FITS product pair for one source
    file. `out_stem` overrides the product stem."""
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
    return p_in, p_pred
