"""One-command real-weights parity gate for an ONNX checkpoint.

The port of the JAX package's `infer/verify.py`. The reference's production
artifacts are two ONNX checkpoints consumed at
`utils/run_inference_on_file.py:42-48,155-156`; this is the gate the project
runs the moment such a checkpoint is available:

    python -m xmm_superres_denoise_torch.cli verify --onnx XMM-SuperRes.onnx \
        --run_config res/configs/runs/esr_gen_prod.toml --data DIR

For every image it checks:

  1. weight import: ONNX initializers -> the port's model (onnx_import);
  2. output fidelity: the port's forward (f32, TF32 off) vs the ONNX graph
     executed by an independent runtime (onnxruntime when installed, else
     the port's lite runtime on the same device) — pixel-wise max|diff| <=
     tol (default 1e-3);
  3. quality parity: PSNR/SSIM between the two outputs, per file;
  4. int8 serving fidelity: the calibrated w8a8 forward vs the f32 forward
     (`ops/int8_forward.quantization_psnr`, gate >= 40 dB), RRDB models
     only.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..config.schema import DatasetCfg, ModelCfg
from ..data.datasets import load_det_mask
from ..metrics.functional import psnr as psnr_fn, ssim as ssim_fn
from ..models.registry import build_model
from ..ops.precision import true_f32
from ..ops.preprocess import pad_to_res
from ..ops.stretch import Normalizer

log = logging.getLogger("xmmsr")

INT8_GATE_DB = 40.0  # real-data golden-gate threshold
# where the reference's real 20 ks example images go in a checkout
# (`data/example_data/real/20ks`); XMMSR_EXAMPLE_DATA names another directory
EXAMPLE_DATA = Path(__file__).resolve().parents[2] / "data/example_data/real/20ks"


def _onnx_forward(onnx_path: Path, device: torch.device):
    """Independent ONNX executor: onnxruntime if importable, else the port's
    lite runtime on `device`. Returns (fn(NCHW f32 numpy) -> NCHW f32 numpy,
    runtime name)."""
    try:
        import onnxruntime as ort

        sess = ort.InferenceSession(str(onnx_path), providers=["CPUExecutionProvider"])
        iname = sess.get_inputs()[0].name

        def run(x):
            return sess.run(None, {iname: x})[0]

        return run, "onnxruntime"
    except ImportError:
        from .onnx_runtime_lite import read_onnx_model, run_graph

        graph = read_onnx_model(onnx_path)

        def run(x):
            out = run_graph(graph, {graph.inputs[0]: x}, device=device)
            return out[graph.outputs[0]].cpu().numpy()

        return run, "lite"


def verify_onnx(
    onnx_path: Path,
    dataset_config: DatasetCfg,
    model_config: ModelCfg,
    data_files: List[Path],
    tol: float = 1e-3,
    int8: bool = True,
    device: Union[str, torch.device] = "cuda:0",
) -> Dict[str, object]:
    """Run the full gate on `device`; returns the report dict (["passed"]
    overall)."""
    from ..utils.weights import flax_tree, params_from_flax
    from .onnx_import import import_onnx_params
    from .run_file import load_rate_image

    if not data_files:
        # a gate with zero images would be vacuously green — refuse
        raise ValueError("verify_onnx: data_files is empty — nothing to verify against")
    device = torch.device(device)
    cfg = dataset_config
    lr_res = cfg.lr.res
    hr_res = cfg.hr.res if cfg.hr else cfg.lr.res
    model = build_model(model_config, (lr_res, lr_res), (hr_res, hr_res))
    template = flax_tree(model.state_dict(), scan_layers=getattr(model, "scan_layers", False))
    params = params_from_flax(import_onnx_params(onnx_path, template), model)
    model.load_state_dict(params)
    model = model.to(device).eval()
    onnx_run, runtime = _onnx_forward(onnx_path, device)
    log.info("verify: ONNX weights imported; reference runtime = %s", runtime)

    nz = Normalizer(
        lr_max=cfg.lr.clamp_max,
        hr_max=cfg.hr.clamp_max if cfg.hr else cfg.lr.clamp_max,
        mode=cfg.scaling,
    )
    mask = load_det_mask(cfg.lr.det_mask) if cfg.lr.det_mask else None

    rows = []
    calib_input = None
    for f in data_files:
        # the serving path's counts -> rate conversion (EXPOSURE/ONTIME
        # fallback included): the gate validates the input production serves
        rate, _, _ = load_rate_image(f)
        x = torch.from_numpy(rate).to(device)
        if mask is not None:
            x = x * torch.from_numpy(mask.astype(np.float32)).to(device)
        x = nz.normalize_lr(pad_to_res(x[None], lr_res)[..., None]).float()
        if calib_input is None:
            calib_input = x
        with torch.inference_mode(), true_f32():
            y_port = torch.clamp(model(x), 0.0, 1.0).double()
        y_onnx = torch.from_numpy(
            onnx_run(x.permute(0, 3, 1, 2).cpu().numpy().astype(np.float32))
        ).permute(0, 2, 3, 1).to(device, torch.float64)
        maxdiff = float(torch.max(torch.abs(y_port - y_onnx)))
        rows.append({
            "file": Path(f).name,
            "max_abs_diff": maxdiff,
            "pixel_gate": bool(maxdiff <= tol),
            "psnr_vs_onnx": round(float(psnr_fn(y_port.float(), y_onnx.float())), 2),
            "ssim_vs_onnx": round(float(ssim_fn(y_port.float(), y_onnx.float())), 5),
        })
        log.info("verify: %s max|diff|=%.2e psnr=%.1f", Path(f).name, maxdiff,
                 rows[-1]["psnr_vs_onnx"])

    report: Dict[str, object] = {
        "onnx": str(onnx_path),
        "runtime": runtime,
        "tol": tol,
        "files": rows,
        "pixel_gate_passed": all(r["pixel_gate"] for r in rows),
    }

    if int8:
        from ..models.rrdb import GeneratorRRDB_DN, GeneratorRRDB_SR

        if isinstance(model, (GeneratorRRDB_SR, GeneratorRRDB_DN)):
            from ..ops.int8_forward import quantization_psnr

            db = quantization_psnr(model, params, calib_input, device=device)
            report["int8_psnr_db"] = round(float(db), 2)
            report["int8_gate_passed"] = bool(db >= INT8_GATE_DB)
        else:
            report["int8_gate_passed"] = None  # transformers: no int8 path

    report["passed"] = bool(
        report["pixel_gate_passed"]
        and report.get("int8_gate_passed", True) is not False
    )
    return report


def default_example_files(limit: Optional[int] = None) -> List[Path]:
    """The real 20 ks example images, the production input distribution:
    those in the directory XMMSR_EXAMPLE_DATA names, else in
    `EXAMPLE_DATA`; an empty list when there is none."""
    root = Path(os.environ.get("XMMSR_EXAMPLE_DATA") or EXAMPLE_DATA)
    files = sorted(root.glob("*.fits*"))
    return files[:limit] if limit else files
