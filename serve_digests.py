#!/usr/bin/env python3
"""Digests of the port's serving products on one CUDA card, to hold two
checkouts' serving bitwise equal.

    python3 serve_digests.py

Writes `chip_smoke.py`'s 4 seeded synthetic detxy FITS files to a temporary
directory, serves them with the trained esr_gen checkpoint through
`InferenceEngine` and `serve_files` in f32, bf16 and int8 (bf16), and runs
the S2D and fast SR forwards in f32 and bf16 on the engine's prepared
tiles; prints one JSON object {mode: sha256 of the products' pixel bytes}.
Run it from the root of each checkout on the same card (copy this file
into a checkout that lacks it) and compare the two objects. It needs a
card and exits non-zero without one.
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BATCH = 2


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def main() -> int:
    if not torch.cuda.is_available():
        print("serve_digests: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _write_inputs
    from xmm_superres_denoise_torch.config import load_run_config
    from xmm_superres_denoise_torch.infer.run_file import (
        InferenceEngine,
        load_rate_image,
        serve_files,
    )
    from xmm_superres_denoise_torch.io.fits import read_image
    from xmm_superres_denoise_torch.models.rrdb import GeneratorRRDB_SR
    from xmm_superres_denoise_torch.ops.dense_block import make_fast_rrdb_forward
    from xmm_superres_denoise_torch.ops.s2d_forward import make_s2d_sr_forward
    from xmm_superres_denoise_torch.utils.weights import params_from_flax

    ckpt = ROOT / "docs/convergence_esr_gen/best_params.npz"
    ds_cfg, model_cfg = load_run_config(ROOT / "res/configs/runs/esr_gen_sr.toml")
    params = params_from_flax(ckpt)
    out = {}
    with tempfile.TemporaryDirectory(prefix="xmmsr_digests_") as tmp:
        tmp = Path(tmp)
        files = _write_inputs(tmp)
        for name, dtype, quantize in (("engine f32", torch.float32, False),
                                      ("engine bf16", torch.bfloat16, False),
                                      ("engine int8", torch.bfloat16, True)):
            engine = InferenceEngine(model_cfg, ds_cfg, params, dtype=dtype, quantize=quantize)
            products = serve_files(files, engine, tmp / name.replace(" ", "_"), hr_exp_ks=100.0,
                                   model_name="esr_gen", batch_size=BATCH)
            out[name] = _digest(read_image(p)[0] for pair in products for p in pair)
            if name == "engine f32":
                raw = np.stack([load_rate_image(f)[0] for f in files])
                with torch.inference_mode():
                    x = engine.prepare(torch.from_numpy(raw).to("cuda:0"))
        model = GeneratorRRDB_SR()
        with torch.inference_mode():
            for label, make in (("s2d", make_s2d_sr_forward), ("fast", make_fast_rrdb_forward)):
                for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
                    fwd = make(model, ckpt, dtype, device="cuda:0")
                    pred = torch.cat([fwd(x[i:i + BATCH]) for i in range(0, len(x), BATCH)])
                    out[f"{label} {dname}"] = _digest([pred.float().cpu().numpy()])
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
