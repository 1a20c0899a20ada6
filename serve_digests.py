#!/usr/bin/env python3
"""Digests of the port's serving products on one CUDA card, to hold two
checkouts' serving bitwise equal.

    python3 serve_digests.py

Writes `chip_smoke.py`'s 4 seeded synthetic detxy FITS files to a temporary
directory, serves them with the trained esr_gen checkpoint through
`InferenceEngine` and `serve_files` in f32, bf16 and int8 (bf16); prints
one JSON object {mode: sha256 of the products' pixel bytes}.
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
    from xmm_superres_denoise_torch.infer.run_file import InferenceEngine, serve_files
    from xmm_superres_denoise_torch.io.fits import read_image
    from xmm_superres_denoise_torch.utils.weights import params_from_flax

    ds_cfg, model_cfg = load_run_config(ROOT / "res/configs/runs/esr_gen_sr.toml")
    params = params_from_flax(ROOT / "docs/convergence_esr_gen/best_params.npz")
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
    print(json.dumps(out, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
