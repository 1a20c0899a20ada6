"""Import hygiene of the PyTorch port and the CPU behaviour of chip_smoke.py.

The port must run on a machine with PyTorch and numpy but without jax, flax,
pydantic or matplotlib, and must import nothing of the JAX package.
matplotlib is optional: the PNG plots and the image logger's panels import
it inside the function that draws, never at a module's top level.
"""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "xmm_superres_denoise_torch"
FORBIDDEN = ("jax", "flax", "pydantic", "matplotlib", "xmm_superres_denoise_tpu")


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_importing_every_port_module_pulls_in_no_jax_pydantic_or_matplotlib():
    modules = _port_modules()
    assert "xmm_superres_denoise_torch.infer.run_file" in modules
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


_IMPORT = re.compile(
    r"^\s*(import|from)\s+(jax|flax|pydantic|xmm_superres_denoise_tpu)\b"
    r"|^(import|from)\s+matplotlib\b", re.M
)


@pytest.mark.parametrize(
    "path",
    sorted(
        str(p.relative_to(ROOT))
        for p in [*PORT.rglob("*.py"), *PORT.rglob("*.cu"), *PORT.rglob("*.cuh")]
    ),
)
def test_port_sources_name_no_jax_package(path):
    text = (ROOT / path).read_text()
    assert "xmm_superres_denoise_tpu" not in text
    assert not _IMPORT.search(text)


def test_utils_and_run_file_load_neither_matplotlib_nor_the_profiler():
    """`utils` alone loads none of its helpers. The engine loads the span
    helper (`utils/profiling.py`: torch and the standard library, no FLOP
    counter), and neither matplotlib, the image logger nor torch's FLOP
    counter."""
    code = (
        "import sys\n"
        "import xmm_superres_denoise_torch.utils\n"
        "early = [m for m in ('xmm_superres_denoise_torch.utils.profiling',\n"
        "    'xmm_superres_denoise_torch.utils.imagelogger') if m in sys.modules]\n"
        "import xmm_superres_denoise_torch.infer.run_file\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'matplotlib' or m in (\n"
        "    'xmm_superres_denoise_torch.utils.imagelogger', 'torch.utils.flop_counter'))\n"
        "print(early, bad)\n"
        "sys.exit(1 if early or bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    # it names the replaced TPU kernel's file in its report, and imports nothing of it
    assert not _IMPORT.search((ROOT / "chip_smoke.py").read_text())


def test_chip_smoke_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

