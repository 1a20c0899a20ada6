"""The SASS of a built kernel library, counted per kernel, for the card
tests that check which instructions a kernel multiplies with."""

import re
import shutil
import subprocess

from xmm_superres_denoise_torch.ops import cuda_build


def sass_counts(lib_name, ops):
    """{kernel: {op: SASS lines}} of a built library, from cuobjdump."""
    path, _, _ = cuda_build.build(lib_name)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                counts[fn][op] += bool(re.search(rf"\b{op}\b", line))
    return counts
