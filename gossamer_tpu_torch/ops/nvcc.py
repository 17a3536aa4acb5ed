"""Build the hand-written CUDA kernels of ``csrc/`` at first use.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for Hopper
(``sm_90a``) into ``gossamer_tpu_torch/_build/libgoss<name>.so``, a shared
library with a plain C interface that the op modules bind with ctypes.  A
library is rebuilt when it is missing or older than its source or any
header in ``csrc/``.  Separate libraries let several ``nvcc`` run at once.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_library(name: str, defines: dict[str, int] | None = None,
                  src: Path | None = None) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` when its library is stale.  Returns
    (path, build seconds, compiler output); seconds is 0.0 when the library
    was already current.  ``defines`` (``-D`` macros, e.g. another tile) and
    ``src`` (another source file) build a variant beside the default
    library, under a name of its own; tuning scripts use them."""
    defines = defines or {}
    tag = "".join(f"_{k}{v}" for k, v in sorted(defines.items()))
    if src is not None:
        tag += f"_{src.stem}"
    src = src or CSRC / f"{name}.cu"
    so = BUILD_DIR / f"libgoss{name}{tag}.so"
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    if so.exists() and so.stat().st_mtime >= newest:
        return so, 0.0, ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{so.name}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    macros = [f"-D{k}={v}" for k, v in sorted(defines.items())]
    proc = subprocess.run([nvcc, *NVCC_FLAGS, *macros, f"-I{CSRC}", "-o",
                           str(tmp), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return so, time.perf_counter() - t0, proc.stderr
