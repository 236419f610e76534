"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` holds plain ``extern "C"`` launchers. ``load``
compiles it with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (ignored by git), keyed by a
hash of the source and the flags, and opens it with ``ctypes``. Nothing
is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}
# name -> {"seconds": wall seconds of the nvcc run (0.0 when cached),
#          "log": nvcc's stderr, which holds the -Xptxas -v report}
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built with nvcc at first "
            "use (set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build is missing, then load it."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{key}.so"
    if out.exists():
        build_info[name] = {"seconds": 0.0, "log": ""}
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
        build_info[name] = {
            "seconds": time.perf_counter() - t0,
            "log": proc.stderr,
        }
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib
