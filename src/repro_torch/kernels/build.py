"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` holds plain ``extern "C"`` launchers. ``load``
compiles it with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (ignored by git), keyed by a
hash of the source, the shared headers ``csrc/*.cuh`` it may include
and the flags, and opens it with ``ctypes``. Nothing is compiled when
this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from repro_torch.obs import compile_log

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}
# name -> {"seconds": wall seconds of the nvcc run (0.0 when cached),
#          "log": nvcc's stderr, which holds the -Xptxas -v report; kept
#          beside the library, so a cached build reports it too}
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


def source_key(name: str, csrc: Path = CSRC) -> str:
    """Build key of ``csrc/<name>.cu``: a hash of the source, of every
    header ``csrc/*.cuh`` (by name and content), and of the flags, so a
    changed header never loads a stale library."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its build or its nvcc log is
    missing, then load it."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{source_key(name)}.so"
    log = out.with_suffix(".log")
    if out.exists() and log.exists():
        build_info[name] = {"seconds": 0.0, "log": log.read_text()}
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
        tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
        tmp_log.write_text(proc.stderr)
        os.replace(tmp, out)
        os.replace(tmp_log, log)
        build_info[name] = {
            "seconds": time.perf_counter() - t0,
            "log": proc.stderr,
        }
        compile_log.record("kernels.build", config=out.name,
                           source=name, seconds=build_info[name]["seconds"])
    lib = ctypes.CDLL(str(out))
    _loaded[name] = lib
    return lib
