"""Builds and loads the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface and loaded with ctypes. Libraries go to
`build/rrnet_torch/` at the root of the checkout (git-ignored), named by
a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is built once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rrnet_torch"

# -fmad=false and no fast math: kernels that mirror a plain PyTorch
# version round op by op as it does (see csrc/soft_nms.cu).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
SOURCES = {"soft_nms": "soft_nms.cu"}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _build(name: str, target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.parent / f"{target.stem}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    (BUILD_DIR / f"{name}.log").write_text(res.stdout)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{res.stdout}")
    os.replace(tmp, target)


def build_log(name: str) -> List[str]:
    """The compiler's output of the last build of `name` (ptxas register
    and shared-memory counts), or [] if it was not built here."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text().splitlines() if log.exists() else []


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if it is not current."""
    lib = _loaded.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            _build(name, target)
        lib = ctypes.CDLL(str(target))
        _loaded[name] = lib
    return lib
