"""Builds and loads the port's CUDA kernels and its host library.

Each `csrc/<name>.cu` is compiled by `nvcc` into a shared library with a
plain C interface and loaded with ctypes; the host soft-NMS library
(`csrc/host_nms.cpp`) is compiled the same way by the host's C++
compiler (`CXX`, `g++`). Libraries go to
`build/rrnet_torch/` at the root of the checkout (git-ignored), named by
a hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so
an edited source is rebuilt and an unchanged one is built once.
`build_all` starts one `nvcc` per stale library, all at once; it also
builds another copy of the sources (an earlier commit's), or the same
sources with extra flags (a `-D` setting), into another directory, for a
timing of the two side by side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rrnet_torch"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# name: (source, extra flags). -fmad=false and no fast math for a kernel
# that mirrors its plain PyTorch version bit for bit, rounding op by op as
# it does (see csrc/soft_nms.cu, csrc/soft_nms_classes.cu,
# csrc/hard_nms.cu, csrc/int8_conv.cu, csrc/conv_epilogue.cu); the DCN
# kernels are compared within a tolerance and may contract multiply-adds.
SOURCES = {"soft_nms": ("soft_nms.cu", ["-fmad=false"]),
           "soft_nms_classes": ("soft_nms_classes.cu", ["-fmad=false"]),
           "hard_nms": ("hard_nms.cu", ["-fmad=false"]),
           "int8_conv": ("int8_conv.cu", ["-fmad=false"]),
           "conv_epilogue": ("conv_epilogue.cu", ["-fmad=false"]),
           "dcn_fwd": ("dcn_fwd.cu", []),
           "dcn_bwd": ("dcn_bwd.cu", [])}
# Host libraries, built by CXX with HOST_FLAGS: the JAX package's flags
# for its copy of the source (no -march=native, so no fused multiply-add
# is contracted and the two libraries agree bit for bit).
CXX = "g++"
HOST_FLAGS = ["-O3", "-shared", "-fPIC"]
HOST_SOURCES = {"host_nms": "host_nms.cpp"}

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


def _source(name: str) -> str:
    return HOST_SOURCES.get(name) or SOURCES[name][0]


def _flags(name: str, extra: Sequence[str] = ()) -> List[str]:
    if name in HOST_SOURCES:
        return HOST_FLAGS + list(extra)
    return NVCC_FLAGS + SOURCES[name][1] + list(extra)


def _compiler(name: str) -> str:
    return CXX if name in HOST_SOURCES else _nvcc()


def _target(name: str, csrc: Path, build_dir: Path,
            extra: Sequence[str] = ()) -> Path:
    digest = hashlib.sha256((csrc / _source(name)).read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_flags(name, extra)).encode())
    return build_dir / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = tuple(SOURCES),
              csrc: Optional[Path] = None, build_dir: Optional[Path] = None,
              extra_flags: Sequence[str] = ()) -> Dict[str, Path]:
    """Build every library of `names` (sources in `csrc`, libraries in
    `build_dir`, `extra_flags` after each source's own) that is not
    current, one compiler process each (`nvcc`, or CXX for a host
    library), all started together; raises if any build fails, the
    compiler missing included. Returns each library's path. csrc and
    build_dir default to CSRC and BUILD_DIR."""
    csrc = CSRC if csrc is None else csrc
    build_dir = BUILD_DIR if build_dir is None else build_dir
    build_dir.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name, csrc, build_dir, extra_flags)
               for name in names}
    jobs = []
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.parent / f"{target.stem}.{os.getpid()}.tmp.so"
        cmd = [_compiler(name), *_flags(name, extra_flags), "-o", str(tmp),
               str(csrc / _source(name))]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            for job in jobs:
                job[3].kill()
                job[3].wait()
            raise RuntimeError(f"cannot run {cmd[0]} to build "
                               f"{_source(name)}: {e}") from e
        jobs.append((name, target, tmp, proc))
    failed = []
    for name, target, tmp, proc in jobs:
        out = proc.communicate()[0]
        (build_dir / f"{name}.log").write_text(out)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{_compiler(name)} failed for {_source(name)}:"
                          f"\n{out}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("\n".join(failed))
    return targets


def build_log(name: str) -> List[str]:
    """The compiler's output of the last build of `name` (ptxas register
    and shared-memory counts), or [] if it was not built here."""
    log = BUILD_DIR / f"{name}.log"
    return log.read_text().splitlines() if log.exists() else []


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if it is not current."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        _loaded[name] = lib
    return lib
