"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` (``SOURCES``) has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into ``build/kernels/lib<name>_<hash>.so`` at the
root of the checkout, at first use, then loaded with ``ctypes``. The hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited source or header builds anew.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def library_path(name: str) -> Path:
    parts = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


SOURCES = ("expand", "expand_lanes", "ffbsi_fallback")


def _start(name: str, ptxas_info: bool):
    """Start ``nvcc`` on ``csrc/<name>.cu`` unless its library is built.
    Returns ``(process, temporary output)`` or None."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp


def _finish(name: str, started) -> str | None:
    if started is None:
        return None
    proc, tmp = started
    text = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"{name}.cu: nvcc exited with {proc.returncode}\n{text}")
    os.replace(tmp, library_path(name))
    return text


def build(name: str = "expand", ptxas_info: bool = False) -> str | None:
    """Compile ``csrc/<name>.cu`` unless its library is built. Returns the
    compiler's messages (with ``ptxas_info``, the registers and shared
    memory of each kernel), or None when the library was already built."""
    return _finish(name, _start(name, ptxas_info))


def build_all(names=SOURCES, ptxas_info: bool = False) -> dict:
    """Compile every named source, one ``nvcc`` each, all started together.
    Returns ``{name: (messages or None, seconds until that build ended)}``."""
    t0 = time.perf_counter()
    started = {name: _start(name, ptxas_info) for name in names}
    return {name: (_finish(name, s), time.perf_counter() - t0) for name, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build(name)
        lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
