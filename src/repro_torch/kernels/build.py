"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` at first use into a
shared library with a plain C interface, then loaded with ``ctypes``:
no PyTorch headers are compiled, so a build takes seconds.  Libraries go
to ``build/repro_torch/`` at the repository root (listed in
``.gitignore``); the file name carries a hash of the sources and flags,
so an edited kernel is never served stale.  :func:`build` compiles
several sources at once, one ``nvcc`` process each, all started
together.

Nothing here runs at import time: the CPU tests import every module of
the port on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["SOURCES", "build", "build_dir", "library", "BUILD_LOG"]

CSRC = Path(__file__).resolve().parent / "csrc"

#: every kernel source of the port (csrc/<name>.cu)
SOURCES = ("pack", "unpack", "stencil")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--ptxas-options=-v",
)

#: name -> what nvcc/ptxas printed for the last build (registers, spills)
BUILD_LOG: Dict[str, str] = {}

_LIBS: Dict[str, ctypes.CDLL] = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C signatures: (buffer, bstride, buffer, bstride, batch, word,
#: lanes, rows, planes, pitch, base, plane_stride, device, stream), with
#: each kernel's own ints before the device: (vector bytes, path) for the
#: row kernels, (vector bytes, path, tile rows) for the dma kernels
_KERNEL_ARGS = [_P, _L, _P, _L, _I, _I, _L, _L, _L, _L, _L, _L, _I, _P]
_ROW_KERNEL_ARGS = _KERNEL_ARGS[:12] + [_I, _I] + _KERNEL_ARGS[12:]
_DMA_KERNEL_ARGS = _KERNEL_ARGS[:12] + [_I, _I, _I] + _KERNEL_ARGS[12:]
#: the stencil update: (in, 3 strides, out, 3 strides, batch, nz, ny, nx,
#: rz, ry, rx, copied rim, element bytes, w / N, 1 - w, device, stream)
_STENCIL_ARGS = [_P, _L, _L, _L, _P, _L, _L, _L] + [_I] * 9 + [ctypes.c_double] * 2 + [_I, _P]
#: the fused pair: (in, 3 strides, out, 3 strides, batch, nz, ny, nx,
#: element bytes, the two updates' w / N and 1 - w, device, stream)
_PAIR_ARGS = [_P, _L, _L, _L, _P, _L, _L, _L] + [_I] * 5 + [ctypes.c_double] * 4 + [_I, _P]
_ENTRIES = {
    "pack": {"tempi_pack_rows": _ROW_KERNEL_ARGS, "tempi_pack_dma": _DMA_KERNEL_ARGS},
    "unpack": {"tempi_unpack_rows": _ROW_KERNEL_ARGS, "tempi_unpack_dma": _DMA_KERNEL_ARGS},
    "stencil": {"tempi_stencil_update": _STENCIL_ARGS, "tempi_stencil_pair": _PAIR_ARGS},
}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one ``nvcc``
    per source, all running at once.  Returns name -> library path;
    raises with the compiler's output if any build fails."""
    out: Dict[str, Path] = {}
    procs = {}
    for name in names:
        target = _target(name)
        out[name] = target
        if target.exists():
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (rc={proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for entry, argtypes in _ENTRIES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
