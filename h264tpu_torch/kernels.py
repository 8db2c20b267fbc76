"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launch function.  At first use it
is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``h264tpu_torch/_build/`` (named by a hash of the source, so an edited source
is rebuilt) and loaded with ``ctypes``.  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("cross_cells",)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of each source's launch function
_SIGNATURES = {
    "cross_cells": ("cross_cells_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                           _I, _P]),
}
_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in h264tpu_torch/csrc")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns {name: compiler log} for the sources built now."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))
            library_path(name).with_suffix(".log").write_text(logs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str):
    """The bound launch function of ``csrc/<name>.cu``, built on first use."""
    fn = _LIBS.get(name)
    if fn is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        sym, argtypes = _SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn


def launch_cross_cells(org: torch.Tensor, refs_pad: torch.Tensor,
                       offsets: torch.Tensor, out: torch.Tensor, sr: int):
    """Launch ``cross_cells`` on the current stream (arguments checked by the
    caller, ``ops.fractal.cross_cell_sums``); raises on a launch error."""
    H, W = org.shape
    err = load("cross_cells")(
        org.data_ptr(), refs_pad.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), H, W, refs_pad.shape[0], offsets.shape[0], sr,
        org.device.index if org.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(org.device).cuda_stream)
    if err:
        raise RuntimeError(f"cross_cells launch failed with cudaError {err}")
