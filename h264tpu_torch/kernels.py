"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C launch function.  At first use it
is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``h264tpu_torch/_build/`` (named by a hash of the source and of the shared
``csrc/*.cuh`` headers, so an edited source is rebuilt) and loaded with
``ctypes``.  Importing this module builds nothing.
The native host stages (``csrc/avc_native.cpp`` through ``avc/native.py``,
``csrc/fvc_native.cpp`` through ``entropy/native.py``) build the same way
with ``g++`` (:func:`build_host`).  Builds are serialised by a lock within a
process and land through a temporary file and ``os.replace``, so threads and
spawned processes that build at once each load a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("cross_cells", "deblock", "intra4", "inter_rd")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# argtypes of each source's launch function
_SIGNATURES = {
    "cross_cells": ("cross_cells_launch", [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                           _I, _P]),
    "deblock": ("deblock_launch", [_P, _P, _P, _P, *[_I] * 12, _P]),
    "intra4": ("intra4_launch", [*[_P] * 21, _I, _I, _I, _P]),
    "inter_rd": ("inter_rd_launch", [*[_P] * 49, *[_I] * 15, _P]),
}
_LIBS: dict = {}
_BUILD_LOCK = threading.Lock()
GXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels in h264tpu_torch/csrc")


def gxx_path() -> str:
    """The host C++ compiler that builds the port's native host stages."""
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: a host C++ compiler is needed to build "
                       "the native host stages in h264tpu_torch/csrc")


def build_host(source: Path, out: Path) -> str:
    """Compile the host library ``out`` from ``source`` with ``g++`` if it is
    missing; returns the compiler's log ("" when it was already built).
    Raises with the log when the build fails."""
    with _BUILD_LOCK:
        if out.exists():
            return ""
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx_path(), *GXX_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed to build {source.name}:\n"
                               + proc.stdout + proc.stderr)
        os.replace(tmp, out)
        return proc.stdout + proc.stderr


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source and
    of every ``csrc/*.cuh`` header."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns {name: compiler log} for the sources built now."""
    with _BUILD_LOCK:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name in todo:
            tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(SRC_DIR / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
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
    """The bound launch function of ``csrc/<name>.cu``, built on first use
    (with every other missing library of ``SOURCES``, in one round)."""
    fn = _LIBS.get(name)
    if fn is None:
        build_all()
        lib = ctypes.CDLL(str(library_path(name)))
        sym, argtypes = _SIGNATURES[name]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return fn


def launch_cross_cells(org: torch.Tensor, refs_pad: torch.Tensor,
                       slots: torch.Tensor, out: torch.Tensor, sr: int):
    """Launch ``cross_cells`` on the current stream into ``out`` [R, n_off,
    H/4, W/4] (arguments checked by the caller, ``ops.fractal.cross_cell_sums``);
    raises on a launch error."""
    H, W = org.shape
    R, n_off = out.shape[:2]
    err = load("cross_cells")(
        org.data_ptr(), refs_pad.data_ptr(), slots.data_ptr(),
        out.data_ptr(), H, W, R, n_off, sr,
        org.device.index if org.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(org.device).cuda_stream)
    if err:
        raise RuntimeError(f"cross_cells launch failed with cudaError {err}")


def launch_deblock(plane: torch.Tensor, bs_v: torch.Tensor,
                   bs_h: torch.Tensor, out: torch.Tensor, alpha: int,
                   beta: int, tc0, luma: bool):
    """Launch the ``deblock`` kernel pair on the current stream: ``out`` [B,
    H, W] = ``plane`` deblocked (arguments checked by the caller,
    ``ops.deblock.deblock_plane``); raises on a launch error."""
    B, H, W = plane.shape
    err = load("deblock")(
        plane.data_ptr(), bs_v.data_ptr(), bs_h.data_ptr(), out.data_ptr(),
        B, H, W, alpha, beta, *tc0, int(luma),
        plane.device.index if plane.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(plane.device).cuda_stream)
    if err:
        raise RuntimeError(f"deblock launch failed with cudaError {err}")


def launch_intra4(inputs, outputs, mb_w: int):
    """Launch ``intra4`` on the current stream: one thread block per lane
    (arguments checked by the caller, ``avc.device_enc.intra4``).
    ``inputs``: patch, org16, mby, mbx, l_nnz, t_nnz, l_i4m, t_i4m, qp, lam,
    ar_off, mf, ils; ``outputs``: modes, zzs, flags, rec, nnz_cells,
    modes_cells, fadj, cost.  Raises on a launch error."""
    dev = inputs[0].device
    err = load("intra4")(
        *(t.data_ptr() for t in inputs), *(t.data_ptr() for t in outputs),
        inputs[0].shape[0], mb_w,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"intra4 launch failed with cudaError {err}")


def launch_inter_rd(inputs, outputs, sizes):
    """Launch ``inter_rd`` on the current stream: a thread block per lane
    and candidate, one more per lane for skip (arguments checked by the
    caller, ``avc.device_enc.inter_rd``).  ``inputs``: the 29 operands of
    ``inter_rd_launch`` in its order, None for an absent optional one (the
    WP weights, the sub-partitioned candidate); ``outputs``: its 20
    outputs; ``sizes``: L, M, R, ns, n_valid, sh4, w4, Hf, Wp, Hcf, Wc, P,
    PC, band_h.  Raises on a launch error."""
    dev = outputs[0].device
    err = load("inter_rd")(
        *(None if t is None else t.data_ptr() for t in inputs),
        *(t.data_ptr() for t in outputs), *sizes,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"inter_rd launch failed with cudaError {err}")
