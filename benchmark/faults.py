"""Faults planted in the program under test, each self-consistent: the
stream still decodes to the encoder's reconstruction, so only the check's
readings of the encoder's choices can catch it.  ``benchmark/control.py``
reads them on the card at a cell's size, ``benchmark/tests`` on the CPU.

    with plant("zero_mv"):
        ...  # the program runs with the fault

* ``zero_mv``: the conformant encoder's whole-pel search (Stage A) returns
  the zero vector for every partition; Stage B refines around it.
* ``drop_residual``: the conformant encoder codes no luma residual in inter
  candidates, and the fractal codec none in any plane of a P frame.
* ``split_all``: the fractal search takes both tolerances as 0, so it splits
  every 16x16 block that the correlation gate lets through, down to 4x4.
"""

from __future__ import annotations

import contextlib
import importlib

import torch


def _zero_mv(mod):
    orig = mod._integer_search

    def faulty(*args, **kwargs):
        mv, sad, pmv = orig(*args, **kwargs)
        return torch.zeros_like(mv), sad, pmv
    return "_integer_search", faulty


def _drop_inter_luma(mod):
    orig = mod._code_inter_luma

    def faulty(org16, pred16, qp, ar_off, qm=None):
        zz, rec, cbp, fadj = orig(org16, pred16, qp, ar_off, qm)
        return (torch.zeros_like(zz), pred16.to(rec.dtype).expand_as(rec),
                torch.zeros_like(cbp), torch.zeros_like(fadj))
    return "_code_inter_luma", faulty


def _drop_plane_residual(mod):
    orig = mod.residual_code_plane

    def faulty(org, pred, qp, luma_mb_grid=True):
        zz, rec = orig(org, pred, qp, luma_mb_grid)
        return torch.zeros_like(zz), pred.to(rec.dtype)
    return "residual_code_plane", faulty


def _split_all(mod):
    orig = mod.search_plane

    def faulty(org, ref, **kwargs):
        kwargs.update(tol16=0.0, tol8=0.0)
        return orig(org, ref, **kwargs)
    return "search_plane", faulty


FAULTS = {
    "zero_mv": [("h264tpu_torch.avc.device_enc", _zero_mv)],
    "drop_residual": [("h264tpu_torch.avc.device_enc", _drop_inter_luma),
                      ("h264tpu_torch.ops.transform", _drop_plane_residual)],
    "split_all": [("h264tpu_torch.ops.fractal", _split_all)],
}


@contextlib.contextmanager
def plant(name: str):
    """Run the body with fault ``name`` planted (None: no fault)."""
    undo = []
    try:
        for module, make in FAULTS.get(name, []) if name else []:
            mod = importlib.import_module(module)
            attr, faulty = make(mod)
            undo.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, faulty)
        if name and name not in FAULTS:
            raise KeyError(f"no fault named {name!r}")
        yield
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)
