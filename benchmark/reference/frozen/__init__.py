"""Frozen copies of the decoders that the benchmark's plain reference runs.

These modules are copies of ``h264tpu_torch`` modules as they stood at commit
e045584 (same relative paths under this folder), so that the reference never
imports the program under test.  The changes made in copying:

* ``ops/fractal.py`` keeps only the reference planes, the sum tables and the
  reconstruction (no search, no CUDA kernel);
* ``entropy/fractal_syntax.py`` keeps only the readers; CAVLC residuals and
  intra modes go through the Python coders instead of the native library;
* ``bitstream/nal.py`` strips emulation prevention in Python;
* ``avc/slice_dec.py`` deblocks with the numpy filter of ``avc/deblock.py``,
  raises where the program's decoder would conceal a lost macroblock, and
  drops the CABAC and B-slice functions and FMO (the benchmark's streams are
  Baseline CAVLC P and I slices), and, where the caller sets
  ``AVCDecoder.probe`` to a list, records each inter macroblock's partitions,
  luma prediction and decoded luma levels there.

Nothing here is edited to follow a later change of the program: a change that
alters what the program writes has to show that these copies still read it.
"""

from __future__ import annotations

import numpy as np
import torch

_CONSTS: dict = {}


def device_const(name: str, value: np.ndarray, device) -> torch.Tensor:
    """A small constant table on ``device``, made once per device."""
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(value)).to(device)
        _CONSTS[key] = t
    return t
