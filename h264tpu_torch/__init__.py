"""h264tpu_torch — the PyTorch/CUDA port of h264tpu for NVIDIA Hopper.

Module paths mirror ``h264tpu/`` one to one.  The port imports ``torch`` and
numpy only: it never imports JAX or anything from ``h264tpu`` and keeps its
own copies of the host modules it needs.  Entry points run on the card
unless the caller asks for another device; with no card present and no
device given they raise instead of falling back to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The CUDA device; raises when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "h264tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' explicitly to run the plain PyTorch path")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; None means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


_CONSTS: dict = {}


def device_const(name: str, value: np.ndarray, device) -> torch.Tensor:
    """A small constant table on ``device``, uploaded once per device.

    Uploading from pageable host memory inside the encode loop would make the
    host wait for the stream; cached tables keep dispatch asynchronous.
    """
    key = (name, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(value)).to(device)
        _CONSTS[key] = t
    return t
