"""A device mesh for one controlling process.

The JAX package's mesh is single-controller: one process drives every
device, ``shard_map`` runs the local function per device and ``ppermute``
moves data between neighbours.  The port's twin is a :class:`Mesh` of
``torch.device`` slots: the caller launches each slot's work on that slot's
device, and data crosses slots by explicit ``.to(device)`` copies, which
PyTorch orders after the producer's work on the source device's current
stream.  A mesh may name one device more than once (the whole decomposition
then runs on one card), any number of cards, or CPU slots.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """``devices``: an array (nested lists or a numpy object array) of
    ``torch.device`` or device strings whose shape names the axes in
    ``axis_names``; ``mesh.shape["tile"]`` is the size of axis "tile", as in
    ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names) or arr.size == 0:
            raise ValueError(f"mesh devices of shape {arr.shape} do not match "
                             f"axes {self.axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = torch.device(arr[idx])
        self.shape = dict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in slot order."""
        out = []
        for d in self.devices.flat:
            if d not in out:
                out.append(d)
        return out

    def axis_devices(self, axis: str) -> list:
        """The slots along ``axis`` (index 0 on every other axis), in order."""
        k = self.axis_names.index(axis)
        idx = [0] * self.devices.ndim
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(self.devices[tuple(idx)])
        return out


def split_rows(x: torch.Tensor, n: int) -> list:
    """``x`` cut into ``n`` equal parts along its first dimension (views);
    raises when ``n`` does not divide it."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} equal "
                         "parts")
    return list(torch.split(x, x.shape[0] // n))


def gather(parts, device) -> torch.Tensor:
    """The slots' tensors concatenated along their first dimension on
    ``device``."""
    return torch.cat([p.to(device) for p in parts])
