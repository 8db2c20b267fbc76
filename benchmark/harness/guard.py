"""The import guard: no JAX and no JAX package in a process that measures
the port.  Names are compared whole at the top level (the part before the
first dot), so ``h264tpu_torch`` is not ``h264tpu``."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "h264tpu"})


def top_level(names) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(modules=None, forbidden=FORBIDDEN) -> list:
    """Sorted top-level names of ``modules`` (default ``sys.modules``) that
    are in ``forbidden``."""
    names = sys.modules if modules is None else modules
    return sorted(top_level(names) & set(forbidden))
