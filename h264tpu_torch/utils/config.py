"""Typed configuration for the codec (the port's own copy).

Mirrors ``h264tpu/utils/config.py`` field for field, so that a configuration
built for the JAX package carries over through :func:`config_from_dict`
without importing ``h264tpu``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class EntropyMode(enum.IntEnum):
    CAVLC = 0
    CABAC = 1
    EXP_GOLOMB = 2   # interim vectorized Exp-Golomb coefficient sets


class ProfileIDC(enum.IntEnum):
    BASELINE = 66
    MAIN = 77
    HIGH = 100


class SearchMode(enum.IntEnum):
    """Fractal search lattice (cf. ``FR/src/code.c:87`` search_mode)."""

    FULL = 0
    NEW_HEX = 1
    UMHEX = 2
    HEX = 3


@dataclasses.dataclass(frozen=True)
class FractalConfig:
    """Fractal (PIFS) P-frame engine parameters (thesis run config defaults)."""

    tol_16: float = 10.5       # split threshold for 16x16 range blocks
    tol_8: float = 8.0         # split threshold for 8x8
    tol_4: float = 6.0         # accept threshold for 4x4 (unused, as in FR)
    search_range: int = 7      # +-search window (integer pel) around block
    search_mode: SearchMode = SearchMode.FULL
    # alpha/beta quantization lattice (FR/inc/defines_enc.h:19-22, :591 QUAN_A)
    min_alpha: float = -2.35
    max_alpha: float = 4.0
    min_beta: float = -60.0
    max_beta: float = 255.0
    # normalized-correlation split gate (FR/src/block_enc.c:847-850)
    chun_lo: float = 0.9
    chun_hi: float = 1.0
    # use half-pel interpolated reference planes H/M/N in addition to C
    use_halfpel_refs: bool = True


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Top-level encoder/decoder configuration."""

    width: int = 352
    height: int = 288
    # --- GOP structure ---
    intra_period: int = 12       # every Nth frame is intra; 0 = IPPP...
    num_frames: int = 50
    frame_rate: float = 30.0
    # --- quality ---
    qp: int = 28
    qp_intra: Optional[int] = None  # defaults to qp
    # --- H.264 toolset ---
    profile: ProfileIDC = ProfileIDC.MAIN
    level_idc: int = 30
    entropy: EntropyMode = EntropyMode.CAVLC
    deblock: bool = True
    hadamard: bool = True
    num_ref_frames: int = 1
    me_search_range: int = 16
    # --- P-frame engine: "fractal" (thesis PIFS) or "classic" (H.264 ME) ---
    inter_mode: str = "fractal"
    # --- fractal engine ---
    fractal: FractalConfig = FractalConfig()
    # --- stereo / multi-view ---
    views: int = 1
    # --- region/object-based coding ---
    num_regions: int = 1
    # --- stream container: "fvc", "annexb", "rtp" ---
    container: str = "fvc"
    # --- rate control ---
    rate_control: bool = False
    target_bitrate: float = 0.0
    # --- parallel layout (tile_rows also fixes the deblocking band grid) ---
    tile_rows: int = 1
    tile_cols: int = 1
    gop_parallel: int = 1

    @property
    def qp_i(self) -> int:
        return self.qp if self.qp_intra is None else self.qp_intra

    def validate(self) -> "CodecConfig":
        if self.width % 16 or self.height % 16:
            raise ValueError("width/height must be multiples of 16 (pad input)")
        if not (0 <= self.qp <= 51):
            raise ValueError("qp out of [0,51]")
        if self.views not in (1, 3):
            raise ValueError("views must be 1 or 3")
        if self.tile_rows < 1 or (self.height // 16) % self.tile_rows:
            raise ValueError("tile_rows must divide the MB-row count")
        if (self.height // 2) % max(self.tile_rows, 1):
            raise ValueError("tile_rows must divide the chroma height")
        return self


_ENUM_FIELDS = {"entropy": EntropyMode, "profile": ProfileIDC}


def config_from_dict(d: dict) -> CodecConfig:
    """Build a :class:`CodecConfig` from a plain dict of numbers and strings,
    e.g. ``dataclasses.asdict`` of the JAX package's config.  Enum members of
    any origin are read by their integer value."""
    kw = dict(d)
    fr = dict(kw.pop("fractal", {}) or {})
    if "search_mode" in fr:
        fr["search_mode"] = SearchMode(int(fr["search_mode"]))
    for name, enum_cls in _ENUM_FIELDS.items():
        if name in kw:
            kw[name] = enum_cls(int(kw[name]))
    return CodecConfig(fractal=FractalConfig(**fr), **kw)
