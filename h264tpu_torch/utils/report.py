"""Sequence encode reporting — the JM ``report.c`` / ``log.dat`` analogue.

The reference appends one labeled row per run to ``log.dat``
(``JM/lencod/src/report.c``; measured rows in ``JM/log.dat:4-24``) and
prints per-frame/console totals.  This module reproduces that shape so
benches are regression-comparable across rounds: per-frame rows, sequence
totals (PSNR avg, total bits, bitrate @ fps, encode wall time), and an
append-only ``log.dat``-style line.

The port's own copy of ``h264tpu/utils/report.py``; its text is the
reference's character for character.
"""

from __future__ import annotations

import dataclasses
import os
import time


@dataclasses.dataclass
class SequenceReport:
    label: str = "h264tpu"
    frame_rate: float = 30.0
    rows: list = dataclasses.field(default_factory=list)
    t_start: float = dataclasses.field(default_factory=time.time)
    t_end: float = None

    def add(self, result):
        """Record one FrameResult-like object (frame_type, psnr_*, bits, qp)."""
        self.rows.append(dict(
            type=result.frame_type, psnr_y=result.psnr_y,
            psnr_u=result.psnr_u, psnr_v=result.psnr_v,
            bits=result.bits, qp=result.qp))

    def finish(self):
        self.t_end = time.time()
        return self

    # ---- aggregates (JM report() fields) ----
    @property
    def total_bits(self) -> int:
        return sum(r["bits"] for r in self.rows)

    @property
    def avg_psnr_y(self) -> float:
        return sum(r["psnr_y"] for r in self.rows) / max(len(self.rows), 1)

    @property
    def bitrate_kbps(self) -> float:
        n = max(len(self.rows), 1)
        return self.total_bits * self.frame_rate / n / 1000.0

    @property
    def encode_seconds(self) -> float:
        return (self.t_end or time.time()) - self.t_start

    @property
    def fps(self) -> float:
        return len(self.rows) / max(self.encode_seconds, 1e-9)

    def frame_lines(self):
        """Per-frame console rows (ReportP/ReportIntra analogue,
        FR/src/image.c:74)."""
        out = []
        for i, r in enumerate(self.rows):
            out.append(f"{i:04d}({r['type']})  {r['bits']:8d} {r['qp']:3d} "
                       f"{r['psnr_y']:8.4f} {r['psnr_u']:8.4f} "
                       f"{r['psnr_v']:8.4f}")
        return out

    def summary(self) -> str:
        return (f" Freq. for encoded bitstream   : {self.frame_rate:.0f}\n"
                f" PSNR Y(dB)                    : {self.avg_psnr_y:.2f}\n"
                f" Total bits                    : {self.total_bits}\n"
                f" Bit rate (kbit/s) @ {self.frame_rate:.2f} Hz : "
                f"{self.bitrate_kbps:.2f}\n"
                f" Total encoding time           : "
                f"{self.encode_seconds:.3f} sec ({self.fps:.2f} fps)")

    def logdat_row(self) -> str:
        """One log.dat-style row (cf. JM/log.dat:4 header/format)."""
        n = len(self.rows)
        first = self.rows[0]["psnr_y"] if self.rows else 0.0
        return (f"| {self.label:20s} | {n:4d} | "
                f"{self.rows[0]['qp'] if self.rows else 0:3d} | "
                f"{first:7.3f} | {self.avg_psnr_y:7.3f} | "
                f"{self.total_bits:10d} | {self.bitrate_kbps:9.2f} | "
                f"{self.encode_seconds * 1000.0:9.1f} |")

    def append_logdat(self, path: str = "log.dat"):
        new = not os.path.exists(path)
        with open(path, "a") as f:
            if new:
                f.write("| label                | frm |  QP | SNRY 1 | "
                        "SNRY avg |  total bits |  kbit/s  | time(ms) |\n")
            f.write(self.logdat_row() + "\n")
