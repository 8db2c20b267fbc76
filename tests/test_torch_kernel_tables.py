"""The constant tables of the decision scan's CUDA kernels equal the plain
versions' tables.

The kernels (``h264tpu_torch/csrc``) build and run only on a card, where
``tests/test_torch_gpu.py`` holds their outputs to the plain versions'.
This test reads each ``__constant__`` table and ``constexpr`` value out of
the sources and compares it with the table the plain PyTorch version
reads, so that a table edited on one side fails here, on the CPU.
"""

import re
from pathlib import Path

import numpy as np
import pytest

from h264tpu_torch.avc import device_enc as DE
from h264tpu_torch.avc import quant_dev as Q
from h264tpu_torch.avc import tables as T
from h264tpu_torch.entropy import cavlc as EC
from h264tpu_torch.ops import transform as TR

CSRC = Path(DE.__file__).resolve().parents[1] / "csrc"


def _constants(name: str) -> dict:
    """{table name: int array} of the ``__constant__ int`` arrays and the
    ``constexpr int`` values in ``csrc/<name>``."""
    src = re.sub(r"//[^\n]*", "", (CSRC / name).read_text())
    out = {}
    for m in re.finditer(r"__constant__\s+int\s+(\w+)((?:\[\d+\])+)\s*=\s*"
                         r"(\{.*?\});", src, re.S):
        shape = tuple(int(d) for d in re.findall(r"\[(\d+)\]", m.group(2)))
        vals = [int(v) for v in re.findall(r"-?\d+", m.group(3))]
        out[m.group(1)] = np.array(vals, np.int64).reshape(shape)
    for m in re.finditer(r"constexpr\s+int\s+(\w+)\s*=\s*(-?\d+)\s*;", src):
        out[m.group(1)] = int(m.group(2))
    return out


def _mode_tables() -> dict:
    slot_dir = {"none": 0, "16x8_bot": 1, "8x16_left": 1, "16x8_top": 2,
                "8x16_right": 3}
    return dict(
        FIRST_SLOT=[s[0] for s in DE.MODE_SLOTS],
        N_PARTS=[len(s) for s in DE.MODE_SLOTS],
        HDR_BITS=list(DE.MODE_HDR_BITS),
        SLOT_GEO=[list(s) for s in DE.SLOTS],
        SLOT_DIR=[slot_dir[tag] for tags in DE.MODE_TAGS for tag in tags],
        SCAN_Y=T.BLOCK_SCAN[:, 0], SCAN_X=T.BLOCK_SCAN[:, 1],
        SCAN_INV=T.BLOCK_SCAN_INV.reshape(16),
        CBP_INTER=T.CBP_TO_CODENUM_INTER)


# per source: {table: the plain version's table}
WANT = {
    "avc_block.cuh": lambda: dict(
        ZZ_INV=TR.ZIGZAG_INV, LEVEL_LIMIT=Q.CAVLC_LEVEL_LIMIT,
        AR_WEIGHT=Q.AR_WEIGHT, OFFSET_INTER=Q.OFFSET_INTER),
    "cavlc_est.cuh": lambda: dict(
        TOKEN_LEN=EC.COEFF_TOKEN_LEN, TZ_LEN=EC.TOTAL_ZEROS_LEN,
        RB_LEN=EC.RUN_BEFORE_LEN, CDC_TOKEN_LEN=T.CHROMA_DC_TOKEN_LEN,
        CDC_TZ_LEN=T.CHROMA_DC_TZ_LEN),
    "intra4.cu": lambda: dict(
        SCAN_Y=T.BLOCK_SCAN[:, 0], SCAN_X=T.BLOCK_SCAN[:, 1],
        TR_INMB_OK=DE._TR_INMB_OK.astype(np.int64)),
    "inter_rd.cu": lambda: dict(_mode_tables(),
                                MAX_R=DE.INTER_RD_MAX_R),
}


@pytest.mark.parametrize("source", sorted(WANT))
def test_kernel_tables_equal_the_plain_versions(source):
    got = _constants(source)
    for name, want in WANT[source]().items():
        assert name in got, f"{source} has no table {name}"
        assert np.array_equal(np.asarray(got[name]),
                              np.asarray(want, np.int64)), (source, name)
