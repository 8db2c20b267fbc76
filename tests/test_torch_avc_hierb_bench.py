"""The check of the hierarchical-B CABAC cell (``benchmark/systems/
avc_hierb.py`` over ``benchmark/reference/avc_hierb_ref.py``) on the CPU at
64x64, without the JAX package: the port's seeded ``pan`` clip (IDR and one
GOP of 4) reads inside every limit; with the in-loop filter left out of the
decode (the control) the pictures differ; with a fault of
``benchmark/faults.py`` planted the reading it is meant to move goes over its
limit while the stream still decodes to the reconstruction; and the
lookahead guard stops an encoder that reads the whole clip first.

The clips' square is cut to 32 pels: at 64x64 the traffic's 96-pel square
would fill the frame and hold it still."""

import numpy as np
import pytest
import torch

from benchmark.faults import plant
from benchmark.harness.registry import Registry

CELL = "avc_cif_hierb.clip50"
SEED = 3000000019
H = W = 64
N = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cell():
    reg = Registry()
    spec = reg.cell(CELL)
    config = reg.config(spec["config"])
    traffic = dict(reg.traffic(spec["traffic"]), square_size=32)
    frames = reg.generator(traffic["generator"]).make_pool(
        traffic, H, W, SEED)[0][:N]
    settings = dict(config["settings"], width=W, height=H)
    return reg.system(config["system"]), settings, spec, frames


def _readings(cell, fault=None, control=False):
    system, settings, spec, frames = cell
    codec = system.build(settings, "cpu")
    with plant(fault):
        results, stream = system.encode(codec, iter(frames))
    out = system.output(results, stream)
    assert out["types"] == ["IDR", "B", "B", "B", "P"]
    check = dict(spec["check"], frames=N)         # every picture
    return system.check(settings, check, [out], [frames],
                        np.random.default_rng(0), control=control)


@pytest.fixture(scope="module")
def sound(cell):
    return _readings(cell)


def test_sound_encode_reads_inside_every_limit(cell, sound):
    limits = cell[2]["check"]["limits"]
    assert set(sound) == set(limits)
    assert sound["decode_mismatch_px"] == 0
    assert sound["level_band_violations"] == 0
    assert sound["motion_gap"] is not None
    for key, limit in limits.items():
        assert sound[key] <= limit, (key, sound)


def test_control_is_over_its_limit(cell):
    got = _readings(cell, control=True)
    assert got["decode_mismatch_px"] > cell[2]["check"]["limits"][
        "decode_mismatch_px"]


@pytest.mark.parametrize("fault,number", [
    ("zero_mv", "motion_gap"),
    ("drop_residual", "level_band_violations")])
def test_planted_fault_is_over_its_limit(cell, fault, number):
    got = _readings(cell, fault)
    assert got[number] > cell[2]["check"]["limits"][number], got
    assert got["decode_mismatch_px"] == 0              # self-consistent


class _Codec:
    bframes = 3

    def __init__(self):
        self.host_ms = dict(pack=[], deblock=[])


@pytest.mark.parametrize("n,ahead", [(9, True), (9, False), (3, True)])
def test_lookahead_guard(cell, n, ahead):
    """An encoder that reads the whole clip first stops at frame 5; one
    that packs a picture per frame taken past the first GOP does not."""
    system = cell[0]
    codec = _Codec()
    taken = []
    frames = system.lookahead(codec, iter(range(n)))
    if ahead and n > 5:
        with pytest.raises(RuntimeError, match="frame 5"):
            for k in frames:
                taken.append(k)
        assert taken == [0, 1, 2, 3, 4]
        return
    for k in frames:
        taken.append(k)
        if not ahead:
            codec.host_ms["pack"].append(1.0)
    assert taken == list(range(n))
