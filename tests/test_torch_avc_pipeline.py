"""The conformant encoder's per-picture host stage (on the CPU at 64x48,
without the JAX package): IPPP and B-GOP sequences and MVC's view 1 pack
each picture with the packer its kind and the codec's options give it, and
record one ``host_ms["pack"]`` and one ``host_ms["deblock"]`` entry per
picture.

The native and the numpy CAVLC packers write the same bytes, so no stream
test sees a picture handed to the other one: here every packer is wrapped,
and the calls made between two ``trace.frame_done`` calls belong to the
picture the second one names.

| Picture                    | CAVLC                        | CABAC          |
|----------------------------|------------------------------|----------------|
| IDR, IPPP sequence         | native ``pack_slice``        | CABAC I        |
| P, IPPP sequence           | native; numpy with sub-8x8   | CABAC P        |
|                            | or data partitioning         |                |
| IDR / P anchor, B-GOP      | numpy I / P                  | CABAC I / P    |
| B picture                  | numpy B                      | CABAC B        |
| MVC view 1                 | numpy P (list reordering)    | --             |
"""

import numpy as np
import pytest
import torch

from h264tpu_torch import trace
from h264tpu_torch.avc import mvc as MVC
from h264tpu_torch.avc import native as AN
from h264tpu_torch.avc import pack as PK
from h264tpu_torch.avc import pack_cabac as PKC
from h264tpu_torch.avc.device_codec import DeviceAVCCodec
from h264tpu_torch.avc.params import AVCParams, SLICE_I

H, W = 48, 64

NATIVE_I, NATIVE_P = "native I", "native P"
HIERB = dict(profile_idc=77, poc_type=0, num_ref_frames=3, cabac=True)
HIGH = dict(profile_idc=100, transform_8x8=True, scaling_matrix="default")

# name: (AVCParams fields, DeviceAVCCodec options, frames, packer by type)
CASES = {
    "ippp_cavlc": (dict(num_ref_frames=2), dict(n_slices=3, intra_period=2),
                   3, {"IDR": NATIVE_I, "P": NATIVE_P}),
    "ippp_sub8x8": (HIGH, dict(sub8x8=True), 3,
                    {"IDR": NATIVE_I, "P": "pack_p_slice"}),
    "ippp_data_partitioning": (dict(), dict(n_slices=3,
                                            data_partitioning=True), 3,
                               {"IDR": NATIVE_I, "P": "pack_p_slice"}),
    "ippp_cabac": (dict(profile_idc=77, cabac=True), dict(n_slices=3), 3,
                   {"IDR": "pack_i_slice_cabac",
                    "P": "pack_p_slice_cabac"}),
    "ibbp_cavlc": (dict(profile_idc=77, poc_type=0, num_ref_frames=2),
                   dict(bframes=2), 4,
                   {"IDR": "pack_i_slice", "P": "pack_p_slice",
                    "B": "pack_b_slice"}),
    "hierb_cabac": (HIERB, dict(bframes=3, hierarchical=True, n_slices=3), 5,
                    {"IDR": "pack_i_slice_cabac", "P": "pack_p_slice_cabac",
                     "B": "pack_b_slice_cabac"}),
    "mvc": (dict(num_ref_frames=2), dict(n_slices=3), 3,
            {"IDR": NATIVE_I, "P": NATIVE_P, "view 1": "pack_p_slice"}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, seed=5):
    """A smooth texture panned (1, 2) pels a frame, with noise."""
    rng = np.random.default_rng(seed)
    big = rng.normal(0, 1, (H + 2 * n, W + 2 * n))
    for _ in range(3):
        big = (big + np.roll(big, 1, 0) + np.roll(big, -1, 0)
               + np.roll(big, 1, 1) + np.roll(big, -1, 1)) / 5
    big = 128 + big / big.std() * 45
    out = []
    for i in range(n):
        y = np.clip(big[i:i + H, 2 * i:2 * i + W]
                    + rng.normal(0, 4, (H, W)), 0, 255).astype(np.uint8)
        u = np.clip(y[::2, ::2] * 0.5 + 60, 0, 255).astype(np.uint8)
        v = np.clip(200 - y[1::2, 1::2] * 0.4, 0, 255).astype(np.uint8)
        out.append((y, u, v))
    return out


@pytest.fixture
def packers(monkeypatch):
    """Every picture's packer calls, [(seq, idx, type, [packer names])]
    in the order the pictures are done."""
    calls, done = [], []

    def wrap(mod, name, label):
        orig = getattr(mod, name)

        def packer(*a, **kw):
            calls.append(label(a) if callable(label) else label)
            return orig(*a, **kw)
        monkeypatch.setattr(mod, name, packer)

    wrap(AN, "pack_slice",
         lambda a: NATIVE_I if a[2] == SLICE_I else NATIVE_P)
    for mod, names in ((PK, ("pack_i_slice", "pack_p_slice", "pack_b_slice")),
                       (PKC, ("pack_i_slice_cabac", "pack_p_slice_cabac",
                              "pack_b_slice_cabac"))):
        for name in names:
            wrap(mod, name, name)
    frame_done = trace.frame_done

    def record(seq, idx, ftype):
        done.append((seq, idx, ftype, calls[:]))
        calls.clear()
        frame_done(seq, idx, ftype)
    monkeypatch.setattr(trace, "frame_done", record)
    return done


@pytest.mark.parametrize("name", list(CASES))
def test_each_picture_reaches_its_packer(name, packers):
    fields, opts, n, want = CASES[name]
    p = AVCParams(width=W, height=H, qp=30, **fields)
    frames = _frames(n)
    if name == "mvc":
        codec = MVC.MVCStereoCodec(p, search_range=4, device="cpu", **opts)
        view1 = [tuple(np.roll(pl, -2, axis=1) for pl in f) for f in frames]
        r0, r1, _ = codec.encode_sequence(frames, view1)
        types = [r.frame_type for r in r0] + ["view 1"] * len(r1)
        host_ms = codec.base.host_ms
    else:
        codec = DeviceAVCCodec(p, search_range=4, device="cpu", **opts)
        results, _ = codec.encode_sequence(frames)
        types = [r.frame_type for r in results]
        host_ms = codec.host_ms
    assert len(types) == (2 * n if name == "mvc" else n)
    assert set(types) == set(want)
    seqs = sorted({seq for seq, _, _, _ in packers})
    got = {}
    for seq, idx, ftype, names in packers:
        kind = "view 1" if seq == seqs[-1] and name == "mvc" else ftype
        assert names == [want[kind]] * codec.n_slices, (seq, idx, kind)
        got[(seq, idx)] = kind
    assert sorted(got.values()) == sorted(types)
    assert len(host_ms["pack"]) == len(types)
    assert len(host_ms["deblock"]) == len(types)
