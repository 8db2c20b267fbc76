"""The PyTorch port's fractal codec options against the JAX package on the
CPU: rate control (streams, QPs and the controller's state after every
frame), the Annex-B and RTP containers with loss concealment, and the CABAC
and Exp-Golomb residual coders."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from h264tpu.bitstream import nal as JNAL, rtp as JRTP
from h264tpu.entropy import fractal_syntax as JFS
from h264tpu.entropy.bitio import BitWriter as JWriter
from h264tpu.models import ratectl as JRC
from h264tpu.utils.config import (CodecConfig as JCfg, EntropyMode as JEM,
                                  FractalConfig as JFr)
from h264tpu.models.fractal_codec import (FractalCodec as JCodec,
                                          FractalDecoder as JDecoder)
from h264tpu_torch.bitstream import nal as TNAL, rtp as TRTP
from h264tpu_torch.entropy import fractal_syntax as TFS
from h264tpu_torch.entropy.bitio import BitReader as TReader
from h264tpu_torch.entropy.bitio import BitWriter as TWriter
from h264tpu_torch.models import ratectl as TRC
from h264tpu_torch.utils.config import config_from_dict
from h264tpu_torch.models.fractal_codec import (FractalCodec as TCodec,
                                                FractalDecoder as TDecoder)

H, W = 64, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def blocky_frames(n, seed=0):
    """A blocky random texture per plane, shifted one pel per frame."""
    rng = np.random.default_rng(seed)
    tex = [np.kron(rng.integers(0, 255, (h // 4, w // 4)),
                   np.ones((4, 4), np.int64)).astype(np.uint8)
           for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    return [tuple(np.roll(t, (i, -i), axis=(0, 1)) for t in tex)
            for i in range(n)]


def payloads_of(stream, results):
    """Per-frame payloads of a raw FVC stream."""
    sizes = [r.bits // 8 for r in results]
    off = len(stream) - sum(sizes)
    out = []
    for s in sizes:
        out.append(stream[off:off + s])
        off += s
    return out


def _run(frames, **kw):
    jcfg = JCfg(width=W, height=H, qp=24, intra_period=0, deblock=True,
                fractal=JFr(search_range=4), **kw)
    j_res, j_stream = JCodec(jcfg).encode_sequence(frames)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    t_res, t_stream = TCodec(tcfg, device="cpu").encode_sequence(frames)
    return dict(frames=frames, tcfg=tcfg, j_res=j_res, j_stream=j_stream,
                t_res=t_res, t_stream=t_stream)


def _same_results(a, b):
    for j, t in zip(a, b):
        assert (t.frame_type, t.bits, t.qp) == (j.frame_type, j.bits, j.qp)
        for x, y in zip(t.recon, j.recon):
            np.testing.assert_array_equal(x, y)


def _same_frames(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- rate control ------------------------------------------------------------

class _Recorder:
    """Records a controller's state after construction and every update."""

    def __init__(self, cls):
        self.cls, self.states = cls, []
        self._init, self._update = cls.__init__, cls.update

    def __enter__(self):
        rec = self

        def init(ctl, *a, **k):
            rec._init(ctl, *a, **k)
            rec.states.append(copy.deepcopy(vars(ctl)))

        def update(ctl, *a, **k):
            rec._update(ctl, *a, **k)
            rec.states.append(copy.deepcopy(vars(ctl)))

        self.cls.__init__, self.cls.update = init, update
        return self

    def __exit__(self, *exc):
        self.cls.__init__, self.cls.update = self._init, self._update


@pytest.fixture(scope="module")
def ratectl():
    frames = blocky_frames(5)
    with _Recorder(JRC.QuadraticRateControl) as jrec, \
            _Recorder(TRC.QuadraticRateControl) as trec:
        run = _run(frames, rate_control=True, target_bitrate=60000.0)
    run.update(j_states=jrec.states, t_states=trec.states)
    return run


def test_ratectl_stream_and_qps(ratectl):
    assert ratectl["t_stream"] == ratectl["j_stream"]
    _same_results(ratectl["j_res"], ratectl["t_res"])
    qps = [r.qp for r in ratectl["t_res"]]
    assert len(set(qps[1:])) > 1, f"the controller never moved the QP {qps}"


def test_ratectl_controller_state_per_frame(ratectl):
    """The controller's state after every P frame, field by field: the
    port's exact SSE gives the reference's sqrt(mse_y) bit for bit."""
    assert len(ratectl["t_states"]) == len(ratectl["j_states"]) == 5
    for j, t in zip(ratectl["j_states"], ratectl["t_states"]):
        assert t.keys() == j.keys()
        for k in j:
            assert t[k] == j[k], k


def test_ratectl_carried_state(ratectl):
    """A controller holding the JAX controller's state, and the JAX
    reconstruction as the reference, give the JAX frame's QP and payload."""
    want = payloads_of(ratectl["j_stream"], ratectl["j_res"])
    codec = TCodec(ratectl["tcfg"], device="cpu")
    for k in range(1, 5):
        rc = TRC.QuadraticRateControl(60000.0, 30.0, 24)
        vars(rc).update(copy.deepcopy(ratectl["j_states"][k - 1]))
        qp = rc.frame_qp()
        assert qp == ratectl["j_res"][k].qp
        _, payload = codec.encode_frame(ratectl["frames"][k],
                                        ref=ratectl["j_res"][k - 1].recon,
                                        frame_idx=k, qp=qp)
        assert payload == want[k]


# -- containers --------------------------------------------------------------

@pytest.fixture(scope="module", params=["annexb", "rtp"])
def container(request):
    run = _run(blocky_frames(4), container=request.param)
    run["kind"] = request.param
    return run


def test_container_stream_byte_identical(container):
    assert TDecoder.detect_container(container["t_stream"]) == \
        container["kind"]
    assert container["t_stream"] == container["j_stream"]
    _same_results(container["j_res"], container["t_res"])


def test_container_cross_decode(container):
    t_dec = TDecoder(device="cpu").decode(container["j_stream"])
    _same_frames(t_dec, [r.recon for r in container["t_res"]])
    _same_frames(JDecoder().decode(container["t_stream"]), t_dec)


def _drop_frames(kind, stream, lost):
    """The stream without the frame units whose index is in ``lost``."""
    if kind == "annexb":
        keep = [n for n in TNAL.annexb_parse(stream)
                if n.nal_type != TNAL.NAL_FVC_FRAME
                or ((n.rbsp[0] << 8) | n.rbsp[1]) not in lost]
        return TNAL.annexb_write(keep)
    keep = []
    for p in TRTP.read_rtp_file(stream):
        n = TNAL.nalu_from_bytes(p.payload)
        if n.nal_type != TNAL.NAL_FVC_FRAME or \
                ((n.rbsp[0] << 8) | n.rbsp[1]) not in lost:
            keep.append(p)
    return TRTP.write_rtp_file(keep)


@pytest.mark.parametrize("lost", [(2,), (0,)], ids=["frame2", "frame0"])
def test_container_loss_concealment(container, lost):
    """A lost frame unit: frame copy of the previous frame (mid-grey without
    one); both decoders conceal alike and decode on from there."""
    damaged = _drop_frames(container["kind"], container["t_stream"], lost)
    assert len(damaged) < len(container["t_stream"])
    t_dec = TDecoder(device="cpu").decode(damaged)
    _same_frames(JDecoder().decode(damaged), t_dec)
    recon = [r.recon for r in container["t_res"]]
    if lost == (2,):
        _same_frames(t_dec[:2], recon[:2])
        _same_frames(t_dec[2:3], recon[1:2])
    else:
        assert all((p == 128).all() for p in t_dec[0])


@pytest.mark.parametrize("loss", [0, 30, 60])
def test_rtp_loss_and_dump_match_jax(loss):
    cfg = JCfg(width=W, height=H)
    payloads = [bytes([i]) * (7 + i) for i in range(12)]
    stream = JRTP.packetize(cfg, b"FVC1hdr", payloads)
    assert TRTP.packetize(config_from_dict(dataclasses.asdict(cfg)),
                          b"FVC1hdr", payloads) == stream
    assert TRTP.rtp_loss(stream, loss, seed=3) == \
        JRTP.rtp_loss(stream, loss, seed=3)
    assert TRTP.rtpdump(stream) == JRTP.rtpdump(stream)
    assert TRTP.depacketize(stream)[2:] == JRTP.depacketize(stream)[2:]
    assert TNAL.unwrap_stream(JNAL.wrap_stream(cfg, b"h", payloads))[2:] == \
        (b"h", dict(enumerate(payloads)))


# -- residual entropy modes ---------------------------------------------------

@pytest.fixture(scope="module", params=[JEM.CABAC, JEM.EXP_GOLOMB],
                ids=["cabac", "exp_golomb"])
def entropy(request):
    return _run(blocky_frames(4), entropy=request.param)


def test_entropy_stream_byte_identical(entropy):
    assert entropy["t_stream"] == entropy["j_stream"]
    _same_results(entropy["j_res"], entropy["t_res"])


def test_entropy_cross_decode(entropy):
    t_dec = TDecoder(device="cpu").decode(entropy["j_stream"])
    _same_frames(t_dec, [r.recon for r in entropy["t_res"]])
    _same_frames(JDecoder().decode(entropy["t_stream"]), t_dec)


@pytest.mark.parametrize("mode", [TFS.ENTROPY_CABAC, TFS.ENTROPY_EG],
                         ids=["cabac", "exp_golomb"])
def test_residual_bytes_and_round_trip(mode):
    """Seeded levels (empty blocks, runs, large levels) after 5 unaligned
    bits: the port's bytes equal the JAX package's and read back."""
    rng = np.random.default_rng(mode)
    zz = rng.integers(-40, 41, (48, 16)) * (rng.random((48, 16)) < 0.25)
    zz[::7] = 0
    jw, tw = JWriter(), TWriter()
    for w in (jw, tw):
        w.u(5, 3)
    JFS.write_residual(jw, zz, 6, 8, mode)
    TFS.write_residual(tw, zz, 6, 8, mode)
    data = tw.to_bytes()
    assert data == jw.to_bytes()
    r = TReader(data + b"\x00")
    r.u(3)
    np.testing.assert_array_equal(TFS.read_residual(r, 6, 8, mode), zz)
