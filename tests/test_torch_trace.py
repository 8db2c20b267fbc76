"""The port's tracer (``h264tpu_torch.trace``) and the benchmark's readers of
it (``benchmark/harness/program_trace.py``, ``benchmark/metrics``), on the
CPU: disabled spans cost nothing and record nothing, enabled spans nest
with their parents and frames, both encoders of the benchmark's cells mark
every frame taken and done and write the same bytes with tracing on and
off, and the readers find the window's sequences or return None."""

import threading

import pytest
import torch

from h264tpu_torch import trace

CELLS = {"fractal": "fractal_cif", "avc": "avc_cif"}
NEW_METRICS = ("fractal.recon_ms", "fractal.residual_ms", "fractal.intra_ms",
               "fractal.wait_ms", "avc.capture_ms", "avc.replay_ms",
               "avc.host_deblock_ms", "avc.wait_ms", "frame_latency_ms_p90")


@pytest.fixture(autouse=True)
def _clean_tracer():
    """Every test starts and ends with the tracer off and empty (importing
    the benchmark's helper switches it on)."""
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_disabled_span_is_the_shared_noop_and_records_nothing(monkeypatch):
    def clock():
        raise AssertionError("a disabled span read the clock")

    monkeypatch.setattr(trace.time, "time_ns", clock)
    monkeypatch.setattr(trace, "_Span", None)       # no span object is made
    s = trace.span("x", device="cpu", frame=(0, 0))
    assert s is trace.NOOP and trace.span("y") is s
    with s as inner:
        assert inner is s
    trace.frame_taken(0, 0)
    trace.frame_done(0, 0, "I")
    assert not trace.enabled()
    assert trace.records() == [] and trace.intervals() == []


def test_enabled_spans_nest_with_parents_and_frames():
    trace.enable()
    seq = trace.sequence()
    trace.frame_taken(seq, 0)
    with trace.span("outer"):
        with trace.span("inner", device="cpu"):
            pass
        with trace.span("other", frame=(seq, 7)):
            with trace.span("deep"):
                pass
    with trace.span("top"):
        pass
    trace.frame_done(seq, 0, "I")
    with trace.span("after"):
        pass
    spans = {r["name"]: r for r in trace.records() if r["kind"] == "span"}
    outer = spans["outer"]
    assert outer["parent"] is None and (outer["seq"], outer["frame"]) == (
        seq, 0)
    assert spans["inner"]["parent"] == outer["id"]
    assert spans["inner"]["device_ms"] is None      # no CUDA device
    assert spans["other"]["parent"] == outer["id"]
    assert spans["other"]["frame"] == 7 and spans["deep"]["frame"] == 7
    assert spans["deep"]["parent"] == spans["other"]["id"]
    assert spans["top"]["parent"] is None and spans["top"]["frame"] == 0
    assert spans["after"]["frame"] is None          # the frame was done
    assert outer["start_ns"] <= spans["inner"]["start_ns"] <= \
        spans["inner"]["end_ns"] <= outer["end_ns"]
    frames = [r for r in trace.records() if r["kind"] == "frame"]
    assert [(f["seq"], f["frame"], f["type"]) for f in frames] == [
        (seq, 0, "I")]
    assert [n for n, _, _ in trace.intervals()] == [
        "inner", "deep", "other", "outer", "top", "after"]
    assert trace.sequence() == seq + 1


def test_threads_keep_their_own_parents():
    trace.enable()
    seen = {}
    go = threading.Event()

    def worker():
        go.wait(5)
        with trace.span("worker"):
            pass

    t = threading.Thread(target=worker)
    t.start()
    with trace.span("main"):
        go.set()
        t.join(10)
    assert not t.is_alive()
    for r in trace.records():
        seen[r["name"]] = r
    assert seen["worker"]["parent"] is None


def _cell_codec(kind: str, n_frames: int = 4, seed: int = 3000000019):
    """The cell's system and codec at QCIF on the CPU, and a 1 I + 3 P clip
    of its traffic."""
    from benchmark.harness.registry import Registry
    reg = Registry()
    config = reg.config(CELLS[kind])
    settings = dict(config["settings"], width=176, height=144)
    traffic = reg.traffic("pan")
    pool = reg.generator(traffic["generator"]).make_pool(traffic, 144, 176,
                                                         seed)
    system = reg.system(config["system"])
    return system, system.build(settings, "cpu"), pool[0][:n_frames]


@pytest.fixture(scope="module")
def encoded():
    """Per encoder: ((results, stream) with tracing off, (results, stream)
    with it on, the records of the traced run)."""
    out = {}
    for kind in CELLS:
        system, codec, frames = _cell_codec(kind)
        trace.disable()
        off = system.encode(codec, iter(frames))
        trace.reset()
        trace.enable()
        on = system.encode(codec, iter(frames))
        trace.disable()
        out[kind] = (off, on, trace.records())
        trace.reset()
    return out


@pytest.mark.parametrize("kind", list(CELLS))
def test_stream_is_the_same_with_tracing_on_and_off(encoded, kind):
    (res_off, stream_off), (res_on, stream_on), _ = encoded[kind]
    assert stream_on == stream_off
    assert [r.bits for r in res_on] == [r.bits for r in res_off]


@pytest.mark.parametrize("kind", list(CELLS))
def test_one_frame_taken_and_done_per_frame(encoded, kind):
    _, (results, _), recs = encoded[kind]
    frames = [r for r in recs if r["kind"] == "frame"]
    assert [(f["seq"], f["frame"]) for f in frames] == [(0, i)
                                                        for i in range(4)]
    assert [f["type"] for f in frames] == [r.frame_type for r in results]
    assert [r.frame_type for r in results][1:] == ["P"] * 3
    assert all(f["start_ns"] <= f["end_ns"] for f in frames)
    spans = [r for r in recs if r["kind"] == "span"]
    names = {r["name"] for r in spans}
    want = {"fractal": {"fractal.frame", "fractal.upload", "fractal.intra",
                        "fractal.search", "fractal.recon", "fractal.residual",
                        "fractal.deblock", "fractal.entropy"},
            "avc": {"avc.frame", "avc.upload", "avc.search",
                    "avc.scan.load", "avc.scan.replay", "avc.wait",
                    "avc.host_deblock", "avc.prep", "avc.pack"}}[kind]
    # the untraced pass made the scan plans: the traced one only reuses
    # them, so no scan runs its first step eagerly
    assert names == want
    # every span belongs to a frame of the sequence and lies inside it
    by_frame = {f["frame"]: f for f in frames}
    for s in spans:
        f = by_frame[s["frame"]]
        assert s["seq"] == 0
        assert f["start_ns"] <= s["start_ns"] <= s["end_ns"] <= f["end_ns"]


def test_fractal_entropy_carries_the_pending_frame(encoded):
    _, _, recs = encoded["fractal"]
    spans = [r for r in recs if r["kind"] == "span"]
    entropy = [s for s in spans if s["name"] == "fractal.entropy"]
    frames = {s["frame"]: s for s in spans if s["name"] == "fractal.frame"}
    assert [s["frame"] for s in entropy] == [0, 1, 2, 3]
    for s in entropy[:-1]:
        # frame k is coded on the host after frame k + 1 was dispatched
        assert s["start_ns"] >= frames[s["frame"] + 1]["end_ns"]
    # the P step's stages nest in the frame's dispatch span
    ids = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"] in ("fractal.search", "fractal.recon",
                         "fractal.residual", "fractal.deblock"):
            parent = ids[s["parent"]]
            assert parent["name"] == "fractal.frame"
            assert parent["frame"] == s["frame"]


def _frame(seq, idx, ftype, t0=0, t1=1_000_000):
    return dict(kind="frame", name="frame", id=None, parent=None, seq=seq,
                frame=idx, start_ns=t0, end_ns=t1, device_ms=None,
                type=ftype)


def _span(name, seq, idx, device_ms=None, t0=0, t1=2_000_000):
    return dict(kind="span", name=name, id=1, parent=None, seq=seq,
                frame=idx, start_ns=t0, end_ns=t1, device_ms=device_ms)


def _clip(seq, types):
    return [_frame(seq, i, t) for i, t in enumerate(types)]


@pytest.mark.parametrize("case", ["window", "profiled_after", "cut_last_clip",
                                  "no_match", "only_warm"])
def test_window_rule_on_synthetic_sequences(case):
    from benchmark.harness import program_trace as PT
    warm = _clip(0, ["I", "P", "P"])
    window = _clip(1, ["I", "P", "P", "P"]) + _clip(2, ["I", "P"])
    profiled = _clip(3, ["I", "P", "P", "P", "P"])
    types = ["I", "P", "P", "P", "I", "P"]
    recs, want = {
        "window": (warm + window, {1, 2}),
        "profiled_after": (warm + window + profiled, {1, 2}),
        "cut_last_clip": (warm + _clip(1, ["I", "P", "P", "P"])
                          + _clip(2, ["I", "P", "P"]) + profiled, None),
        "no_match": (warm + _clip(1, ["I", "P", "P", "P", "P", "P"])
                     + profiled, None),
        "only_warm": (warm, None),
    }[case]
    assert PT.window({"types": types}, recs) == want


def _reg():
    from benchmark.harness.registry import Registry
    return Registry()


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_reader_returns_none_without_its_span(name, monkeypatch):
    from benchmark.harness import program_trace as PT
    reader = _reg().metric(name)
    rec = {"types": ["I", "P", "P"]}
    monkeypatch.setattr(PT, "records", lambda: [])
    assert reader.read(rec) is None
    # a window of frames without any span: only the frame reader reads
    recs = _clip(0, ["I", "P"]) + _clip(1, ["I", "P", "P"]) + [
        _span("fractal.search", 1, 1, 5.0), _span("avc.search", 1, 1, 5.0)]
    monkeypatch.setattr(PT, "records", lambda: recs)
    got = reader.read(rec)
    assert (got is None) == (name != "frame_latency_ms_p90")


@pytest.mark.parametrize("name,span,device,per", [
    ("fractal.recon_ms", "fractal.recon", True, 2),
    ("fractal.residual_ms", "fractal.residual", True, 2),
    ("fractal.intra_ms", "fractal.intra", True, 1),
    ("fractal.wait_ms", "fractal.wait", False, 3),
    ("avc.capture_ms", "avc.scan.capture", True, 3),
    ("avc.replay_ms", "avc.scan.replay", True, 3),
    ("avc.host_deblock_ms", "avc.host_deblock", False, 3),
    ("avc.wait_ms", "avc.wait", False, 3)])
def test_new_reader_divides_the_window_spans_by_its_frames(
        name, span, device, per, monkeypatch):
    from benchmark.harness import program_trace as PT
    reader = _reg().metric(name)
    assert reader.SOURCE == "program_span"
    types = ["IDR" if name.startswith("avc") else "I", "P", "P"]
    # 6 ms a span on the device, 2 ms on the host; the warm clip's and
    # the profiled clip's spans stay out
    recs = (_clip(0, types) + _clip(1, types) + _clip(2, types)
            + [_span(span, s, i, 6.0) for s in (0, 1, 2) for i in range(3)])
    monkeypatch.setattr(PT, "records", lambda: recs)
    ms = 6.0 if device else 2.0
    assert reader.read({"types": types}) == pytest.approx(3 * ms / per)
    if device:           # a span without device time reads nothing
        recs.append(_span(span, 1, 0, None))
        assert reader.read({"types": types}) is None


def test_scan_hit_reader_counts_captures_per_load(monkeypatch):
    from benchmark.harness import program_trace as PT
    reader = _reg().metric("avc.scan_hit_pct")
    assert (reader.SOURCE, reader.LAYER, reader.MOVES) == (
        "program_span", "AVC decision scan", "fps")
    types = ["IDR", "P", "P", "P"]
    # the warm clip misses twice, the window once in four scans
    recs = (_clip(0, types) + _clip(1, types)
            + [_span("avc.scan.capture", 0, i, 2.0) for i in (0, 1)]
            + [_span("avc.scan.load", s, i, 0.1) for s in (0, 1)
               for i in range(4)]
            + [_span("avc.scan.capture", 1, 3, 2.0)])
    monkeypatch.setattr(PT, "records", lambda: recs)
    assert reader.read({"types": types}) == pytest.approx(75.0)
    # a program without the load span (the parent of the plans) reads
    # nothing
    recs[:] = [r for r in recs if r["name"] != "avc.scan.load"]
    assert reader.read({"types": types}) is None


def test_frame_latency_is_the_p90_of_the_window_frames(monkeypatch):
    from benchmark.harness import program_trace as PT
    reader = _reg().metric("frame_latency_ms_p90")
    assert reader.MOVES == "frame_ms_p90"
    types = ["I"] + ["P"] * 9
    window = [_frame(1, i, t, 0, (i + 1) * 1_000_000)
              for i, t in enumerate(types)]
    recs = _clip(0, types) + window + [_frame(2, 0, "I", 0, 10 ** 12)]
    monkeypatch.setattr(PT, "records", lambda: recs)
    assert reader.read({"types": types}) == pytest.approx(9.1)


def test_helper_switches_the_tracer_on_when_imported():
    import importlib
    from benchmark.harness import program_trace as PT
    trace.disable()
    importlib.reload(PT)
    assert trace.enabled()


# ---- the hierarchical-B CABAC cell -----------------------------------------

HIERB_METRICS = ("avc.b_frame_ms", "avc.b_scan_ms", "avc.cabac_pack_ms",
                 "avc.b_wait_ms")
HIERB_TYPES = ["IDR", "B", "B", "B", "P", "B", "P"]


@pytest.fixture(scope="module")
def encoded_hierb():
    """The hierarchical-B cell's codec at 64x64 (the traffic's square cut
    to 32 pels) on a 7-frame clip: IDR, a GOP of 4 and a GOP cut to 2.
    ((results, stream) with tracing off, (results, stream) with it on, the
    records of the traced run)."""
    from benchmark.harness.registry import Registry
    reg = Registry()
    config = reg.config("avc_cif_hierb")
    settings = dict(config["settings"], width=64, height=64)
    traffic = dict(reg.traffic("pan"), square_size=32)
    frames = reg.generator(traffic["generator"]).make_pool(
        traffic, 64, 64, 3000000019)[0][:7]
    system = reg.system(config["system"])
    codec = system.build(settings, "cpu")
    trace.disable()
    off = system.encode(codec, iter(frames))
    trace.reset()
    trace.enable()
    on = system.encode(codec, iter(frames))
    trace.disable()
    recs = trace.records()
    trace.reset()
    return off, on, recs


def test_hierb_stream_is_the_same_with_tracing_on_and_off(encoded_hierb):
    (res_off, stream_off), (res_on, stream_on), _ = encoded_hierb
    assert stream_on == stream_off
    assert [r.bits for r in res_on] == [r.bits for r in res_off]


def test_hierb_one_frame_taken_and_done_per_frame(encoded_hierb):
    _, (results, _), recs = encoded_hierb
    frames = [r for r in recs if r["kind"] == "frame"]
    assert [(f["seq"], f["frame"]) for f in frames] == [(0, i)
                                                        for i in range(7)]
    assert [f["type"] for f in frames] == [r.frame_type for r in results] \
        == HIERB_TYPES
    # the GOP's frames are all taken before its anchor is done
    start = {f["frame"]: f["start_ns"] for f in frames}
    end = {f["frame"]: f["end_ns"] for f in frames}
    assert max(start[k] for k in (1, 2, 3, 4)) <= end[4]
    assert max(start[k] for k in (5, 6)) <= end[6]
    assert end[0] <= start[1]


def test_hierb_spans_once_per_picture_with_their_frames(encoded_hierb):
    _, _, recs = encoded_hierb
    spans = [r for r in recs if r["kind"] == "span"]
    assert all(s["seq"] == 0 for s in spans if s["name"] != "avc.prep")

    def frames_of(name):
        return [s["frame"] for s in spans if s["name"] == name]

    # decode order: IDR, anchor 4, reference B 2, leaves 1 and 3, anchor 6,
    # plain B 5
    assert frames_of("avc.b.frame") == [2, 1, 3, 5]
    assert frames_of("avc.b.wait") == [2, 1, 3, 5]
    assert frames_of("avc.wait") == [0, 4, 6]
    assert frames_of("avc.frame") == [0, 4, 6]
    # every picture's source upload, inside its device encode
    assert frames_of("avc.upload") == [0, 4, 2, 1, 3, 6, 5]
    assert frames_of("avc.pack") == [0, 4, 2, 1, 3, 6, 5]
    assert frames_of("avc.host_deblock") == [0, 4, 2, 1, 3, 6, 5]
    ids = {s["id"]: s for s in spans}
    for s in spans:
        if s["name"].startswith("avc.scan.") or s["name"] in ("avc.search",
                                                               "avc.upload"):
            parent = ids[s["parent"]]
            assert parent["name"] in ("avc.frame", "avc.b.frame")
            assert parent["frame"] == s["frame"]
    by_frame = {f["frame"]: f for f in recs if f["kind"] == "frame"}
    for s in spans:
        if s["frame"] is not None:
            f = by_frame[s["frame"]]
            assert f["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= f["end_ns"]


@pytest.mark.parametrize("name", HIERB_METRICS)
def test_hierb_reader_returns_none_without_its_span(name, monkeypatch):
    from benchmark.harness import program_trace as PT
    reader = _reg().metric(name)
    assert (reader.SOURCE, reader.MOVES) == ("program_span", "fps")
    rec = {"types": ["IDR", "B", "P"]}
    monkeypatch.setattr(PT, "records", lambda: [])
    assert reader.read(rec) is None
    recs = _clip(0, ["IDR", "P"]) + _clip(1, ["IDR", "B", "P"]) + [
        _span("avc.frame", 1, 2, 5.0), _span("avc.wait", 1, 2, None)]
    monkeypatch.setattr(PT, "records", lambda: recs)
    assert reader.read(rec) is None


@pytest.mark.parametrize("name,span,device,per", [
    ("avc.b_frame_ms", "avc.b.frame", True, 2),
    ("avc.cabac_pack_ms", "avc.pack", False, 4),
    ("avc.b_wait_ms", "avc.b.wait", False, 2)])
def test_hierb_reader_divides_the_window_spans_by_its_pictures(
        name, span, device, per, monkeypatch):
    from benchmark.harness import program_trace as PT
    reader = _reg().metric(name)
    types = ["IDR", "B", "B", "P"]
    # 6 ms a span on the device, 2 ms on the host, on every picture of
    # the warm, window and profiled clips; only the window's count
    recs = (_clip(0, types) + _clip(1, types) + _clip(2, types)
            + [_span(span, s, i, 6.0) for s in (0, 1, 2) for i in range(4)])
    monkeypatch.setattr(PT, "records", lambda: recs)
    ms = 6.0 if device else 2.0
    assert reader.read({"types": types}) == pytest.approx(4 * ms / per)


def test_hierb_scan_reader_takes_the_scans_of_b_pictures(monkeypatch):
    from benchmark.harness import program_trace as PT
    reader = _reg().metric("avc.b_scan_ms")
    types = ["IDR", "B", "B", "P"]

    def span(name, seq, idx, ms, sid, parent=None):
        return dict(_span(name, seq, idx, ms), id=sid, parent=parent)

    recs = _clip(0, types) + _clip(1, types) + [
        span("avc.frame", 1, 3, 50.0, 10),
        span("avc.scan.replay", 1, 3, 40.0, 11, 10),      # the anchor's
        span("avc.b.frame", 1, 1, 50.0, 20),
        span("avc.scan.eager", 1, 1, 1.0, 21, 20),
        span("avc.scan.capture", 1, 1, 2.0, 22, 20),
        span("avc.scan.replay", 1, 1, 7.0, 23, 20),
        span("avc.b.frame", 1, 2, 50.0, 30),
        span("avc.scan.replay", 1, 2, 10.0, 31, 30),
        span("avc.b.frame", 0, 1, 50.0, 40),               # warm clip
        span("avc.scan.replay", 0, 1, 99.0, 41, 40)]
    monkeypatch.setattr(PT, "records", lambda: recs)
    assert reader.read({"types": types}) == pytest.approx(20.0 / 2)
    recs.append(span("avc.scan.replay", 1, 2, None, 32, 30))
    assert reader.read({"types": types}) is None
