"""The fractal codec (``h264tpu_torch.models.fractal_codec.FractalCodec``)
as the benchmark drives and judges it."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.window import sample_frames
from benchmark.reference import fractal_ref as REF


def build(settings: dict, device):
    from h264tpu_torch.models.fractal_codec import FractalCodec
    from h264tpu_torch.utils.config import CodecConfig, FractalConfig
    s = dict(settings)
    fractal = FractalConfig(**s.pop("fractal"))
    return FractalCodec(CodecConfig(fractal=fractal, **s), device=device)


def encode(codec, frames):
    return codec.encode_sequence(frames)


def reset_counters(codec):
    pass


def counters(codec) -> dict:
    return {}


def output(results, stream) -> dict:
    """What the check needs of one clip, on the host."""
    return dict(stream=stream, frame_bytes=[r.bits // 8 for r in results],
                types=[r.frame_type for r in results],
                bits=[r.bits for r in results],
                recon=[tuple(np.array(p, np.uint8) for p in r.recon)
                       for r in results])


def _bounds(settings: dict):
    fr = settings["fractal"]
    return (int(round(fr["min_alpha"] * 100)), int(round(fr["max_alpha"] * 100)),
            int(round(fr["min_beta"])), int(round(fr["max_beta"])))


def check(settings: dict, spec: dict, clips, sources, rng, control=False):
    """Readings of the window's output: {name: value}.

    ``decode_mismatch_px``: pixels of the sampled frames where the frozen
    decoder's picture differs from the encoder's reconstruction.
    ``search_gap``: the widest per-pixel squared-error gap of a sampled leaf
    above the best candidate of the full search.  ``residual_mismatch``:
    decoded residual levels of the sampled P frames that differ from the
    residual coding of source minus fractal prediction.
    ``split_violations``: sampled macroblocks whose quadtree the split rule
    does not allow.  With ``control`` the control takes the program's
    place: the frozen decoder's picture made without the in-loop filter as
    the reconstruction, and the search recomputed in bfloat16 for the same
    leaves."""
    fr = settings["fractal"]
    mismatch, gaps, n_leaves = 0, [], 0
    res_bad = split_bad = n_mbs = 0
    hdrs = {}
    for c, k in sample_frames(clips, int(spec["frames"]), rng):
        clip = clips[c]
        if c not in hdrs:
            hdrs[c] = REF.split_payloads(clip["stream"], clip["frame_bytes"])
        hdr, payloads = hdrs[c]
        ref = clip["recon"][k - 1] if k else None
        details = []
        planes, maps = REF.decode_frame(hdr, payloads[k], ref,
                                        details=details)
        judged = clip["recon"][k]
        if control:
            judged, _ = REF.decode_frame(hdr, payloads[k], ref,
                                         loop_filter=False)
        mismatch += sum(int(np.count_nonzero(a != b))
                        for a, b in zip(planes, judged))
        if maps is None:
            continue
        src = sources[c][k]
        qps = (settings["qp"],) + (REF.T.chroma_qp(settings["qp"]),) * 2
        for i in range(3):
            res_bad += REF.residual_mismatch(src[i], details[i]["frec"],
                                             details[i]["zz"], qps[i], i == 0)
        searches = [REF.LeafSearch(src[i], ref[i], fr["search_range"],
                                   fr["use_halfpel_refs"], _bounds(settings))
                    for i in range(3)]
        leaves = [(i, leaf) for i in range(3) for leaf in REF.leaves(maps[i])]
        pick = rng.choice(len(leaves), size=min(int(spec["leaves_per_frame"]),
                                                 len(leaves)), replace=False)
        for j in pick:
            i, (y0, x0, bh, bw, chosen) = leaves[j]
            gaps.append(searches[i].gap(
                y0, x0, bh, bw, None if control else chosen,
                torch.bfloat16 if control else np.float64))
        n_leaves += len(pick)
        mbs = [(i, my, mx) for i in range(3)
               for my in range(searches[i].H // 16)
               for mx in range(searches[i].W // 16)]
        for j in rng.choice(len(mbs), size=min(int(spec["mbs_per_frame"]),
                                               len(mbs)), replace=False):
            i, my, mx = mbs[j]
            split_bad += not REF.split_rule(
                searches[i], ref[i], my, mx, np.asarray(maps[i]["shape"]),
                fr["tol_16"], fr["tol_8"], fr["chun_lo"], fr["chun_hi"])
            n_mbs += 1
    return dict(decode_mismatch_px=mismatch,
                search_gap=max(gaps) if gaps else float("inf"),
                residual_mismatch=res_bad, split_violations=split_bad,
                leaves_checked=n_leaves, mbs_checked=n_mbs)
