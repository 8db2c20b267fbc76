"""Explicit sequence description files (J2).

Reference twin: ``JM/lencod/src/explicit_seq.c`` (ReadExplicitSeqFile /
ExplicitUpdateImgParams) with the file shape of
``JM/bin/explicit_seq.cfg``::

    Sequence {
    FrameCount : 19
    Frame
    {
    SeqNumber : 0
    SliceType : I
    IDRPicture : 1
    Reference : 1
    }
    ...

Frames are listed in CODING order; ``SeqNumber`` is the display index.
:func:`parse_explicit_seq` turns the text into entry dicts;
:func:`encode_explicit_seq` drives an :class:`~h264tpu.avc.codec.AVCCodec`
parameter set through an arbitrary I/P/B coding order built from the
entries (IDR or open-GOP I, P from the most recent reference, non-reference
B between its nearest coded references — the populate_frm_struct shapes the
host codec expresses).

The port's own copy of ``h264tpu/avc/explicit_seq.py`` (host numpy, as
there); it imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

from .params import AVCParams, assemble_stream
from .slice_enc import encode_i_frame, encode_p_frame, encode_b_frame
from .deblock import DeblockContext, deblock_frame
from .inter import RefPlanes
from .codec import AVCFrameResult


def parse_explicit_seq(text: str):
    """Parse an explicit-sequence description -> list of entries in coding
    order: dict(seq_number, slice_type in {"I","P","B"}, idr, reference)."""
    toks = text.replace("{", " { ").replace("}", " } ").replace(":", " : ")
    words = toks.split()
    entries = []
    cur = None
    i = 0
    frame_count = None
    while i < len(words):
        w = words[i]
        if w == "Frame":
            cur = {}
        elif w == "}" and cur is not None:
            if "seq_number" in cur:
                entries.append(cur)
            cur = None
        elif i + 2 < len(words) and words[i + 1] == ":":
            key, val = w, words[i + 2]
            i += 2
            if key == "FrameCount":
                frame_count = int(val)
            elif cur is not None:
                if key == "SeqNumber":
                    cur["seq_number"] = int(val)
                elif key == "SliceType":
                    if val not in ("I", "P", "B"):
                        raise ValueError(f"SliceType {val}")
                    cur["slice_type"] = val
                elif key == "IDRPicture":
                    cur["idr"] = bool(int(val))
                elif key == "Reference":
                    cur["reference"] = bool(int(val))
        i += 1
    if frame_count is not None and len(entries) > frame_count:
        entries = entries[:frame_count]
    if not entries or entries[0].get("slice_type") != "I" \
            or not entries[0].get("idr"):
        raise ValueError("explicit sequence must open with an IDR I frame")
    return entries


def parse_explicit_seq_file(path) -> list:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return parse_explicit_seq(f.read())


def encode_explicit_seq(frames, p: AVCParams, seq, search_range: int = 16,
                        use_satd: bool = True, qp: int = None):
    """Encode ``frames`` (display order) through the explicit coding
    order ``seq`` (entries from :func:`parse_explicit_seq`).

    Supported structures: IDR I, non-IDR reference I (open-GOP point),
    P referencing the most recently coded reference picture, and
    NON-reference B predicting from its nearest coded references on both
    display sides (spatial direct, list1 = forward).  Reference B
    entries raise.  Returns (results in display order, Annex-B stream in
    coding order)."""
    qp = p.qp if qp is None else qp
    if p.cropped:
        raise NotImplementedError("the host encoder codes whole "
                                  "macroblocks: no cropping")
    if any(e["slice_type"] == "B" for e in seq):
        if p.poc_type != 0:
            raise ValueError("B entries need AVCParams(poc_type=0)")
        if p.num_ref_frames < 2:
            raise ValueError("B entries need num_ref_frames >= 2")
    frames = list(frames)
    n = len(frames)
    results = [None] * n
    slices = []
    coded = {}                    # display idx -> dict(rp, motion, rec8)
    ref_order = []                # display idxs of reference pics, newest 1st
    frame_num = 0
    for e in seq:
        d = e["seq_number"]
        if not 0 <= d < n:
            raise ValueError(f"SeqNumber {d} outside the {n} input frames")
        yuv = frames[d]
        st = e["slice_type"]
        ctx = DeblockContext(p.mb_w, p.mb_h, qp, p.chroma_qp_offset)
        if st == "I":
            idr = bool(e.get("idr"))
            rbsp, rec, stats = encode_i_frame(
                yuv, p, qp=qp, frame_num=0 if idr else frame_num, idr=idr,
                poc_lsb=2 * d)
            if idr:
                frame_num = 1
                ref_order = []
            else:
                frame_num = (frame_num + 1) % (1 << p.log2_max_frame_num)
            motion = (np.zeros((p.mb_h * 4, p.mb_w * 4, 2), np.int64),
                      np.full((p.mb_h * 4, p.mb_w * 4), -1, np.int64))
            slices.append((idr, rbsp, 3))
            ftype = "IDR" if idr else "I"
        elif st == "P":
            if not e.get("reference", True):
                raise NotImplementedError("non-reference P entries")
            if not ref_order:
                raise ValueError("P frame before any reference picture")
            ref_list = [coded[ref_order[0]]["rp"]]
            rbsp, rec, pctx, stats = encode_p_frame(
                yuv, ref_list, p, qp=qp, frame_num=frame_num,
                sr=search_range, use_satd=use_satd, poc_lsb=2 * d)
            ctx.mb_intra = pctx["mb_intra"]
            ctx.nnz = pctx["nnz"]
            ctx.mv = pctx["mvf"].mv
            ctx.ref = pctx["mvf"].ref
            motion = (pctx["mvf"].mv.copy(), pctx["mvf"].ref.copy())
            slices.append((False, rbsp, 2))
            frame_num = (frame_num + 1) % (1 << p.log2_max_frame_num)
            ftype = "P"
        else:                      # B
            if e.get("reference"):
                raise NotImplementedError("reference B entries")
            back = [i for i in coded if i < d and coded[i]["ref"]]
            fwd = [i for i in coded if i > d and coded[i]["ref"]]
            if not back or not fwd:
                raise ValueError(f"B frame {d} lacks coded references on "
                                 "both display sides")
            b0, b1 = max(back), min(fwd)
            rbsp, rec, bctx, stats = encode_b_frame(
                yuv, [coded[b0]["rp"]], [coded[b1]["rp"]],
                coded[b1]["motion"], p, qp=qp, frame_num=frame_num,
                poc_lsb=2 * d, sr=search_range, use_satd=use_satd,
                ref_pocs0=[2 * b0], ref_pocs1=[2 * b1])
            ctx.mb_intra = bctx["mb_intra"]
            ctx.nnz = bctx["nnz"]
            ctx.mv = bctx["mv"]
            ctx.ref = bctx["ref"]
            ctx.mv1 = bctx["mv1"]
            ctx.ref1 = bctx["ref1"]
            motion = None
            slices.append((False, rbsp, 0))
            ftype = "B"
        if p.deblock:
            rec = deblock_frame(*rec, ctx)
        rec8 = tuple(np.asarray(pl, np.uint8) for pl in rec)
        is_ref = bool(e.get("reference", st != "B"))
        coded[d] = dict(rp=RefPlanes(*rec) if is_ref else None,
                        motion=motion, rec8=rec8, ref=is_ref)
        if is_ref:
            ref_order.insert(0, d)
            ref_order = ref_order[:max(p.num_ref_frames, 1)]
        mse = ((np.asarray(yuv[0], np.float64) - rec8[0]) ** 2).mean()
        results[d] = AVCFrameResult(
            frame_type=ftype, bits=stats["bits"],
            psnr_y=99.99 if mse == 0 else
            float(10 * np.log10(255.0 ** 2 / mse)), recon=rec8)
    return results, assemble_stream(p, slices)
