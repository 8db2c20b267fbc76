"""Object segmentation: alpha-plane extraction on int32 tensors.

Port of ``h264tpu/ops/segment.py`` (the reference's ``VideoSegment``,
FR/src/videosegment.c:150): a pixel is moving when it differs by >= 6 from
the frame 3 ahead or the frame 6 ahead; grayscale closing then opening with a
flat 3x3 element of height 10 (the ``cake``), a 3x3 median of the interior,
and binarization to {0, GREY_LEVELS} so that ``plane // GREY_LEVELS`` is the
object index the region coder uses.
"""

from __future__ import annotations

import torch

from .. import resolve_device

GREY_LEVELS = 255  # defines_enc.h:16


def _pad_shift_stack(x: torch.Tensor, kh: int, kw: int, fill: int):
    """[kh*kw, H, W] stack of the shifted copies of a constant-padded x."""
    ph, pw = kh // 2, kw // 2
    p = torch.nn.functional.pad(x, (pw, pw, ph, ph), value=fill)
    H, W = x.shape
    return torch.stack([p[dy:dy + H, dx:dx + W]
                        for dy in range(kh) for dx in range(kw)])


def gray_erosion(img: torch.Tensor, cake_value: int = 10, size: int = 3):
    """Grayscale erosion, flat square element (videosegment.c:13)."""
    st = _pad_shift_stack(img.to(torch.int32), size, size, 255)
    return torch.clamp(st.amin(dim=0) - cake_value, 0, 255)


def gray_dilation(img: torch.Tensor, cake_value: int = 10, size: int = 3):
    """Grayscale dilation, flat square element (videosegment.c:56)."""
    st = _pad_shift_stack(img.to(torch.int32), size, size, 0)
    return torch.clamp(st.amax(dim=0) + cake_value, 0, 255)


def median3x3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median of the interior (videosegment.c:104); border pixels keep
    their input value."""
    img = img.to(torch.int32)
    med = torch.sort(_pad_shift_stack(img, 3, 3, 0), dim=0).values[4]
    out = img.clone()
    out[1:-1, 1:-1] = med[1:-1, 1:-1]
    return out


def _segment_one(cur, fwd3, fwd6):
    moving = ((cur - fwd3).abs() >= 6) | ((cur - fwd6).abs() >= 6)
    plane = torch.where(moving, 255, 0).to(torch.int32)
    plane = gray_erosion(gray_dilation(plane))      # close
    plane = gray_dilation(gray_erosion(plane))      # open
    plane = median3x3(plane)
    return torch.where(plane >= 128, GREY_LEVELS, 0).to(torch.uint8)


def segment_sequence(y_frames, device=None) -> list:
    """Alpha plane [H, W] uint8 in {0, GREY_LEVELS} on ``device`` per luma
    frame (numpy or tensors); frame t is differenced against frames t+3 and
    t+6, the tail reusing the last frame."""
    device = resolve_device(device)
    ys = [torch.as_tensor(f).to(device=device, dtype=torch.int32)
          for f in y_frames]
    n = len(ys)
    return [_segment_one(ys[t], ys[min(t + 3, n - 1)], ys[min(t + 6, n - 1)])
            for t in range(n)]


def mb_region_labels(mask: torch.Tensor, mb: int = 16) -> torch.Tensor:
    """Per-macroblock label of an alpha plane: 0 all background, 1 all
    object, 2 both (block_enc.c:523-561).  [H//mb, W//mb] int32."""
    m = mask.to(torch.int32) // GREY_LEVELS
    H, W = m.shape
    s = m[:H - H % mb, :W - W % mb].reshape(H // mb, mb, W // mb, mb).sum(
        dim=(1, 3))
    return torch.where(s == 0, 0, torch.where(s == mb * mb, 1, 2)).to(
        torch.int32)
