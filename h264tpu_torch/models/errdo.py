"""Loss-aware encoding: K-decoder channel simulation and the closed-form
expected-drift recursion (port of ``h264tpu/models/errdo.py``).

The encoder runs K simulated decoder copies, each losing every macroblock
independently with probability p; a lost MB is concealed by the co-located
copy from that decoder's own previous reconstruction (frame-copy
concealment, ``FR/src/erc_do_p.c``; JM ``errdo.c``, ``FR/src/decoder.c:361``
``UpdateDecoders``).  The per-MB distortion between the encoder's
reconstruction and the simulated decoders estimates the channel-induced
drift; MBs whose expected drift exceeds a threshold can be forced intra.

The K decoders are a leading batch axis [K, H, W] on the device.  Loss
patterns come from the port's own Threefry (``utils/prng.py``) with
``jax.random``'s semantics, so a seed loses the same MBs as in the JAX
package.  The float32 reductions add in the order XLA's CPU backend adds
(one sequential pass over the reduced elements in row-major order, a mean
multiplies by the float32 reciprocal of its count), and the recursion's
multiply-add is fused where XLA fuses it (``_fma``), so the drift maps are
bit-equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.fractal import _fma
from ..utils import prng

MB = 16
_F32 = torch.float32


def _int32(plane, device) -> torch.Tensor:
    if isinstance(plane, torch.Tensor):
        return plane.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(plane)).to(device).to(torch.int32)


def _sequential_sum(terms) -> torch.Tensor:
    """float32 sum of ``terms`` (an iterable of equal-shape tensors) added
    one after the other, as XLA's CPU loop adds a reduction."""
    acc = None
    for t in terms:
        acc = t.clone() if acc is None else acc + t
    return acc


def _mb_err_sum(sq: torch.Tensor) -> torch.Tensor:
    """float32 sum over K and each MB's pixels of ``sq`` [K, H, W] int64
    squared errors, in XLA's order (k, row, column).  While a whole sum
    stays below 2^24 every partial sum is an exact integer, so the float32
    result is the exact sum; only the MBs past it are added term by term."""
    K, H, W = sq.shape
    e = sq.reshape(K, H // MB, MB, W // MB, MB)
    exact = e.sum(dim=(0, 2, 4))
    if int(exact.max()) < 1 << 24:
        return exact.to(_F32)
    ef = e.to(_F32)
    return _sequential_sum(ef[k, :, dy, :, dx] for k in range(K)
                           for dy in range(MB) for dx in range(MB))


def _sim_step(sim_refs, enc_recon, key, p_loss: float):
    """One frame of channel simulation.

    sim_refs  [K, H, W] int32 — each decoder's previous reconstruction
    enc_recon [H, W] int32    — encoder-side reconstruction of the frame
    Returns (new_sim [K, H, W], mb_drift [H/16, W/16] float32 mean SSE per
    pixel, averaged over the decoders)."""
    K, H, W = sim_refs.shape
    lost = prng.bernoulli(key, p_loss, (K, H // MB, W // MB), sim_refs.device)
    lost_pix = lost.repeat_interleave(MB, 1).repeat_interleave(MB, 2)
    new_sim = torch.where(lost_pix, sim_refs, enc_recon[None])
    d = (new_sim - enc_recon[None]).to(torch.int64)
    total = _mb_err_sum(d * d)
    return new_sim, total * float(np.float32(1.0 / K)) / (MB * MB)


class KDecoderSim:
    """K simulated decoders with per-MB Bernoulli loss and frame-copy
    concealment (decoder.c:361 ``UpdateDecoders`` semantics).
    ``device``: None is the CUDA card (raises without one)."""

    def __init__(self, k: int, p_loss: float, height: int, width: int,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.k = k
        self.p_loss = float(p_loss)
        self.height, self.width = height, width
        self.key = prng.prng_key(seed)
        self.sim = None    # [K, H, W] int32

    def reset(self, recon):
        """IDR: every decoder receives the intra frame intact apart from its
        own losses of THIS frame (an IDR MB lost is still concealed)."""
        self.sim = _int32(recon, self.device)[None].expand(
            self.k, self.height, self.width).contiguous()

    def step(self, enc_recon):
        """Advance all decoders by one frame; returns the expected per-MB
        drift map [H/16, W/16] float32 (mean squared error per pixel vs the
        encoder's reconstruction, averaged over decoders)."""
        enc_recon = _int32(enc_recon, self.device)
        if self.sim is None:
            self.reset(enc_recon)
        self.key, sub = prng.split(self.key)
        self.sim, drift = _sim_step(self.sim, enc_recon, sub, self.p_loss)
        return drift

    def force_intra_mask(self, drift, threshold: float):
        """MBs whose expected channel drift exceeds ``threshold`` (mean SSE
        per pixel) — a forced-intra mask for the frame encoder."""
        return drift > threshold


def _mhyp_step(exp_drift, prev_recon, enc_recon, intra_pix, p_loss: float,
               leak: float):
    """One frame of the expected-drift recursion:
    p*(conceal + E) + (1-p)*where(intra, 0, leak*E), the first product
    fused with the sum as XLA fuses it."""
    conceal = (enc_recon - prev_recon).to(_F32) ** 2
    zero = torch.zeros((), dtype=_F32, device=exp_drift.device)
    propagated = torch.where(intra_pix, zero,
                             float(np.float32(leak)) * exp_drift)
    p = torch.tensor(float(np.float32(p_loss)), dtype=_F32,
                     device=exp_drift.device)
    return _fma(p, conceal + exp_drift,
                float(np.float32(1.0 - p_loss)) * propagated)


class MultiHypothesisDrift:
    """Deterministic multi-hypothesis expected decoder distortion
    (JM ``errdo_dist_mhyp.c``).

    Tracks the per-pixel EXPECTED squared drift in closed form over each
    MB's loss hypotheses: lost this frame (probability p — concealment error
    on top of the drift the concealment source carried), or received
    (probability 1-p — the prediction propagates the reference's expected
    drift, attenuated by ``leak``, except intra MBs, which cut it).

    E_n = p * (conceal_sse + E_{n-1}) + (1-p) * leak * E_{n-1} * !intra

    ``device``: None is the CUDA card (raises without one)."""

    def __init__(self, p_loss: float, height: int, width: int,
                 leak: float = 0.9, device=None):
        self.device = resolve_device(device)
        self.p_loss = float(p_loss)
        self.leak = float(leak)
        self.height, self.width = height, width
        self.exp = torch.zeros((height, width), dtype=_F32, device=self.device)
        self.prev = None

    def reset(self, recon):
        """IDR intact-by-contract start: drift only from this frame's own
        potential loss (concealed from the drifting previous state)."""
        recon = _int32(recon, self.device)
        if self.prev is None:
            self.exp = torch.zeros((self.height, self.width), dtype=_F32,
                                   device=self.device)
        else:
            conceal = (recon - self.prev).to(_F32) ** 2
            self.exp = float(np.float32(self.p_loss)) * (conceal + self.exp)
        self.prev = recon

    def step(self, enc_recon, mb_intra=None):
        """Advance one P frame; returns the expected per-MB drift map
        [H/16, W/16] float32 (mean expected SSE per pixel).  ``mb_intra``
        [H/16, W/16] bool: MBs coded intra this frame."""
        enc_recon = _int32(enc_recon, self.device)
        if self.prev is None:
            self.reset(enc_recon)
        else:
            if mb_intra is None:
                intra_pix = torch.zeros((self.height, self.width),
                                        dtype=torch.bool, device=self.device)
            else:
                intra_pix = torch.as_tensor(np.asarray(mb_intra, bool)).to(
                    self.device).repeat_interleave(MB, 0).repeat_interleave(
                        MB, 1)
            self.exp = _mhyp_step(self.exp, self.prev, enc_recon, intra_pix,
                                  self.p_loss, self.leak)
            self.prev = enc_recon
        H, W = self.height, self.width
        e = self.exp.reshape(H // MB, MB, W // MB, MB)
        total = _sequential_sum(e[:, dy, :, dx] for dy in range(MB)
                                for dx in range(MB))
        return total / (MB * MB)

    def force_intra_mask(self, drift, threshold: float):
        """Same contract as :meth:`KDecoderSim.force_intra_mask`."""
        return drift > threshold
