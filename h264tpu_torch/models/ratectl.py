"""Quadratic rate control (reference capability F18).

Faithful re-expression of the JM quadratic R-Q model used by the reference
(``FR/src/ratectl.c``: rc_init_seq :50, rc_init_pict :296,
updateQuantizationParameter :669, RCModelEstimator :1579, QP2Qstep :1799):

  R(Q) = X1 * MAD / Q  +  X2 * MAD / Q^2

X1/X2 are re-estimated each frame by least squares over a sliding window of
(R, Q, MAD) observations; MAD of the upcoming frame is predicted by a linear
model over the previous frame's MAD.  Per-frame QP moves at most +-2 (JM's
DDquant) and stays in [1, 51].

Update-mode family (``rc_mode``, JM 18.5 ``RCUpdateMode`` — the four
``updateQPRC0..3`` strategies of ``JM/lencod/src/rc_quadratic.c:1292``),
re-expressed for this codec's sequence encoder:

* mode 0 — JM's original JVT-G012 shape: only P frames consume and train
  the quadratic model; I frames take the recent-P average minus 2, B
  frames the last P QP plus 2 (JM's I/B offsets around the P layer).
* mode 1 — every coded frame runs through the model and trains it
  (this encoder's historical behavior, kept as the default).
* mode 2 — P frames as mode 0, but I/B frames still charge the virtual
  buffer and extend the MAD history (JM keeps per-type stats; here the
  non-P types inform the buffer/MAD state without polluting the P R-Q
  fit).
* mode 3 — mode 1 plus basic-unit granularity: :meth:`basic_unit_qps`
  splits the frame target over row-band basic units by predicted
  per-unit MAD and solves the same quadratic model per unit (the
  basic-unit layer of ``rc_quadratic.c``; on this framework a basic
  unit is one row-band slice, so per-unit QP travels in
  ``slice_qp_delta`` and the whole frame still encodes in ONE device
  dispatch — within-frame bit feedback, which a sequential per-BU CPU
  loop would use, is replaced by the previous frame's measured per-unit
  MAD distribution).

The port's own copy of ``h264tpu/models/ratectl.py`` (numpy only); it
imports nothing from ``h264tpu``.
"""

from __future__ import annotations

import numpy as np

_QSTEP0 = np.array([0.625, 0.6875, 0.8125, 0.875, 1.0, 1.125])


def qp2qstep(qp: int) -> float:
    return float(_QSTEP0[qp % 6] * (1 << (qp // 6)))


def qstep2qp(qstep: float) -> int:
    if qstep < qp2qstep(0):
        return 0
    if qstep > qp2qstep(51):
        return 51
    q = 0
    while qp2qstep(q + 1) <= qstep and q < 51:
        q += 1
    return q


class QuadraticRateControl:
    def __init__(self, target_bps: float, frame_rate: float, qp_init: int,
                 window: int = 20, rc_mode: int = 1, basic_units: int = 1):
        if rc_mode not in (0, 1, 2, 3):
            raise ValueError(f"rc_mode must be 0..3 (RCUpdateMode), "
                             f"got {rc_mode}")
        self.bits_per_frame = target_bps / frame_rate
        self.window = window
        self.rc_mode = rc_mode
        self.basic_units = basic_units     # row-band BUs per frame (mode 3)
        self.obs: list = []           # (bits, qstep, mad)
        self.mads: list = []
        self.prev_qp = qp_init
        self.p_qps: list = []         # recent P QPs (I/B derivation, mode 0/2)
        self.bu_mads = None           # prev frame per-BU MADs [basic_units]
        self.x1 = self.bits_per_frame * qp2qstep(qp_init)
        self.x2 = 0.0
        self.a1, self.a2 = 1.0, 0.0
        self.bits_balance = 0.0       # virtual buffer (spent - budget)

    # -- model estimation (RCModelEstimator / MADModelEstimator) ----------
    def _fit_rq(self):
        if len(self.obs) < 2:
            return
        obs = self.obs[-self.window:]
        A = np.array([[m / q, m / (q * q)] for (_, q, m) in obs])
        b = np.array([r for (r, _, _) in obs])
        sol, *_ = np.linalg.lstsq(A, b, rcond=None)
        if np.isfinite(sol).all() and sol[0] > 0:
            self.x1, self.x2 = float(sol[0]), float(sol[1])

    def _fit_mad(self):
        if len(self.mads) < 3:
            return
        m = np.array(self.mads[-self.window:])
        A = np.stack([m[:-1], np.ones_like(m[:-1])], axis=1)
        sol, *_ = np.linalg.lstsq(A, m[1:], rcond=None)
        if np.isfinite(sol).all():
            self.a1, self.a2 = float(sol[0]), float(sol[1])

    def predicted_mad(self) -> float:
        if not self.mads:
            return 1.0
        return max(0.1, self.a1 * self.mads[-1] + self.a2)

    # -- per-frame API ------------------------------------------------------
    def _solve_qstep(self, target: float, mad: float) -> float:
        """Qstep solving X1*mad/Q + X2*mad/Q^2 = target."""
        c1, c2 = self.x1 * mad, self.x2 * mad
        if abs(c2) < 1e-9:
            return c1 / target
        disc = c1 * c1 + 4 * c2 * target
        qstep = (2 * c2 / (np.sqrt(max(disc, 0.0)) - c1) if disc > 0
                 else c1 / target)
        return qstep if qstep > 0 else c1 / target

    def _frame_target(self) -> float:
        # target: per-frame budget minus a fraction of the buffer imbalance
        return max(
            self.bits_per_frame
            - 0.5 * self.bits_balance / max(len(self.obs), 1),
            self.bits_per_frame * 0.1)

    def frame_qp(self, ftype: str = "P") -> int:
        """QP for the next frame.  ``ftype`` in {"P", "I"/"IDR", "B"}; in
        rc_mode 0/2 the non-P types derive from the P layer instead of the
        model (updateQPRC0 semantics)."""
        if self.rc_mode in (0, 2) and ftype != "P":
            if ftype in ("I", "IDR"):
                base = (int(round(np.mean(self.p_qps[-self.window:]))) - 2
                        if self.p_qps else self.prev_qp)
            else:                        # B
                base = (self.p_qps[-1] if self.p_qps else self.prev_qp) + 2
            return int(np.clip(base, 1, 51))
        t = self._frame_target()
        qstep = self._solve_qstep(t, self.predicted_mad())
        qp = qstep2qp(abs(qstep))
        qp = int(np.clip(qp, self.prev_qp - 2, self.prev_qp + 2))
        return int(np.clip(qp, 1, 51))

    def basic_unit_qps(self, n_units: int = None, ftype: str = "P"):
        """Per-basic-unit QPs for the upcoming frame (mode-3 basic-unit
        layer).  JM splits the remaining frame budget equally over the
        remaining basic units and solves the model with each unit's own
        predicted MAD (``rc_quadratic.c`` BU loop); batched here: every
        unit gets an equal share of the frame target, its MAD comes from
        the previous frame's measured per-unit MADs
        (:meth:`update_basic_units`), so high-activity bands take higher
        QP.  The frame-level model R(Q)=X1*MAD/Q is a mean-MAD model, so
        the per-unit equal-share solve reduces to solving the FRAME
        target with the unit's MAD.  Unit QPs stay within +-2 of the
        frame QP (JM clips consecutive-BU QP steps similarly)."""
        n = self.basic_units if n_units is None else n_units
        fqp = self.frame_qp(ftype)
        if self.bu_mads is None or len(self.bu_mads) != n:
            return np.full(n, fqp, np.int64)
        mads = np.maximum(np.asarray(self.bu_mads, np.float64), 0.1)
        t = self._frame_target()
        qps = np.empty(n, np.int64)
        for i in range(n):
            qps[i] = qstep2qp(abs(self._solve_qstep(t, mads[i])))
        return np.clip(qps, max(fqp - 2, 1), min(fqp + 2, 51))

    def update(self, bits_used: int, qp_used: int, mad: float,
               ftype: str = "P"):
        train = ftype == "P" or self.rc_mode in (1, 3)
        if train:
            self.obs.append((float(bits_used), qp2qstep(qp_used),
                             max(mad, 0.1)))
            self.mads.append(max(mad, 0.1))
            self.prev_qp = qp_used
        elif self.rc_mode == 2:
            # I/B inform MAD history + buffer, not the P R-Q fit
            self.mads.append(max(mad, 0.1))
        self.bits_balance += bits_used - self.bits_per_frame
        if ftype == "P":
            self.p_qps.append(qp_used)
        if train:
            self._fit_rq()
            self._fit_mad()

    def update_basic_units(self, mads):
        """Record the previous frame's measured per-basic-unit MADs
        (mode 3; one value per row-band unit)."""
        self.bu_mads = list(mads)
