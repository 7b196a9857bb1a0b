"""Mergeable quantile sketch for approx_percentile_cont / approx_median.

Own copy of `parseable_tpu/query/sketch.py` (pure numpy), so that the port's
engines keep the JAX package's quantile semantics bit for bit:

- EXACT below 1024 values per group: raw f64 values, quantiles via
  np.quantile (linear interpolation, as percentile_cont).
- Log-scale histogram beyond: 1024 bins per sign over |v| in
  [2^-40, 2^40) plus an exact-zero count, ~5.6% worst-case relative
  error per value (2^(80/1024) per bin, interpolated), constant memory;
  exact tracked min/max clamp the tails so p0/p100 are exact.
- Merge is histogram addition (small sides fold in), so block partials
  and device histograms (`from_device_hist`, the `DEVICE_NB` layout the
  GPU engine's percentile kernel fills) compose associatively.
"""

from __future__ import annotations

import numpy as np

SMALL = 1024  # raw values kept before folding into the histogram
BINS = 1024
LOG_LO = -40.0  # log2 of the smallest binned magnitude
LOG_HI = 40.0
_SCALE = BINS / (LOG_HI - LOG_LO)


def _bin_of(mag_log2: np.ndarray) -> np.ndarray:
    return np.clip(
        ((mag_log2 - LOG_LO) * _SCALE).astype(np.int64), 0, BINS - 1
    )


def _bin_edges(idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    lo = idx / _SCALE + LOG_LO
    return lo, lo + 1.0 / _SCALE


# Flat device-histogram layout (query/executor_cuda.py device percentiles):
# [0, BINS) negative bins (indexed by |v| bin), [BINS, 2*BINS) positive
# bins, [2*BINS] exact-zero count — one f32 row per group, mergeable by
# addition and convertible to a QuantileSketch via `from_device_hist`.
DEVICE_NB = 2 * BINS + 1


class QuantileSketch:
    __slots__ = ("small", "pos", "neg", "zeros", "vmin", "vmax", "count")

    def __init__(self) -> None:
        self.small: list[np.ndarray] | None = []  # None once folded
        self.pos: np.ndarray | None = None  # f64 [BINS]
        self.neg: np.ndarray | None = None
        self.zeros = 0.0
        self.vmin = np.inf
        self.vmax = -np.inf
        self.count = 0

    # ------------------------------------------------------------------ build

    def update(self, values: np.ndarray) -> None:
        """Fold a block's non-null values (any float/int ndarray) in."""
        v = np.asarray(values, np.float64)
        v = v[~np.isnan(v)]
        if len(v) == 0:
            return
        self.count += len(v)
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))
        if self.small is not None:
            self.small.append(v)
            if sum(len(a) for a in self.small) > SMALL:
                self._fold()
            return
        self._bin(v)

    def _fold(self) -> None:
        vals = np.concatenate(self.small) if self.small else np.empty(0)
        self.small = None
        self.pos = np.zeros(BINS)
        self.neg = np.zeros(BINS)
        if len(vals):
            self._bin(vals)

    def _bin(self, v: np.ndarray) -> None:
        zero = v == 0.0
        self.zeros += float(zero.sum())
        for sign, hist in ((1, self.pos), (-1, self.neg)):
            sel = (v > 0) if sign > 0 else (v < 0)
            if not sel.any():
                continue
            # clip BEFORE the int cast: +/-inf (natural in log data from
            # casts/division) must land in the extreme bins, not wrap
            # through undefined int64 conversion into bin 0
            mags = np.clip(
                np.log2(np.abs(v[sel])), LOG_LO, LOG_HI - 1e-9
            )
            np.add.at(hist, _bin_of(mags), 1.0)

    @classmethod
    def from_device_hist(
        cls, hist: np.ndarray, vmin: float, vmax: float
    ) -> "QuantileSketch":
        """One group's device histogram row (DEVICE_NB layout) -> sketch in
        histogram mode (device blocks always bin; exactness below SMALL is a
        host-path property only)."""
        sk = cls()
        sk.small = None
        sk.neg = np.asarray(hist[:BINS], np.float64).copy()
        sk.pos = np.asarray(hist[BINS : 2 * BINS], np.float64).copy()
        sk.zeros = float(hist[2 * BINS])
        sk.count = int(round(float(hist.sum())))
        if sk.count:
            sk.vmin = float(vmin)
            sk.vmax = float(vmax)
        return sk

    def copy(self) -> "QuantileSketch":
        """Deep-enough copy: safe to merge into without mutating the source
        (raw-value arrays are shared but never mutated in place)."""
        sk = QuantileSketch()
        sk.small = list(self.small) if self.small is not None else None
        sk.pos = None if self.pos is None else self.pos.copy()
        sk.neg = None if self.neg is None else self.neg.copy()
        sk.zeros = self.zeros
        sk.vmin = self.vmin
        sk.vmax = self.vmax
        sk.count = self.count
        return sk

    # ------------------------------------------------------------------ merge

    def merge(self, other: "QuantileSketch") -> None:
        if other.count == 0:
            return
        self.count += other.count
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        if self.small is not None and other.small is not None:
            self.small.extend(other.small)
            if sum(len(a) for a in self.small) > SMALL:
                self._fold()
            return
        if self.small is not None:
            self._fold()
        if other.small is not None:
            for a in other.small:
                self._bin(a)  # bins + zero-counts other's raw values
            return
        self.pos += other.pos
        self.neg += other.neg
        self.zeros += other.zeros

    # ---------------------------------------------------------------- queries

    def quantile(self, p: float) -> float | None:
        if self.count == 0:
            return None
        p = min(max(p, 0.0), 1.0)
        if self.small is not None:
            vals = (
                np.concatenate(self.small) if self.small else np.empty(0)
            )
            if len(vals) == 0:
                return None
            return float(np.quantile(vals, p, method="linear"))
        # histogram walk: negatives (descending magnitude), zeros, positives
        # (the vectorized device-readback twin is hist_quantile below —
        # keep their interpolation semantics in lockstep)
        target = p * (self.count - 1)
        neg_counts = self.neg[::-1]  # most-negative first
        blocks: list[tuple[float, int, int]] = []  # (count, sign, bin_idx)
        for c, idx in zip(neg_counts, range(BINS - 1, -1, -1)):
            if c:
                blocks.append((float(c), -1, idx))
        if self.zeros:
            blocks.append((float(self.zeros), 0, 0))
        for idx in range(BINS):
            if self.pos[idx]:
                blocks.append((float(self.pos[idx]), 1, idx))
        acc = 0.0
        for c, sign, idx in blocks:
            if acc + c > target:
                frac = (target - acc) / c
                if sign == 0:
                    return 0.0
                lo, hi = _bin_edges(np.array([idx]))
                lo_v, hi_v = 2.0 ** lo[0], 2.0 ** hi[0]
                if sign < 0:
                    # negative bins walk from -hi_v toward -lo_v
                    val = -(hi_v - frac * (hi_v - lo_v))
                else:
                    val = lo_v + frac * (hi_v - lo_v)
                return float(min(max(val, self.vmin), self.vmax))
            acc += c
        return self.vmax if self.vmax > -np.inf else None


def hist_quantile(
    hists: np.ndarray,
    vmins: np.ndarray,
    vmaxs: np.ndarray,
    p: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized quantiles over device histogram rows.

    `hists` is (n, DEVICE_NB) in the device layout; returns (values f64[n],
    valid bool[n]). Semantically identical to QuantileSketch.quantile on a
    folded sketch: blocks walk in ascending value order (negatives by
    descending magnitude, zeros, positives), linear interpolation inside the
    landing bin, result clamped to the group's exact [vmin, vmax].
    """
    n = hists.shape[0]
    p = min(max(float(p), 0.0), 1.0)
    counts = hists.sum(axis=1)
    valid = counts > 0
    if not valid.any():
        return np.zeros(n), valid
    # ascending-value order: reversed neg bins | zeros | pos bins
    ordered = np.concatenate(
        [hists[:, BINS - 1 :: -1], hists[:, 2 * BINS : 2 * BINS + 1], hists[:, BINS : 2 * BINS]],
        axis=1,
    ).astype(np.float64)
    cum = np.cumsum(ordered, axis=1)
    target = p * (counts - 1.0)
    # first ordered block where the cumulative count exceeds the target
    j = np.argmax(cum > target[:, None], axis=1)
    before = np.where(j > 0, np.take_along_axis(cum, np.maximum(j - 1, 0)[:, None], 1)[:, 0], 0.0)
    c = np.take_along_axis(ordered, j[:, None], 1)[:, 0]
    frac = np.divide(target - before, c, out=np.zeros(n), where=c > 0)
    # map ordered index back to (sign, magnitude bin)
    neg = j < BINS
    zero = j == BINS
    pos_bin = np.clip(j - BINS - 1, 0, BINS - 1)
    neg_bin = np.clip(BINS - 1 - j, 0, BINS - 1)
    idx = np.where(neg, neg_bin, pos_bin)
    lo, hi = _bin_edges(idx)
    lo_v, hi_v = 2.0**lo, 2.0**hi
    val = np.where(
        neg,
        -(hi_v - frac * (hi_v - lo_v)),
        lo_v + frac * (hi_v - lo_v),
    )
    val = np.where(zero, 0.0, val)
    # groups whose cumulative never exceeds target (p == 1 edge): vmax
    overrun = np.take_along_axis(cum, np.full((n, 1), ordered.shape[1] - 1), 1)[:, 0] <= target
    val = np.where(overrun, vmaxs, val)
    val = np.minimum(np.maximum(val, vmins), vmaxs)
    return val, valid
