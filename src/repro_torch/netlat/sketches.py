"""Streaming per-link-pair latency percentiles: batched P² quantile sketches.

The PyTorch port's copy of ``repro.netlat.sketches``: host numpy in f64
with the reference's numpy random streams, so samples, marker states and
quantiles are the reference's bit for bit.

The paper's Fig. 4 headline metric is worst-case (p99) network latency of
app movements, yet until this subsystem the control plane vetted moves
against a hard-coded 36 ms constant.  Henge (arXiv 1802.00082) argues
latency SLOs must be driven by *measured* per-tenant behavior; this module
is the measurement half of that loop:

* ``P2QuantileBank`` — the P² algorithm (Jain & Chlamtac, CACM 1985) run
  simultaneously over every region pair and every tracked quantile.  P² is
  the classic fixed-size streaming estimator: five markers per quantile,
  O(1) state per stream, no sample retention.  The bank keeps the marker
  state as ``[Q, G*G, 5]`` numpy arrays so one tick's ``[G, G]`` latency
  observation updates *all* pairs with a handful of vectorized ops — no
  per-pair Python loop on the hot path.  Sketches are mergeable: two banks
  combine by inverting the count-weighted mixture of their piecewise-linear
  CDFs (exact for the empirical phase, tolerance-bounded afterwards), so
  per-shard probers can aggregate into a fleet view.

* ``LinkSketchBank`` — the operational wrapper the scheduler level
  (``repro_torch.netlat.level``) reads: plausibility quarantine and staleness
  inflation in the spirit of ``core.health.TelemetryMonitor`` (corrupt or
  stale link readings inflate uncertainty instead of poisoning budgets),
  a calibration snapshot that freezes per-pair budgets from the observed
  baseline, and a ``SignalHealth`` record that folds link-latency health
  into the controller's composite score via
  ``TelemetryMonitor.note_signal``.

* ``LinkMeasurementSource`` — the simulated per-tick prober: noisy
  (lognormal body + occasional heavy tail) samples around the fleet's true
  effective latency matrix, deterministic per (seed, tick) so twin
  trajectory runs observe identical measurements.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.health import HealthConfig, SignalHealth

# Marker probabilities of a P² sketch tracking quantile p, in marker order:
# min, p/2, p, (1+p)/2, max.
_MARKERS = 5


def _marker_probs(p: float) -> np.ndarray:
    return np.array([0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0], np.float64)


class P2QuantileBank:
    """P² streaming quantile estimation, batched over parallel streams.

    ``shape`` is the stream grid (e.g. ``(G, G)`` region pairs); one
    ``update`` consumes a full-grid observation.  ``quantiles`` are the
    tracked targets; state is ``[Q, M, 5]`` marker heights/positions plus a
    per-stream count — fixed-size whatever the stream length.
    """

    def __init__(self, shape, quantiles=(0.5, 0.99, 0.999)):
        self.shape = tuple(int(s) for s in shape)
        self.quantiles = tuple(float(p) for p in quantiles)
        m = int(np.prod(self.shape))
        q = len(self.quantiles)
        self._m = m
        self.count = np.zeros(m, np.int64)
        # Empirical phase: the first five observations per stream, sorted
        # into the marker heights when the sketch proper starts.
        self._buf = np.zeros((m, _MARKERS), np.float64)
        # Sketch phase: heights, integer positions, desired positions.
        self.heights = np.zeros((q, m, _MARKERS), np.float64)
        self.pos = np.zeros((q, m, _MARKERS), np.float64)
        self.desired = np.zeros((q, m, _MARKERS), np.float64)
        self._probs = np.stack([_marker_probs(p) for p in self.quantiles])
        self._dn = self._probs.copy()  # desired-position increments per obs

    # -- updates --------------------------------------------------------------
    def update(self, samples: np.ndarray, mask: Optional[np.ndarray] = None) -> None:
        """Fold one grid observation (or a ``[..., S]`` batch) into every
        stream.  ``mask`` (broadcastable to the grid) marks streams whose
        sample this round should be *dropped* (quarantine)."""
        samples = np.asarray(samples, np.float64)
        if samples.shape == self.shape:
            samples = samples[..., None]
        flat = samples.reshape(self._m, -1)
        keep = None
        if mask is not None:
            keep = ~np.broadcast_to(np.asarray(mask, bool), samples.shape).reshape(self._m, -1)
        for s in range(flat.shape[1]):
            self._update_one(flat[:, s], keep[:, s] if keep is not None else None)

    def _update_one(self, x: np.ndarray, keep: Optional[np.ndarray]) -> None:
        upd = np.ones(self._m, bool) if keep is None else keep.copy()
        if not upd.any():
            return
        # Empirical phase: buffer the first five observations.
        fresh = upd & (self.count < _MARKERS)
        if fresh.any():
            idx = np.where(fresh)[0]
            self._buf[idx, self.count[idx]] = x[idx]
            self.count[idx] += 1
            done = idx[self.count[idx] == _MARKERS]
            if done.size:
                self._seed_markers(done)
            upd = upd & ~fresh
        if not upd.any():
            return
        self.count[upd] += 1
        self._p2_step(x, upd)

    def _seed_markers(self, streams: np.ndarray) -> None:
        """Streams that just collected five observations enter the sketch
        phase: sorted buffer becomes the marker heights, positions reset to
        the canonical 1..5."""
        seed = np.sort(self._buf[streams], axis=1)
        self.heights[:, streams] = seed[None]
        self.pos[:, streams] = np.arange(1, _MARKERS + 1, dtype=np.float64)
        self.desired[:, streams] = 1.0 + 4.0 * self._probs[:, None, :]

    def _p2_step(self, x: np.ndarray, upd: np.ndarray) -> None:
        """One vectorized P² marker adjustment over [Q, M] streams."""
        q, n, nd = self.heights, self.pos, self.desired
        xs = x[None, :]  # [1, M] broadcast over quantiles
        # Locate the cell, clamping x into the observed range.
        k = (xs[..., None] >= q).sum(axis=-1)  # [Q, M] markers <= x
        below = upd[None, :] & (k == 0)
        above = upd[None, :] & (k == _MARKERS)
        q[..., 0] = np.where(below, xs, q[..., 0])
        q[..., -1] = np.where(above, xs, q[..., -1])
        cell = np.clip(k, 1, _MARKERS - 1) - 1  # [Q, M] in 0..3
        bump = (np.arange(_MARKERS)[None, None, :] > cell[..., None]) & upd[None, :, None]
        n += bump
        nd += np.where(upd[None, :, None], self._dn[:, None, :], 0.0)
        # Adjust the three interior markers toward their desired positions.
        with np.errstate(divide="ignore", invalid="ignore"):
            for i in range(1, _MARKERS - 1):
                d = nd[..., i] - n[..., i]
                up = (d >= 1.0) & (n[..., i + 1] - n[..., i] > 1.0)
                dn = (d <= -1.0) & (n[..., i - 1] - n[..., i] < -1.0)
                s = np.where(up, 1.0, np.where(dn, -1.0, 0.0))
                act = upd[None, :] & (s != 0.0)
                if not act.any():
                    continue
                gap = n[..., i + 1] - n[..., i - 1]
                para = q[..., i] + (s / gap) * (
                    (n[..., i] - n[..., i - 1] + s)
                    * (q[..., i + 1] - q[..., i])
                    / (n[..., i + 1] - n[..., i])
                    + (n[..., i + 1] - n[..., i] - s)
                    * (q[..., i] - q[..., i - 1])
                    / (n[..., i] - n[..., i - 1])
                )
                ok = (q[..., i - 1] < para) & (para < q[..., i + 1])
                lin_up = q[..., i] + (q[..., i + 1] - q[..., i]) / (n[..., i + 1] - n[..., i])
                lin_dn = q[..., i] - (q[..., i - 1] - q[..., i]) / (n[..., i - 1] - n[..., i])
                lin = np.where(s > 0, lin_up, lin_dn)
                new_q = np.where(ok, para, lin)
                q[..., i] = np.where(act, new_q, q[..., i])
                n[..., i] = n[..., i] + np.where(act, s, 0.0)

    # -- estimates ------------------------------------------------------------
    def quantile(self, p: float) -> np.ndarray:
        """Current estimate of tracked quantile ``p``, shaped like the
        stream grid.  Streams still in the empirical phase answer from
        their buffer; streams with no observations answer NaN."""
        try:
            qi = self.quantiles.index(float(p))
        except ValueError:
            raise KeyError(f"quantile {p} not tracked; have {self.quantiles}")
        out = np.full(self._m, np.nan)
        sketch = self.count >= _MARKERS
        out[sketch] = self.heights[qi, sketch, 2]
        part = ~sketch & (self.count > 0)
        for m in np.where(part)[0]:
            out[m] = np.quantile(self._buf[m, : self.count[m]], p)
        return out.reshape(self.shape)

    # -- merge ----------------------------------------------------------------
    def _cdf_points(self, qi: int, m: int):
        """(xs, probs) piecewise-linear CDF of stream ``m`` for tracked
        quantile index ``qi`` — marker heights in the sketch phase, the
        sorted buffer in the empirical phase."""
        c = int(self.count[m])
        if c >= _MARKERS:
            return self.heights[qi, m], self._probs[qi]
        xs = np.sort(self._buf[m, :c])
        if c == 1:
            return np.array([xs[0], xs[0]]), np.array([0.0, 1.0])
        return xs, np.linspace(0.0, 1.0, c)

    def merge(self, other: "P2QuantileBank") -> "P2QuantileBank":
        """Count-weighted merge: invert the mixture of both sketches'
        piecewise-linear CDFs at the canonical marker probabilities.
        Commutative by construction; associative to within the sketches'
        own approximation error (the unit tests bound it)."""
        if self.shape != other.shape or self.quantiles != other.quantiles:
            raise ValueError("merge requires identical grid and quantiles")
        out = P2QuantileBank(self.shape, self.quantiles)
        for m in range(self._m):
            ca, cb = int(self.count[m]), int(other.count[m])
            c = ca + cb
            out.count[m] = c
            if c == 0:
                continue
            if c < _MARKERS:  # still empirical: concatenate the buffers
                out._buf[m, :c] = np.concatenate([self._buf[m, :ca], other._buf[m, :cb]])
                continue
            for qi in range(len(self.quantiles)):
                xa, pa = self._cdf_points(qi, m)
                xb, pb = other._cdf_points(qi, m)
                grid = np.unique(np.concatenate([xa, xb]))
                fa = np.interp(grid, xa, pa)
                fb = np.interp(grid, xb, pb)
                f = (ca * fa + cb * fb) / c
                heights = np.interp(self._probs[qi], f, grid)
                heights = np.maximum.accumulate(heights)
                out.heights[qi, m] = heights
                out.pos[qi, m] = np.maximum(
                    np.arange(1, _MARKERS + 1),
                    np.round(1.0 + (c - 1) * self._probs[qi]),
                )
                out.pos[qi, m] = np.maximum.accumulate(out.pos[qi, m])
                out.pos[qi, m, -1] = max(out.pos[qi, m, -1], float(c))
                out.desired[qi, m] = 1.0 + (c - 1) * self._probs[qi]
        return out


# ---------------------------------------------------------------------------
# operational wrapper: quarantine, staleness, calibration, health
# ---------------------------------------------------------------------------


class LinkSketchBank:
    """Per-region-pair latency sketches with telemetry-health semantics.

    ``ingest(samples, now)`` quarantines implausible readings (non-finite,
    negative, or jumping more than ``max_jump_factor`` x the stream's
    current median) before they reach the sketch, mirroring the
    ``TelemetryMonitor`` plausibility contract; ``p99(now)`` inflates the
    live estimate by the staleness uncertainty factor so budgets derived
    from old measurements over-protect instead of over-trusting.
    ``calibrate(now)`` freezes the per-pair p99 baseline the scheduler
    level turns into budgets.
    """

    def __init__(self, num_regions: int, config: HealthConfig = HealthConfig()):
        self.num_regions = int(num_regions)
        self.config = config
        self.sketches = P2QuantileBank((num_regions, num_regions))
        self.last_update = np.full((num_regions, num_regions), -(10**9), np.int64)
        self.quarantined_total = 0
        self._quarantined_last = 0
        self.calibrated_p99: Optional[np.ndarray] = None
        self.calibrated_at: Optional[int] = None

    # -- ingestion ------------------------------------------------------------
    def ingest(self, samples: np.ndarray, now: int) -> int:
        """Fold a ``[G, G]`` or ``[G, G, S]`` latency observation collected
        at tick ``now``; returns the number of quarantined samples."""
        cfg = self.config
        samples = np.asarray(samples, np.float64)
        if samples.ndim == 2:
            samples = samples[..., None]
        bad = ~np.isfinite(samples) | (samples < 0.0)
        med = self.sketches.quantile(0.5)
        seen = np.isfinite(med)
        if seen.any():
            ref = np.abs(np.where(seen, med, 0.0)) + cfg.jump_floor
            jump = np.abs(samples - med[..., None]) > (
                (cfg.max_jump_factor - 1.0) * ref[..., None]
            )
            bad = bad | (jump & seen[..., None])
        n_bad = int(bad.sum())
        self.quarantined_total += n_bad
        self._quarantined_last = n_bad
        self.sketches.update(np.where(bad, 0.0, samples), mask=bad)
        accepted = (~bad).any(axis=-1)
        self.last_update[accepted] = int(now)
        return n_bad

    # -- staleness ------------------------------------------------------------
    def staleness(self, now: int) -> np.ndarray:
        return np.maximum(0, int(now) - self.last_update)

    def inflation(self, now: int) -> np.ndarray:
        """Per-pair uncertainty factor: 1.0 while fresh, widening by
        ``uncertainty_growth`` per tick past ``stale_after`` (capped)."""
        cfg = self.config
        over = np.maximum(0, self.staleness(now) - cfg.stale_after)
        return np.minimum(cfg.max_inflation, (1.0 + cfg.uncertainty_growth) ** over)

    # -- estimates ------------------------------------------------------------
    @property
    def observed(self) -> bool:
        """Every pair has left the empirical phase (>= 5 samples)."""
        return bool((self.sketches.count >= _MARKERS).all())

    def p99(self, now: Optional[int] = None) -> np.ndarray:
        """Live per-pair p99 estimate, staleness-inflated when ``now`` is
        given (the conservative view budgets should be checked against)."""
        est = self.sketches.quantile(0.99)
        if now is None:
            return est
        return est * self.inflation(now)

    def relax_factor(self, floor: float = 1.0, cap: float = 2.5, default: float = 1.5) -> float:
        """The maintenance relax factor, derived from the measured tail:
        the fleet-median p999/p99 ratio (how much worse the extreme tail
        is than the SLO percentile), clipped to [floor, cap].  Falls back
        to ``default`` until every pair has real sketch state."""
        if not self.observed:
            return float(default)
        p99 = self.sketches.quantile(0.99)
        p999 = self.sketches.quantile(0.999)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(p99 > 0.0, p999 / p99, 1.0)
        ratio = ratio[np.isfinite(ratio)]
        if ratio.size == 0:
            return float(default)
        return float(np.clip(np.median(ratio), floor, cap))

    # -- calibration ----------------------------------------------------------
    def calibrate(self, now: int) -> bool:
        """Freeze the current p99 estimate as the budget baseline.  Returns
        False (and stays uncalibrated) until every pair has sketch state —
        calibrating from a half-empty bank would write NaN budgets."""
        if not self.observed:
            return False
        self.calibrated_p99 = self.sketches.quantile(0.99).copy()
        self.calibrated_at = int(now)
        return True

    @property
    def calibrated(self) -> bool:
        return self.calibrated_p99 is not None

    # -- health integration ---------------------------------------------------
    def signal_health(self, now: int) -> SignalHealth:
        """Link-latency health in ``TelemetryMonitor`` scoring terms: the
        worst pair's staleness x the quarantined fraction of the last
        ingest.  Feed to ``TelemetryMonitor.note_signal`` so blind or
        corrupt link probes degrade the composite score."""
        cfg = self.config
        staleness = int(self.staleness(now).max()) if self.last_update.size else 0
        if staleness <= cfg.stale_after:
            stale_score = 1.0
        elif staleness >= cfg.blind_after:
            stale_score = 0.0
        else:
            span = max(1, cfg.blind_after - cfg.stale_after)
            stale_score = 1.0 - (staleness - cfg.stale_after) / span
        pairs = self.num_regions * self.num_regions
        frac = self._quarantined_last / max(1, pairs)
        plaus = (
            max(0.0, 1.0 - frac / cfg.quarantine_blind_frac)
            if cfg.quarantine_blind_frac > 0
            else float(frac == 0)
        )
        return SignalHealth(
            "link_latency",
            staleness,
            self._quarantined_last,
            pairs,
            round(stale_score * plaus, 4),
        )


# ---------------------------------------------------------------------------
# simulated measurement source
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SourceConfig:
    """The simulated prober's noise model: a lognormal body around the true
    link latency plus an occasional heavy-tail straggler, so the measured
    distribution has a real p999/p99 gap to calibrate the relax factor
    from."""

    samples_per_tick: int = 4
    sigma: float = 0.08
    tail_prob: float = 0.01
    tail_factor: float = 2.0


class LinkMeasurementSource:
    """Deterministic per-tick link prober over the fleet's true latency.

    Draws from ``default_rng([seed, tick])`` — a pure function of (seed,
    tick), so oracle-twin runs that replay the same trajectory observe
    bit-identical measurements regardless of how many times each run
    refreshes its fleet state.
    """

    def __init__(self, seed: int = 0, config: SourceConfig = SourceConfig()):
        self.seed = int(seed)
        self.config = config

    def measure(self, region_latency: np.ndarray, tick: int) -> np.ndarray:
        """[G, G, S] noisy samples of the true effective latency matrix."""
        cfg = self.config
        lat = np.asarray(region_latency, np.float64)
        rng = np.random.default_rng([self.seed, int(tick)])
        shape = lat.shape + (cfg.samples_per_tick,)
        # Mean-corrected lognormal body: E[factor] == 1.
        body = rng.lognormal(-0.5 * cfg.sigma**2, cfg.sigma, size=shape)
        tail = rng.random(shape) < cfg.tail_prob
        factor = np.where(tail, cfg.tail_factor, 1.0) * body
        return lat[..., None] * factor
