"""Deterministic sharded token-stream pipeline (the training data substrate).

The port of ``repro.streams.pipeline``: host numpy with one producer
thread, as in the reference, making the same numpy ``Generator`` calls in
the same order, so ``sample`` and ``batch`` give the reference's tokens bit
for bit.  A batch is a dict of numpy arrays (``"tokens"``, ``"targets"``,
and ``"_step"`` from the prefetcher); the trainer copies it to the card.

Properties a 1000-node deployment needs and this implements:
  * deterministic, seekable sharding — every (partition, step) pair maps to
    a unique, reproducible batch; restart-from-checkpoint replays exactly
    (the pipeline state is just ``step``),
  * host-side prefetch with a bounded queue (overlaps data with compute),
  * per-partition streams so SPTLB can move partitions between tiers without
    resharding the dataset.

The source here is a synthetic-but-stationary token generator (zipfian
unigram mixture with per-partition phase) — the framework treats it as an
opaque ``sample(partition, step) -> tokens`` function, which is exactly the
interface a real corpus reader would implement.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_partitions: int = 16
    seed: int = 0
    prefetch: int = 2
    # Backpressure policy: a ``put`` that cannot place a batch within
    # ``stall_timeout_s`` is one stall; ``max_stalls`` *consecutive* stalls
    # mean the consumer is wedged, not slow, and the prefetcher fails loudly
    # (``BackpressureError``) instead of spinning forever.  0 disables.
    stall_timeout_s: float = 1.0
    max_stalls: int = 600


class BackpressureError(RuntimeError):
    """The prefetch consumer stopped draining: ``StreamConfig.max_stalls``
    consecutive put timeouts elapsed with the queue still full."""


@dataclasses.dataclass
class PrefetchStats:
    """Counters the prefetcher surfaces instead of silently spinning.

    ``stalls`` are put timeouts (backpressure ticks — the batch is *kept*
    and retried, never recomputed); ``dropped`` are batches produced but
    never consumed (counted when ``close`` drains the queue);
    ``join_timeouts`` are closes where the worker failed to exit in time.
    """

    produced: int = 0
    consumed: int = 0
    stalls: int = 0
    max_stall_run: int = 0
    dropped: int = 0
    join_timeouts: int = 0


class TokenStream:
    """Deterministic, seekable synthetic token source."""

    def __init__(self, cfg: StreamConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        # zipf-ish unigram distribution, fixed per stream
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self.probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self.phase = base.integers(0, 2**31, size=cfg.num_partitions)

    def rows_for(self, partition: int) -> int:
        """Rows this partition contributes (remainder spread over the first
        few partitions so any (global_batch, num_partitions) pair works)."""
        cfg = self.cfg
        base, extra = divmod(cfg.global_batch, cfg.num_partitions)
        return base + (1 if partition < extra else 0)

    def sample(self, partition: int, step: int) -> np.ndarray:
        """tokens i32[rows, seq_len+1] for this (partition, step)."""
        cfg = self.cfg
        rows = self.rows_for(partition)
        rng = np.random.default_rng(
            (int(self.phase[partition]) * 1_000_003 + step) % (2**63))
        return rng.choice(cfg.vocab_size, p=self.probs,
                          size=(rows, cfg.seq_len + 1)).astype(np.int32)

    def batch(self, step: int, partitions: Optional[list[int]] = None) -> dict:
        """Assemble the global batch from (a subset of) partitions."""
        cfg = self.cfg
        parts = partitions if partitions is not None else list(
            range(cfg.num_partitions))
        chunks = [self.sample(p, step) for p in parts
                  if self.rows_for(p) > 0]
        toks = np.concatenate(chunks, axis=0)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class Prefetcher:
    """Bounded background prefetch queue over a TokenStream.

    Backpressure is accounted, not swallowed: a full queue keeps the
    pending batch (no recompute), counts a stall, and after
    ``StreamConfig.max_stalls`` consecutive stalls the worker parks a
    ``BackpressureError`` that the next ``__next__`` raises to the
    consumer.  ``stats`` carries the counters either way.
    """

    def __init__(self, stream: TokenStream, start_step: int = 0):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=stream.cfg.prefetch)
        self.step = start_step
        self.stats = PrefetchStats()
        self._error: Optional[BackpressureError] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        cfg = self.stream.cfg
        step = self.step
        pending: Optional[dict] = None
        stall_run = 0
        while not self._stop.is_set():
            if pending is None:
                pending = self.stream.batch(step)
                pending["_step"] = step
            try:
                self.q.put(pending, timeout=cfg.stall_timeout_s)
            except queue.Full:
                self.stats.stalls += 1
                stall_run += 1
                self.stats.max_stall_run = max(self.stats.max_stall_run,
                                               stall_run)
                if cfg.max_stalls and stall_run >= cfg.max_stalls:
                    self._error = BackpressureError(
                        f"prefetch consumer wedged: {stall_run} consecutive "
                        f"stalls of {cfg.stall_timeout_s}s with the queue "
                        f"full at step {step}")
                    return
                continue
            self.stats.produced += 1
            pending = None
            stall_run = 0
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self._error is not None:
            raise self._error
        batch = self.q.get()
        self.stats.consumed += 1
        return batch

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
        if self._thread.is_alive():
            self.stats.join_timeouts += 1
        # Whatever is still queued was produced but will never be consumed.
        self.stats.dropped += self.q.qsize()
