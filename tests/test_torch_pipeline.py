"""The token pipeline (``streams/pipeline.py``) in the port vs the live
reference, on the CPU.

Held: ``TokenStream``'s phases, ``rows_for``, ``sample`` and ``batch`` bit for
bit equal to the reference's, with remainder partitions (``global_batch``
not a multiple of ``num_partitions``), a subset of partitions and two
seeds; the ``Prefetcher``'s order, its counters, its stalls with the pending
batch kept, the ``close`` drop count, and ``BackpressureError`` for a wedged
consumer, as ``tests/test_streams.py`` holds the reference's.  Every wait has
its own deadline and every prefetcher is closed in ``finally``.
"""
import time

import numpy as np
import pytest

import repro.streams as RS
import repro.streams.pipeline as R
import repro_torch.streams as PS
import repro_torch.streams.pipeline as P


def _wait_for(cond, seconds: float = 5.0) -> bool:
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_exports_match_reference():
    assert PS.__all__ == RS.__all__
    for name in RS.__all__:
        assert hasattr(PS, name), name
    for name in ("BackpressureError", "Prefetcher", "PrefetchStats", "StreamConfig",
                 "TokenStream"):
        assert getattr(PS, name) is getattr(P, name)
    assert issubclass(P.BackpressureError, RuntimeError)
    assert P.PrefetchStats() == P.PrefetchStats(0, 0, 0, 0, 0, 0)


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("gb,parts", [(8, 16), (16, 5), (37, 8), (32, 32)])
def test_token_stream_matches_reference_bit_for_bit(seed, gb, parts):
    kw = dict(vocab_size=1000, seq_len=24, global_batch=gb, num_partitions=parts, seed=seed)
    a, b = P.TokenStream(P.StreamConfig(**kw)), R.TokenStream(R.StreamConfig(**kw))
    assert np.array_equal(a.phase, b.phase) and np.array_equal(a.probs, b.probs)
    assert [a.rows_for(p) for p in range(parts)] == [b.rows_for(p) for p in range(parts)]
    for step in (0, 3, 1000):
        for p in (0, parts - 1):
            assert np.array_equal(a.sample(p, step), b.sample(p, step))
        ba, bb = a.batch(step), b.batch(step)
        assert sorted(ba) == sorted(bb) == ["targets", "tokens"]
        for k in ba:
            assert ba[k].dtype == bb[k].dtype == np.int32
            assert np.array_equal(ba[k], bb[k])
        assert ba["tokens"].shape == (gb, 24)
    subset = [parts - 1, 0, parts // 2]
    assert np.array_equal(a.batch(5, subset)["tokens"], b.batch(5, subset)["tokens"])


def _cfg(**kw):
    return P.StreamConfig(**{"vocab_size": 64, "seq_len": 4, "global_batch": 2, **kw})


def test_prefetcher_yields_the_streams_batches_in_order():
    stream = P.TokenStream(_cfg(vocab_size=128, seq_len=8, global_batch=4, prefetch=2))
    pf = P.Prefetcher(stream, start_step=3)
    try:
        got = [next(pf) for _ in range(4)]
    finally:
        pf.close()
    assert [b["_step"] for b in got] == [3, 4, 5, 6]
    for b in got:
        assert np.array_equal(b["tokens"], stream.batch(b["_step"])["tokens"])
    assert pf.stats.consumed == 4 and pf.stats.produced >= 4
    assert pf.stats.join_timeouts == 0 and not pf._thread.is_alive()


def test_prefetcher_counts_stalls_keeps_pending_batch_and_drops_on_close():
    pf = P.Prefetcher(P.TokenStream(_cfg(prefetch=1, stall_timeout_s=0.02,
                                         max_stalls=10_000)))
    try:
        assert _wait_for(lambda: pf.stats.stalls >= 3)
        steps = [next(pf)["_step"] for _ in range(5)]
    finally:
        pf.close()
    assert steps == [0, 1, 2, 3, 4]          # no step skipped or repeated
    assert pf.stats.max_stall_run >= 3
    assert pf.stats.dropped == pf.stats.produced - pf.stats.consumed
    assert pf.stats.join_timeouts == 0 and not pf._thread.is_alive()


def test_prefetcher_raises_on_wedged_consumer():
    pf = P.Prefetcher(P.TokenStream(_cfg(prefetch=1, stall_timeout_s=0.01, max_stalls=3)))
    try:
        assert _wait_for(lambda: pf._error is not None)
        with pytest.raises(P.BackpressureError, match="3 consecutive stalls"):
            next(pf)
        assert pf.stats.max_stall_run >= 3 and pf.stats.produced == 1
    finally:
        pf.close()
    assert pf.stats.dropped == 1 and not pf._thread.is_alive()
