"""The port's serving engine against the reference's, on the CPU.

The same requests (the reference CLI's draws) go through the reference's
``ServeEngine`` and the port's at the reduced ``smollm-360m`` and
``zamba2-2.7b`` sizes (4 slots, prompts of 4-8 tokens, 6 new tokens each, as
``tests/test_extensions.py`` serves), with the reference's weights carried
across: the greedy tokens are identical.  Also: the request queue's
priority, the port's command line (``main``), and the device policy (the
card by default, an error without one).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.models import build_model as ref_build_model
from repro.models import reduce_for_smoke as ref_reduce
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import build_model, reduce_for_smoke
from repro_torch.weights import lm_from_reference, lm_to_numpy

torch.set_num_threads(1)


def _requests(module, cfg, n: int, prompt_len: int, max_new: int, seed: int = 0):
    """The reference CLI's request draws, as ``module.Request``s."""
    rng = np.random.default_rng(seed)
    return [module.Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab_size, rng.integers(4, prompt_len + 1)).astype(np.int32),
        slo=int(rng.choice(4, p=[0.2, 0.2, 0.45, 0.15])),
        max_new_tokens=max_new) for i in range(n)]


def _drain(engine, queue, module):
    finished = []
    while len(queue) or any(r and r.done_s is None for r in engine.active):
        wave = []
        while len(wave) < engine.slots and len(queue):
            wave.append(queue.pop())
        if wave:
            engine.admit_wave(wave)
        while engine.step():
            pass
        finished.extend(r for r in engine.active if r is not None)
        engine.active = [None] * engine.slots
    return finished


def test_request_queue_slo_priority():
    q = serve.RequestQueue()
    q.push(serve.Request(0, np.zeros(4, np.int32), slo=3, max_new_tokens=4))
    q.push(serve.Request(1, np.zeros(4, np.int32), slo=0, max_new_tokens=4))
    q.push(serve.Request(2, np.zeros(4, np.int32), slo=1, max_new_tokens=4))
    assert len(q) == 3
    assert [q.pop().rid for _ in range(3)] == [1, 2, 0]
    assert q.pop() is None


def _serve_both(arch: str, seed: int):
    """The reference CLI's requests (10, 4 slots, prompts of 4-8 tokens, 6
    new tokens each) through the reference's engine and the port's, with
    the reference's weights carried across -> (port's, reference's
    finished requests)."""
    slots, prompt_len, max_new, n = 4, 8, 6, 10
    rcfg = ref_reduce(ref_get_config(arch))
    ref_model = ref_build_model(rcfg)
    params = ref_model.init(jax.random.PRNGKey(seed))
    port_model = lm_from_reference(reduce_for_smoke(get_config(arch)),
                                   jax.tree.map(np.asarray, params), device="cpu")
    max_seq = prompt_len + max_new + 8

    rq = ref_serve.RequestQueue()
    for r in _requests(ref_serve, rcfg, n, prompt_len, max_new):
        rq.push(r)
    ref_done = _drain(ref_serve.ServeEngine(ref_model, params, slots=slots, max_seq=max_seq),
                      rq, ref_serve)

    pq = serve.RequestQueue()
    for r in _requests(serve, rcfg, n, prompt_len, max_new):
        pq.push(r)
    ops.reset_launch_counts()
    port_done = serve.serve_all(serve.ServeEngine(port_model, slots=slots, max_seq=max_seq,
                                                  device="cpu"), pq)
    assert sum(ops.launch_counts.values()) == 0            # the CPU runs the plain versions

    assert [r.rid for r in port_done] == [r.rid for r in ref_done]
    for a, b in zip(port_done, ref_done):
        assert a.tokens == b.tokens, a.rid
        assert len(a.tokens) == max_new and a.done_s >= a.first_token_s
    report = serve.latency_report(port_done)
    assert sum(s["n"] for s in report.values()) == n


def test_serve_engine_gives_the_references_tokens():
    _serve_both("smollm-360m", seed=3)


def test_zamba2_serve_engine_gives_the_references_tokens():
    """The hybrid family: Mamba2 prefill (the chunked scan, prompts padded to
    the chunk) and decode (the one-step recurrence), the shared block's two
    KV caches."""
    _serve_both("zamba2-2.7b", seed=4)


def test_port_cli_serves_every_request():
    report = serve.main(["--arch", "smollm-360m", "--requests", "10", "--slots", "4",
                         "--prompt-len", "8", "--max-new", "6"], device="cpu")
    assert sum(s["n"] for s in report.values()) == 10
    for stats in report.values():
        assert stats["total_p99_ms"] > 0


def test_port_cli_serves_zamba2():
    report = serve.main(["--arch", "zamba2-2.7b", "--requests", "6", "--slots", "4",
                         "--prompt-len", "8", "--max-new", "4"], device="cpu")
    assert sum(s["n"] for s in report.values()) == 6


def test_engine_refuses_a_full_cache():
    cfg = reduce_for_smoke(get_config("qwen2.5-3b"))
    engine = serve.ServeEngine(build_model(cfg, device="cpu"), slots=2, max_seq=6, device="cpu")
    engine.admit_wave([serve.Request(0, np.arange(1, 5, dtype=np.int32), slo=0,
                                     max_new_tokens=10)])
    engine.step()
    engine.step()
    with pytest.raises(ValueError, match="full"):
        engine.step()


def test_entry_points_default_to_the_card_and_raise_without_one(monkeypatch):
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    cpu_model = build_model(cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.ServeEngine(cpu_model, slots=2, max_seq=16)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "smollm-360m", "--requests", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        lm_from_reference(cfg, lm_to_numpy(cpu_model))
