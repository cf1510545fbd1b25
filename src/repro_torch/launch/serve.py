"""Batched serving driver: SLO-class request routing + KV-cache decode (the
port of ``repro/launch/serve.py``).

  * RequestQueue  — per-SLO-class FIFO, strict priority by class,
  * ServeEngine   — slot-based batcher over waves: a wave's prompts are
                    left-padded to its longest and prefilled into a fresh
                    cache, then decoded in one batch until every request
                    has its tokens (the reference's static-batch pattern),
  * latency_report — TTFT and total latency percentiles per SLO class.

On a card every prefill runs the ``flash_attention`` kernel once per layer
and every decode step the ``flash_decode`` kernel once per layer; for the
hybrid Zamba2, once per shared-block application, and every prefill runs the
``ssd_chunk`` kernel once per Mamba2 layer; for xLSTM every prefill and
every decode step runs ``mlstm_scan`` once per mLSTM layer and
``slstm_scan`` once per sLSTM layer, and no attention kernel
(``kernels.ops.launch_counts``).

Run (reduced config, on the card; ``--arch zamba2-2.7b`` for the hybrid,
``--arch xlstm-125m`` for the xLSTM family,
``--arch granite-moe-1b-a400m`` for the MoE family; ``--arch
phi-3-vision-4.2b`` serves the VLM's trunk on text-only waves, as the
reference's engine does: it takes no images; ``--arch hubert-xlarge`` exits,
being encoder-only):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --requests 24 --max-new 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import build_model, reduce_for_smoke
from repro_torch.train.serve_step import greedy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # i32[prompt_len]
    slo: int                      # latency class (paper SLO1..4)
    max_new_tokens: int
    arrival_s: float = 0.0
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None
    tokens: list = dataclasses.field(default_factory=list)


class RequestQueue:
    """Per-SLO FIFO; lower class id = tighter latency target."""

    def __init__(self, num_classes: int = 4):
        self.queues = [deque() for _ in range(num_classes)]

    def push(self, req: Request):
        self.queues[req.slo].append(req)

    def pop(self) -> Optional[Request]:
        for q in self.queues:               # strict priority by SLO class
            if q:
                return q.popleft()
        return None

    def __len__(self):
        return sum(map(len, self.queues))


class ServeEngine:
    """Slot-based batching over a fixed decode batch, on ``device`` (default
    the card; raises without one).  The model must live there."""

    def __init__(self, model, *, slots: int, max_seq: int, eos_token: int = 0,
                 device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"the model is on {model.device}, the engine on {dev}")
        self.model = model
        self.device = dev
        self.slots = slots
        self.max_seq = max_seq
        self.eos = eos_token
        self.cache = None                        # a fresh one per wave
        self.length = 0                          # tokens the cache holds
        self.active: list[Optional[Request]] = [None] * slots
        self.tokens = torch.zeros((slots, 1), dtype=torch.int32, device=dev)

    def admit_wave(self, reqs: list[Request]):
        """Prefill a wave of requests (left-padded to a common length)."""
        if len(reqs) > self.slots:
            raise ValueError(f"{len(reqs)} requests for {self.slots} slots")
        maxlen = max(len(r.prompt) for r in reqs)
        if maxlen >= self.max_seq:
            raise ValueError(f"a prompt of {maxlen} tokens does not fit max_seq {self.max_seq}")
        batch = np.zeros((self.slots, maxlen), np.int32)
        for i, r in enumerate(reqs):
            batch[i, maxlen - len(r.prompt):] = r.prompt   # left-pad
            self.active[i] = r
        self.cache = None                        # freed before the next is allocated
        self.cache = self.model.init_cache(self.slots, self.max_seq)
        logits, self.cache = self.model.prefill(
            {"tokens": torch.as_tensor(batch, device=self.device)}, self.cache)
        self.tokens = greedy(logits)
        self.length = maxlen
        first = self.tokens.cpu().numpy()                  # waits for the card
        now = time.perf_counter()
        for i, r in enumerate(reqs):
            r.first_token_s = now
            r.tokens.append(int(first[i, 0]))

    def step(self) -> int:
        """One batched decode step; returns #still-active requests."""
        if self.length >= self.max_seq:
            raise ValueError(f"the cache is full ({self.max_seq} positions)")
        logits, self.cache = self.model.decode_step(self.tokens, self.cache)
        self.tokens = greedy(logits)
        self.length += 1
        toks = self.tokens.cpu().numpy()                   # waits for the card
        now = time.perf_counter()
        alive = 0
        for i, r in enumerate(self.active):
            if r is None or r.done_s is not None:
                continue
            r.tokens.append(int(toks[i, 0]))
            if len(r.tokens) >= r.max_new_tokens:
                r.done_s = now
            else:
                alive += 1
        return alive


def latency_report(requests: list[Request]) -> dict:
    by_slo: dict = {}
    for r in requests:
        if r.done_s is None:
            continue
        d = by_slo.setdefault(r.slo, {"ttft_ms": [], "total_ms": []})
        d["ttft_ms"].append((r.first_token_s - r.arrival_s) * 1e3)
        d["total_ms"].append((r.done_s - r.arrival_s) * 1e3)
    out = {}
    for slo, d in sorted(by_slo.items()):
        out[slo] = {
            "n": len(d["ttft_ms"]),
            "ttft_p50_ms": float(np.percentile(d["ttft_ms"], 50)),
            "ttft_p99_ms": float(np.percentile(d["ttft_ms"], 99)),
            "total_p99_ms": float(np.percentile(d["total_ms"], 99)),
        }
    return out


def serve_all(engine: ServeEngine, queue: RequestQueue) -> list[Request]:
    """Drain ``queue`` through ``engine`` wave by wave (the reference
    driver's loop) -> the finished requests in the order served."""
    finished: list[Request] = []
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


def main(argv=None, *, device=DEFAULT_DEVICE):
    """The reference's CLI on the port (reduced config).  ``device`` is for
    callers that want the CPU; the command line runs on the card."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = reduce_for_smoke(get_config(args.arch))
    if cfg.is_encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only")
    dev = resolve_device(device)
    rng = np.random.default_rng(args.seed)
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(args.seed))

    queue = RequestQueue()
    t0 = time.perf_counter()
    for i in range(args.requests):
        queue.push(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size,
                                rng.integers(4, args.prompt_len + 1)
                                ).astype(np.int32),
            slo=int(rng.choice(4, p=[0.2, 0.2, 0.45, 0.15])),
            max_new_tokens=args.max_new,
            arrival_s=t0,
        ))

    engine = ServeEngine(model, slots=args.slots,
                         max_seq=args.prompt_len + args.max_new + 8, device=dev)
    finished = serve_all(engine, queue)

    report = latency_report(finished)
    print(f"served {len(finished)} requests on arch={cfg.arch_id} (reduced)")
    for slo, stats in report.items():
        print(f"  SLO{slo + 1}: n={stats['n']:3d} "
              f"ttft p50 {stats['ttft_p50_ms']:8.1f} ms  "
              f"p99 {stats['ttft_p99_ms']:8.1f} ms  "
              f"total p99 {stats['total_p99_ms']:8.1f} ms")
    return report


if __name__ == "__main__":
    main()
