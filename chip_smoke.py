#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root with no arguments on a machine with one
NVIDIA card:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

  1. Card and build: the card's name and power limit (``nvidia-smi``), then
     every CUDA source built by ``nvcc`` in parallel, with the build time.
  2. Kernels against their plain PyTorch versions on the card:
     ``move_eval`` and ``move_eval_best`` at (N, T) in {(300, 5), (500, 17),
     (100_000, 5), (100_000, 128)} x moves_left {0, 5} and at the main
     path's own input (the N=100_000 cluster, bucket-padded), both kernels
     also with the caller's totals against the wrapper's own, ``move_eval``
     bit for bit (max abs err 0);
     ``commit_topk`` on the top-16 candidates of the same sweeps (status,
     assignment and tier loads bit for bit); and
     ``pack_ffd_tiers`` on random demand (M in {128, 4096}), at the kernel's
     edges (``kernels.pack.pack_edge_cases``: pads 16-1024, R = 1/3/4, tiers
     with no host, everything rejected, only the last live host fitting,
     zeros among the items, a negative capacity, M not a multiple of 4) and
     on the [T, M_b, R] tensor the host scheduler built for the balance's
     last proposal, each with its tiers' non-zero item counts; median
     CUDA-event time per launch of each kernel and of its plain version
     (both sweeps as the whole call from the solver's arguments, and as the
     kernel alone), the pack kernel also beside its chain floor; the tier
     table kernel (``tier_stats``, the sweeps' means as
     ``core.means.tier_mean`` takes them) bit for bit against its plain
     version at each sweep shape, for one problem and a stack of three, and
     timed at the main path's; the objective's mean kernel (``tier_mean``)
     bit for bit against ``core.means.tier_mean``, value and gradient, and
     timed beside it and ``torch.mean``; and the kernels one whole call of
     each sweep launches (profiler; at most ``SWEEP_CALL_MAX_LAUNCHES``).
  3. The slice: ``generate_cluster(num_apps=100_000, seed=1)`` and one
     manual_cnst ``Sptlb(cluster).balance("local", timeout_s=30,
     config=CoopConfig())`` with the launch counters zeroed just before and
     read just after (``move_eval_best``, ``commit_topk``,
     ``pack_ffd_tiers``, ``tier_stats`` and ``tier_mean`` must each have
     launched); then the unfused LocalSearch path
     (``solve_local(move_eval_fn=ops.move_eval)``, the ``move_eval``
     kernel's path) with its own zeroed counts; one short solve under
     ``torch.profiler`` (device busy share, kernel time by name); the
     sampled LocalSearch (temperature 1.0, 64 sweeps at the padded N=100,000,
     the card's generator) with its own zeroed counts (one ``move_eval``
     launch a sweep), valid and no worse than the start, a repeat with the
     same seed giving the same mapping, and with host-drawn noise injected
     the same trajectory as through the plain ``move_delta_cost`` on the
     card, ms a sweep and the idle share of a profiled sampled solve; and the
     N=300 pass on the card and on the CPU's plain path, which must agree
     (same rounds, objective within rel 1e-4, assignments >= 0.98 equal).
     The optimal engine (phase 3f): ``_optimize`` on the card (256 Adam
     steps at the padded N, ms a step, reproducible), ``optimal_round``
     bit for bit against its plain version on that P (timed beside its
     plain version, bytes bound and chain floor, its staging and walk
     launches alone, and its whole ``_round`` call with the torch work
     before the kernel part by part) and on seeded inputs
     (``kernels.optimal_round.round_case``: the budget, capacity, tied rows
     binding and every move rejected, at (131,072, 5, 2), each timed beside
     its chain floor with its cycles a walked mover, then at (8,193, 5, 3),
     (1,001, 1, 1), (100,003, 17, 4)) and at the walk's block edges
     (``round_edge_cases``, each with its stated status); the N=100,000
     ``balance("optimal", timeout_s=30)`` in manual_cnst and no_cnst with
     the counts zeroed just before each (``optimal_round`` at least once a
     round, each launch on the body ``choose_body`` names, ``move_eval_best``
     and ``commit_topk``, and ``pack_ffd_tiers`` for manual_cnst), valid, no
     worse than the start, the same digest on a repeat; the N=300 optimal
     pass on the card against the CPU's plain path; the idle share of the
     profiled solve.
     The control loop (phase 3g): ``BalanceController.step`` for 12 ticks
     on the N=100,000 cluster with utility curves (``attach_curves``), a
     ``LoadShedder`` at 0.8 of capacity, fault tolerance armed and an
     ``AdmissionController`` pricing 64 seeded arrivals a tick: base load,
     ticks 2-4 at 1.15 x the target, telemetry 3 ticks stale at ticks
     9-10; the counts zeroed just before tick 0.  Checks: tick 2 sheds and
     rebalances, its plan serves at most the target with no protected app
     capped, no cap lifts before tick 7 and all lift there, the sweep,
     commit and pack kernels launched, every applied decision valid, the
     mode leaves NORMAL at tick 9, a repeat gives the same records and
     digest (its tick 2 profiled: the idle share), and the N=300 schedule on
     the card and on the CPU's plain path gives the same per-tick fields.
     Each tick's wall-clock split into the shed plan, the admissions and the
     balance's ``solve_s``.
     The sharded fleet solver (phase 3h): ``synthetic_fleet(1_000_000,
     num_tiers=64, seed=9)`` and ``solve_fleet(cluster,
     FleetConfig(num_shards=8, timeout_s=30))`` once warm and once measured
     with the counts zeroed just before: partition, solve, merge and
     coordinator seconds, apps/s, sweeps a shard, the start and final
     objective (beside the reference's CPU record), the digest on a repeat;
     gated on no stranded app, buckets (131,072, 9), a valid mapping (the
     objectives are printed: this fleet starts balanced and the pass raises
     its global objective, in the reference as well), the same digest, one
     launch of each shard-batched kernel a sweep
     for all 8 shards (and none of the unbatched ones), and each shard equal
     to ``solve_local`` on that shard alone bit for bit; a delta pass over
     dirty shards (0, 3) (the dirty ones as in the full pass, the clean ones
     at their incumbents); both batched kernels against their plain versions
     and the unbatched kernels on each shard at 8 x 131,072 x 9 and
     32 x 65,536 x 3 with some shards inactive, bit for bit, each timed
     beside its plain version, its bound and the unbatched kernel launched
     once a shard.
     The streaming service (phase 3i): ``ServiceLoop`` over a
     ``BalanceController`` on the card (``generate_cluster(num_apps=100_000,
     seed=7)``, ``timeout_s=30``, levels netlat + host, 4 shards) for 16 ticks
     of ``fleet_service_events`` (4 producer threads at tick 0, an advisory,
     one shard's demand x 1.3, a fault window, 64 departures from shard 0's
     least-loaded tier, 64 arrivals with a region pair over the latency budget,
     a capacity cut), with the netlat plane probing, calibrating after 4 ticks
     and installed process-wide; the counts zeroed just before tick 0. Checks:
     NOOP, DELTA and FULL all occur, a DELTA tick runs the sharded route (one
     launch of each batched kernel a sweep, none unbatched) and an applied one
     scoped to a strict subset of the shards moves apps (the never-worse guard
     did not revert it), a FULL tick the unbatched sweep, commit and pack, no
     event dropped and every app's events applied in order, every applied
     decision valid, every app outside the dirty shards that moved was a
     migration the coordinator granted, the bank calibrated and the netlat
     level on measured budgets on every later FULL tick, both batched kernels
     bit for bit their plain versions on the inputs of the first sweep of every
     DELTA tick (captured as the run launched them), a repeat gives the same
     decisions and digest (the scoped DELTA tick and one FULL tick profiled:
     the idle share), and the CPU tests' 12-tick stream
     (tests/_service_stream.py) at N=300 gives the same actions, dirty shards
     and applied flags on the card as on the CPU's plain path. Printed per
     tick: action, reason, dirty shards, ``latency_s``, ``solve_s``, moved,
     kernels launched, the netlat level's counters; then ``stats()`` and the
     host time of the shadow's ``view`` and of ``plan_shards``.
     The fleet simulator (phase 3j): ``run_pair(get_scenario(name,
     num_apps=100_000, ticks=32))`` on the card for ``tier_drain`` (the
     global path, with its declared advisories and movement budget) and
     ``fleet_scale`` (the sharded route, S=2), each with the counts zeroed
     just before.  Checks: the controller triggers and applies, the static
     baseline launches nothing, no unsafe move, every applied mapping valid,
     tier_drain launches the sweep, commit and pack kernels and keeps within
     its movement budget, every solved tick of fleet_scale launches both
     batched kernels and none of the unbatched sweep kernels, a repeat of
     tier_drain gives the same per-tick records and assignment digests (its
     first triggered tick profiled: the idle share), and tier_drain at
     N=300 on the card and on the CPU's plain path (the same host draws)
     gives the same per-tick decisions.  Printed per tick: the wall-clock
     split into the world, the controller and the accounting, the decision,
     the kernels launched; then each pair's ``compare()``.
     The stream router and the fault path (phase 3k):
     ``tests/_stream_fleet.py::stream_script`` at N=100,000 (``demo_apps``
     onto the five ``default_slices``, each slice's compute, memory and task
     slots grown by N / 48): ``build_cluster`` on the card, ``route`` with
     the counts zeroed just before and read just after (valid, no worse than
     the start, every app in one slice's partitions, the sweep, commit, pack
     and tier table kernels launched; a profiled repeat with the same
     digest: the idle share), four ``admit`` calls, the service records,
     ``rebalance`` after ``FaultInjector(5, seed=3, ...).schedule(30)`` with
     its own zeroed counts (valid, within the movement budget, the same
     kernels launched), a region outage and restore, one controller tick on
     the faulted fleet that ``sync`` adopts; each part timed; then the
     script at N=300 on the card and on the CPU's plain path, which must
     agree as phase 3e does.
  4. The dense serving slice: ``flash_attention`` and ``flash_decode`` against
     their plain versions at the serve path's shapes (prefill B=8, S=1024,
     H=16, KV=2, D=128 in bf16 and f32; a window + softcap case at D=256,
     H=16, KV=8; odd lengths; decode at B=8, Smax=1064 for kv_len 1, 17,
     1000, Smax and with a softcap), each timed beside its plain version and
     ``F.scaled_dot_product_attention`` (timed only, used nowhere; in bf16
     prefill also a control that the tolerance must reject; decode timed
     over cache copies past the L2), with each kernel's TFLOP/s or GB/s and
     its time as a multiple of SDPA's; then
     full-width ``qwen2.5-3b`` in bf16 with seeded random weights serves 16
     requests (prompts of 128-1024 tokens, 32 new tokens each) in 2 waves
     of 8 slots through ``ServeEngine``, with the launch counters zeroed
     just before and read just after (``flash_attention`` must have
     launched 36 x waves times, all on its tensor-core body, and
     ``flash_decode`` 36 x decode steps); TTFT and decode ms per step per
     wave, peak device memory; a repeat run must give the same tokens, and
     one wave's first decode logits must match a teacher-forced
     ``forward_train`` over its padded prompt plus that token; one profiled
     prefill (device time by kernel name) and one profiled decode step
     (idle share; one ``flash_decode`` kernel a call).
  5. The hybrid serving slice: ``ssd_chunk`` against its plain version on
     the card at the main path's shapes (x [8, 8, 128, 80, 64], N=64, timed
     beside its plain version and its bytes and operations bounds; wave 2's
     7 chunks; a reduced P=N=16 case, a 96-row and a 17-row case, 81 heads
     in ragged groups of 6, and x drawn 30 times larger) within 5e-5, with
     the heads a CTA of each, and ``flash_attention``
     and ``flash_decode`` at the shared block's H=KV=32, D=80; then
     full-width ``zamba2-2.7b`` in bf16 serves the same 16 requests in 2
     waves through ``ServeEngine`` with the same checks as phase 4 and the
     counts of ``ssd_chunk`` (54 a prefill), ``flash_attention`` (9 a
     prefill) and ``flash_decode`` (9 a step), zeroed just before; then the
     teacher-forced check of wave 1 once more with the whole model in f32,
     which must agree within 1e-3 of the largest logit.
  6. The training feeders at full-width ``smollm-360m`` (bf16, random
     weights drawn on the card): the three compression kernels
     (``compress_int8``, ``compress_bf16``, ``decompress_int8``) bit for bit
     against their plain versions (NaN as NaN) on g in bf16 and f32 at the
     shared edge cases (``kernels.compress.compress_edge_cases``: 1, 127,
     128, 129 and 960 elements, an all-zero block, ties at .5, NaN and inf,
     g 1e4 larger) and on the largest leaf (embed 49,152 x 960), timed there
     beside the plain versions, the bytes bound and, for bf16,
     ``.to(torch.bfloat16)`` alone; ``GradCompressor`` in bf16 and int8 mode,
     three steps of error feedback over the whole gradient tree, the launch
     counts zeroed just before each step and read just after (one compress
     launch a leaf, one int8 decompress a leaf), every leaf held bit for bit
     to the plain versions, ``wire_bytes`` the formula; ``CheckpointManager``
     on a ~5 GB train state (bf16 params, f32 moments and residuals): a
     blocking save from the card, a non-blocking save while the compressor
     runs, a restore onto the card leaf for leaf equal, keep=3 after four
     saves beside a torn ``.tmp`` directory, the disk's free space checked
     first; ``Recovery`` with a one-device mesh; the token pipeline
     (``Prefetcher`` at 64 x 2,048 and the reference launcher's 8 x 128, 32
     steps each copied to the card pinned, steps 0-3 equal to the CPU's
     batches; a slow consumer's stalls; a wedged one's
     ``BackpressureError``); ``attn_batch_shard`` on one forward of B=2,
     S=1024, bit for bit the logits without the flag with as many
     ``flash_attention`` launches.
  7. gemma2-9b at full width (every earlier model freed first): the
     windowed ``flash_decode`` against its plain version at gemma2's decode
     (B=8, Smax=8,192, H=16, KV=8, D=256, bf16, the SIMT body; window
     4,096, softcap 50 and none, kv_len 1, 17, 4,095, 4,096, 4,097, 4,160,
     8,000 and 8,192; f32 at three of them), the ring read (4,096 slots,
     no window, kv_len past them), timed at kv_len 8,000 over caches past
     the L2 beside the plain version, the bytes bound of the rows the
     window admits, SDPA over those rows (no softcap; timed only), the
     unwindowed global-layer call and the ring read; ``flash_attention`` at
     S=8,000, D=256, softcap 50, window 4,096 and none, held to its plain
     version and timed at B=1 and timed at B=8; then full-width gemma2-9b
     in bf16 (random weights from a seeded generator on the card) serves
     16 requests in 2 waves of 8 at max_seq 8,192 (wave 1's prompts
     4,050-4,090 tokens, so its decode crosses position 4,096; wave 2's
     7,000-8,150) through ``ServeEngine``, with the counts zeroed just
     before (``flash_attention`` 42 x waves, all on the tensor-core body;
     ``flash_decode`` 42 x steps); TTFT and decode ms a step per wave
     beside the step's bytes bound, peak memory, a repeat with the same
     tokens, each wave's first decode logits within 2^-4 of the largest
     logit of a ``prefill`` over the padded prompt plus that token, one
     profiled prefill and decode step; the same with ``ring_cache=True``
     (the local layers' caches 4,096 slots; each wave's first decode
     logits within 2^-4 of the full caches', the tokens that agree);
     reduced gemma2 in f32 on the card and the CPU, full and ring caches,
     a prefill past the window and decode across it, within 1e-4 of scale.
  8. granite-moe-1b-a400m at full width (gemma2 freed first): the two MoE
     kernels (``moe_dispatch``: routing, ranks, the capacity cut and the
     expert buffer; ``moe_combine``: the gated sum back to the tokens) bit
     for bit against their plain versions at every ``kernels.moe.MOE_CASES``
     case (granite's prefill, T=8,192, E=32, k=8, capacity 2,560, d=1,024,
     bf16, with left pads that overflow their experts, and decode, T=8,
     capacity 64; skewed drops; equal probabilities; deepseek's E=64, k=6,
     d=2,048; T=1; T=777; rows of no whole 16 bytes in f32 and f16), the
     combine with and without a shared expert, each timed at granite's two
     shapes beside its plain version and its bytes bound (no one library
     call computes either); ``flash_attention`` and ``flash_decode`` at
     granite's H=16, KV=8, D=64 in bf16 and f32; then full-width
     granite-moe-1b-a400m in bf16 (random weights from a seeded generator on
     the card) serves the 16 requests of phase 4 in 2 waves of 8 through
     ``ServeEngine``, the counts zeroed just before (``flash_attention`` 24
     x waves, all on the tensor-core body; ``flash_decode`` 24 x steps;
     ``moe_dispatch`` and ``moe_combine`` 24 x (waves + steps) each); TTFT
     and decode ms a step per wave beside the step's bytes bound, peak
     memory, a repeat with the same tokens, one profiled prefill and decode
     step; the assignments each prefill dropped, by layer and by slot; the
     serve's own dispatch and combine at the first MoE layer of its first
     prefill and first decode step held bit for bit to the plain versions
     on the inputs it gave them; wave 1's first decode logits within 2^-4
     of the largest logit of a ``prefill`` over the padded prompts plus that
     token, on every slot that lost no assignment in either run (slot 0 at
     least; the skipped slots printed); reduced granite and deepseek (with
     MLA, and with mla=False) in f32 on the card and the CPU within 1e-4 of
     scale.
  9. deepseek-v2-lite-16b at full width (granite freed first): both flash
     kernels with K's head dim 192 and V's 128 (MLA) against their plain
     versions at deepseek's prefill (B=8, S of wave 1, H=KV=16, bf16, on
     the tensor-core body) and decode (Smax 1,088, kv_len 1, 17, 1,000,
     Smax and the serve's, on the SIMT body), in f32, at an odd length,
     with a window and softcap, and at the reduced (24, 16) in f32, the
     prefill and decode timed beside their plain versions, bounds and SDPA
     (which takes a value dim of its own); then full-width
     deepseek-v2-lite-16b in bf16 (15.7 B parameters drawn on the card from
     a seeded generator, caches of 1,088 slots) serves the 16 requests of
     phase 4 in 2 waves of 8 through ``ServeEngine``, the counts zeroed just
     before (``flash_attention`` 27 x waves, all on the tensor-core body;
     ``flash_decode`` 27 x steps; ``moe_dispatch`` and ``moe_combine`` 26 x
     (waves + steps)); TTFT and decode ms a step per wave beside the step's
     bytes bound (``mla_step_bound_ms``), peak memory, a repeat with the
     same tokens, one profiled prefill and decode step, drops by layer and
     slot, the serve's own MoE launches held bit for bit to the plain
     versions, and phase 8's teacher-forced check on the slots without
     drops (slot 0 at least).
 10. phi-3-vision-4.2b at full width (deepseek freed first): both flash
     kernels at its D = 96 with H = KV = 32 against their plain versions
     (``flash_attention`` at B=8, S=1,024 in bf16 on the tensor-core body
     and in f32; ``flash_decode`` at B=8, Smax 1,088, kv_len 1, 17, 1,000,
     1,056 and 1,088, G=1, in bf16 on the body ``choose_body`` names and
     in f32, with a window and softcap, and at G=8 with odd lengths), each
     timed beside its plain version, its bound and SDPA, the decode also on
     the SIMT body (the wrapper's choice forced) for the choice of body;
     then full-width phi-3-vision-4.2b in bf16 (3.8 B parameters drawn on
     the card from a seeded generator) takes 8 sequences of 256 patch
     embeddings (seeded normal, bf16) and 768 text tokens: one ``prefill``
     and 32 ``decode_step``s, the counts zeroed just before
     (``flash_attention`` 32, all on the tensor-core body; ``flash_decode``
     32 x 32); TTFT, decode ms a step beside its bytes bound, peak memory,
     the idle share of one profiled step, a repeat with the same tokens,
     and the first decode logits within 2^-4 of the largest logit of
     ``forward_train`` over patches, text and that token; then the 16
     requests of phase 4 served text-only through ``ServeEngine`` (the
     reference's engine takes no images) with phase 4's checks; then
     reduced phi-3-vision in f32 on the card and the CPU within 1e-4 of
     scale.
 11. hubert-xlarge at full width (phi-3 freed first): ``flash_attention``
     bidirectional at D = 80, H = KV = 16 against its plain version at
     S=4,096 in bf16 (tensor-core body) and f32 and at odd lengths, timed
     there and at 32,768 beside SDPA (``is_causal=False``) and its bound;
     then full-width hubert-xlarge in bf16 (1.26 B parameters) encodes
     frames [2, 32,768, 1,280] (the reference's prefill_32k length, its
     batch cut from 32 to 2 for time): a warm ``prefill``, then one with
     the counts zeroed (48 ``flash_attention`` launches, all ``causal=False``
     on the tensor-core body) beside its operations bound, peak memory, a
     repeat with bit-identical logits, the forward's own layer-0 launch
     held to the plain version on its inputs (in query chunks), the idle
     share of a profiled forward; then reduced hubert in f32 on the card and
     the CPU, with and without a mask, within 1e-4 of scale.
 12. xlstm-125m at full width (hubert freed first): the two scan kernels
     (``mlstm_scan``, ``slstm_scan``) against their plain versions on the
     card at xlstm-125m's widths (B=8, H=4; Dh=384 for mLSTM, 192 for
     sLSTM with bf16 recurrent matrices) at S=1 and 17 from a seeded
     nonzero bf16 state (the state written back within one bf16 ulp of the
     plain version's) and at S=256 and 2,048 from an f32 one, and at the
     reduced widths (Dh=32, 16) at S=33, the gates drawn up to |20| so
     that the stabiliser switches branch, h within 1e-5 of its scale (the
     mLSTM's also within 1e-5 * kappa * |h|, kappa its denominator's
     cancellation factor), each timed at S=32,768 beside its bound (bytes
     or f32 operations; the sLSTM also its chain floor) and at S=2,048
     beside its plain version (no one PyTorch call computes either);
     then full-width xlstm-125m in bf16 (155.6 M parameters drawn on the
     card from a seeded generator) serves the 16 requests of phase 4 in 2
     waves of 8 through ``ServeEngine``, the counts zeroed just before
     (``mlstm_scan`` 10 x (waves + steps), ``slstm_scan`` 2 x (waves +
     steps), no flash launch), with phase 4's checks and each wave's
     decode ms a step beside its bytes bound; then the long context: 8
     sequences of 32,768 tokens (the reference's prefill_32k length, its
     batch cut from 32 to 8 for time), one ``prefill`` and 16
     ``decode_step``s with the counts zeroed (prefill seconds beside the
     linears' bf16 bound plus the scans', decode ms a step beside its
     bytes bound, peak memory, the cache's bytes equal to those at phase
     4's length), the prefill's own layer-0 ``mlstm_scan`` launch held to
     the plain version over all 32,768 steps, and the first decode step
     within 2^-3 of the largest logit of a 32,769-token prefill (two
     planted faults, the state not carried and one token stale, must read
     above that), and with the whole model in f32 (B=2) within 1e-3 of it;
     then
     reduced xlstm in f32 on the card and the CPU (logits and every cache
     leaf) within 1e-4 of scale.
 13. A ``{"kernels": [...]}`` line (the flash kernels' launches summed over
     the serving runs, gemma2's full and ring ones, granite's, deepseek's,
     phi-3-vision's image and text runs and hubert's forward included, with
     gemma2's, granite's, deepseek's, phi-3-vision's and hubert's shapes
     beside each; the MoE kernels' over phases 8 and 9's serves, timed at
     granite's prefill and its decode; the
     scheduling kernels' over the balance pass, the
     control loop, the service, the simulator's two pairs and the stream
     router's path, the shard-batched ones' over the measured fleet pass,
     the service and the simulator, the tier table's over every path that
     sweeps, the compression kernels' over phase 6's six compressor steps,
     the scans' over phase 12's serve and long context),
     then the card line again, then the final ``{"ok": true, "device":
     {...}}`` line.

``python3 chip_smoke.py --flash-probe SRC`` runs only the flash kernels of
the ``repro_torch`` package under SRC at the serving phases' equal head
dims and prints one JSON line of times and output digests (see
``flash_probe``).

``python3 chip_smoke.py --probe SRC`` runs only the balancing slice of the
``repro_torch`` package under SRC, with the rounding kernel on the main
path's P and every ``round_case`` kind at (131,072, 5, 2), and prints one
JSON line (see ``probe``):
run it on this tree's ``src`` and on a ``git archive`` of another commit's,
in turns, to compare the two on one card.

It imports nothing of JAX or of the JAX reference package.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth, the
# f32 rate outside the tensor cores and the dense bf16 and TF32 tensor-core
# rates.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
# f32 operations per (app, tier) pair as the kernels compute them (counted
# from csrc/move_eval.cu::pair_delta: 26 per resource, 24 for the task
# terms, 14 for movement + weighting; the best kernel adds the fit test's
# use, the mask and the running argmin).
BEST_OPS = {"per_resource": 26, "fixed": 42}
EVAL_OPS = {"per_resource": 23, "fixed": 36}
# Cycles the card spins before a timed run (about 50 ms at H100 clocks).
HEAD_START_CYCLES = 100_000_000
# Candidates a LocalSearch sweep commits from (LocalSearchConfig.batch_moves).
COMMIT_K = 16
# Sweeps of the unfused solve, of the sampled solve (the move_eval kernel's
# paths) and of the profiled solves; the sampled solve's temperature (a power
# of two, so -score / temperature is exact).
UNFUSED_SWEEPS = 32
SAMPLED_SWEEPS = 64
SAMPLED_TAU = 1.0
PROFILE_SWEEPS = 16
# Kernel names a profiled prefill lists.
PROFILE_TOP = 10
MOVE_EVAL_SRC = "src/repro_torch/kernels/csrc/move_eval.cu"
COMMIT_SRC = "src/repro_torch/kernels/csrc/commit.cu"
PACK_SRC = "src/repro_torch/kernels/csrc/pack.cu"
FLASH_ATTENTION_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_DECODE_SRC = "src/repro_torch/kernels/csrc/flash_decode.cu"
SSD_CHUNK_SRC = "src/repro_torch/kernels/csrc/ssd_chunk.cu"
OPTIMAL_ROUND_SRC = "src/repro_torch/kernels/csrc/optimal_round.cu"
# The optimal engine: the Adam steps timeout_s=30 maps to (TIMEOUT_BUDGETS),
# and the synthetic rounding inputs held against the plain version
# (N, T, R): the main path's shape, a tile edge plus one, no movers at
# T = 1, and ragged N with 17 tiers and 4 resources.
OPTIMAL_STEPS = 256
ROUND_SHAPES = ((131_072, 5, 2), (8_193, 5, 3), (1_001, 1, 1), (100_003, 17, 4))
# The rounding walk's chain floor a walked mover: one dependent f32 add, 4
# cycles on Volta and later SMs (the pack's chain, an add and a compare on
# it, takes 8).
ROUND_CHAIN_CYCLES = 4
# The control loop (phase 3g): 12 ticks of ``BalanceController.step`` at the
# slice's N=100,000 with a LoadShedder serving at most 0.8 of capacity: ticks
# 0-1 at base load, 2-4 with the offered load at 1.15 x that target, 5-8 at
# base load, 9-10 with telemetry collected 3 ticks before ``now`` (health
# 0.5, under CONSERVATIVE's 0.7), 11 fresh; 64 arrivals priced a tick; the
# same schedule at N=300 on the card and on the CPU's plain path.
CONTROL_TICKS = 12
CONTROL_OVERLOAD = 1.15
CONTROL_TARGET = 0.8
CONTROL_ARRIVALS = 64
CONTROL_SMALL_N = 300
# The sharded fleet (phase 3h): the reference's own million-app case
# (benchmarks/solver_scale.py::bench_shard_scale: synthetic_fleet(N,
# num_tiers=64, seed=9), FleetConfig(num_shards=8, timeout_s=30)), the
# buckets the reference's CPU run recorded for it and its objective there
# (BENCH_solver.json shard_scale/N1000000_S8; printed for information, not
# a gate), the second shape the batched kernels are held at (32 shards:
# 65,536 x 3), the shards each check leaves inactive, and the delta pass's
# dirty shards.
FLEET_APPS = 1_000_000
FLEET_TIERS = 64
FLEET_SEED = 9
FLEET_SHARDS = 8
FLEET_BUCKETS = (131_072, 9)
FLEET_REFERENCE_OBJECTIVE = 20.95606803894043
FLEET_WIDE_SHARDS = 32
FLEET_INACTIVE = {FLEET_SHARDS: (1, 5), FLEET_WIDE_SHARDS: tuple(range(0, 32, 4))}
FLEET_DIRTY = (0, 3)
# The streaming service (phase 3i): benchmarks/sim_scenarios.py::
# bench_service_ingest at fleet size (generate_cluster(num_apps=100_000,
# seed=7), ControllerConfig(timeout_s=30), the default ServiceConfig's 4
# shards), on the measured-latency stack (levels netlat + host) with the
# netlat plane armed as src/repro/sim/harness.py:344-372 arms it: a
# LinkSketchBank fed by LinkMeasurementSource(seed=31) every tick,
# calibrated after 4 ticks.  ``fleet_service_events`` gives each tick's
# events.  The N=300 stream the card is held to the CPU on is
# tests/_service_stream.py's.
SERVICE_FLEET_APPS = 100_000
SERVICE_FLEET_SEED = 7
SERVICE_FLEET_TICKS = 16
SERVICE_FLEET_COOLDOWN = 3
SERVICE_FLEET_TIMEOUT_S = 30
SERVICE_FLEET_MOVERS = 64
SERVICE_PRODUCERS = 4
SERVICE_PRODUCER_EVENTS = 4
SERVICE_SOURCE_SEED = 31
SERVICE_CALIBRATE_TICKS = 4
# The fleet simulator (phase 3j): two scenarios of the registry
# (src/repro_torch/sim/scenario.py) at the balancing slice's fleet size,
# seed 0, each for two diurnal periods (the registry's period is
# max(16, ticks // 2)); the reference's default horizon is 160 ticks.
# tier_drain runs the global path with declared advisories and a movement
# budget, fleet_scale the sharded route (S=2).  The card is held to the CPU
# on tier_drain at N=300, both stepping the workload with the same host
# draws (tests/_sim_world.py::host_draws).
# The stream router and the fault path (phase 3k): tests/_stream_fleet.py's
# script (demo_apps onto the five default slices, each grown by N / 48) at
# the balancing slice's fleet size, and at N=300 on the card and the CPU.
STREAM_APPS = 100_000
STREAM_SMALL_N = 300
# A sweep's whole call launches the tier table kernel and the sweep kernel;
# the tier table's torch ops took 8 launches before it was a kernel.
SWEEP_CALL_MAX_LAUNCHES = 9
SIM_APPS = 100_000
SIM_TICKS = 32
SIM_SCENARIOS = ("tier_drain", "fleet_scale")
SIM_SMALL_N = 300
SIM_SMALL_TICKS = 24
SIM_DRAW_SEED = 0

# The serving slice: full-width qwen2.5-3b, 16 requests in waves of 8 slots,
# prompts of 128-1024 tokens drawn from the seed, 32 new tokens each; the
# cache holds the longest prompt, the new tokens and the reference CLI's 8
# spare positions.
SERVE_ARCH = "qwen2.5-3b"
# The hybrid serving slice: full-width zamba2-2.7b on the same requests.
HYBRID_ARCH = "zamba2-2.7b"
SERVE_SEED = 0
SERVE_REQUESTS = 16
SERVE_SLOTS = 8
SERVE_NEW = 32
PROMPT_MIN, PROMPT_MAX = 128, 1024
SERVE_MAX_SEQ = PROMPT_MAX + SERVE_NEW + 8


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """A serving run's requests and cache: prompt lengths uniform in one
    (lo, hi) for every request, or in one (lo, hi) a wave in serving order;
    ``max_seq`` positions a slot; ``requests`` served ``slots`` at a time,
    ``new`` tokens each."""
    prompt_ranges: tuple
    max_seq: int
    requests: int = SERVE_REQUESTS
    slots: int = SERVE_SLOTS
    new: int = SERVE_NEW


DENSE_SPEC = ServeSpec(((PROMPT_MIN, PROMPT_MAX),), SERVE_MAX_SEQ)
# The gemma2 serving slice (phase 7): full-width gemma2-9b at its 8,192
# context, 16 requests with the same SLO draws and 32 new tokens each; wave
# 1's prompts of 4,050-4,090 tokens, so that its decode steps cross
# position 4,096 (the local layers' window, and the ring's wrap with
# ring_cache), wave 2's of 7,000-8,150, so that a local layer reads half of
# what a global one does.  The windowed decode kernel is held to its plain
# version at gemma2's decode shape at GEMMA2_DECODE_LENS and timed at
# GEMMA2_TIMED_LEN; the prefill kernel at GEMMA2_PREFILL_LEN; reduced
# gemma2 runs on card and CPU for GEMMA2_SMALL = (B, prompt, decode steps,
# max_seq).
GEMMA2_ARCH = "gemma2-9b"
GEMMA2_SPEC = ServeSpec(((4050, 4090), (7000, 8150)), 8192)
GEMMA2_DECODE_LENS = (1, 17, 4095, 4096, 4097, 4160, 8000, 8192)
GEMMA2_TIMED_LEN = 8000
GEMMA2_PREFILL_LEN = 8000
GEMMA2_SMALL = (2, 20, 12, 40)
# Card against CPU on reduced configs in f32: the parity tests' bound.
SMALL_REL = 1e-4
# The flash kernels against their plain versions, (atol, rtol).  f32: the
# reference's flash test tolerance.  bf16: kernel and plain version both
# compute in f32 and round the output once, so they part by at most one
# bf16 ulp (<= 2^-7 of the value) where their f32 sums straddle a rounding
# point; the atol covers outputs near zero.  A kernel that rounds its
# probabilities to bf16 before P.V, as SDPA does, parts by more: SDPA is
# held against the same bound as a control that must fail.
FLASH_TOL = {"float32": (3e-5, 3e-5), "bfloat16": (2e-3, 2.0 ** -7)}
# Bytes a timed decode rotates through, over the 50 MB L2: on the serve
# path each layer reads its own cache cold behind the weights.
L2_FLUSH_BYTES = 100e6
# Teacher-forced consistency at full width in bf16: the decode step and the
# forward pass run different kernels and different matmul shapes, so their
# bf16 roundings part from the first layer on and add up over 36 layers;
# a wrong position or mask moves logits by O(max |logit|).
TEACHER_TOL = 2.0 ** -4
# The same check with everything in f32 (Zamba2): the reduced f32 configs
# agree to ~4e-7 of scale on the CPU, so a gap of 1e-3 of the largest logit
# or more is a fault between the chunked scan and the one-step path, not
# rounding.
TEACHER_F32_TOL = 1e-3
# The SSD chunk kernel against its plain version (abs and rel, on y, state
# and cum): the reference's kernel tolerance, on its test's input draws
# (dt uniform in [1e-3, 0.1], A in [-2, -0.5]).
SSD_TOL = 5e-5
# The training feeders (phase 6): smollm-360m at its published widths (the
# reference launcher's default --arch), bf16 weights drawn on the card from
# FEEDER_SEED; three compression steps of error feedback a mode; a
# train-state checkpoint kept 3 deep; the token pipeline at SmolLM's 2,048
# context (64 x 2,048 a batch) and at the reference launcher's defaults
# (8 x 128), 32 steps each; attn_batch_shard on one forward of B=2, S=1024.
FEEDER_ARCH = "smollm-360m"
FEEDER_SEED = 32
COMPRESS_STEPS = 3
CKPT_KEEP = 3
STREAM_CASES = ({"vocab_size": 49_152, "seq_len": 2048, "global_batch": 64,
                 "num_partitions": 16, "prefetch": 2},
                {"vocab_size": 49_152, "seq_len": 128, "global_batch": 8})
STREAM_STEPS = 32
ATTN_SHARD_SHAPE = (2, 1024)
COMPRESS_SRC = "src/repro_torch/kernels/csrc/compress.cu"
# The MoE serving slice (phase 8): full-width granite-moe-1b-a400m serves the
# same 16 requests as phase 4 (DENSE_SPEC).  The MoE kernels are held to
# their plain versions at every kernels.moe.MOE_CASES case and timed at
# MOE_TIMED (granite's prefill and decode shapes); reduced granite and
# deepseek (with MLA, and with mla=False) run on card and CPU for MOE_SMALL =
# (B, prompt, decode steps, max_seq).
MOE_ARCH = "granite-moe-1b-a400m"
MOE_SRC = "src/repro_torch/kernels/csrc/moe.cu"
MOE_REPLACES = {"moe_dispatch": "src/repro/models/moe.py:71",
                "moe_combine": "src/repro/models/moe.py:115"}
MOE_TIMED = ("granite_prefill", "granite_decode")
MOE_SMALL = (2, 12, 4, 20)
# The MLA serving slice (phase 9): full-width deepseek-v2-lite-16b serves the
# same 16 requests as phase 4 with caches of MLA_SPEC.max_seq = 1,088 slots
# (17 whole 64-row tiles), its attention with K's head dim 192 (128 + 64
# rope dims) and V's 128.  The flash kernels are held to their plain
# versions at those dims (and the reduced 24 and 16) at its prefill and
# decode shapes, an odd length, a window with a softcap and in f32.
# An expert's capacity at its prefill (955 at wave 1) is below the longest
# prompts, so slot 0's own tokens can overflow an expert and phase 8's
# teacher-forced rule may hold no slot; the teacher-forced check then runs
# again with nothing dropped (every capacity raised past T), in bf16 at full
# depth holding slot 0, and in f32 at MLA_F32_LAYERS layers holding every
# slot (TEACHER_F32_TOL).
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_SPEC = ServeSpec(((PROMPT_MIN, PROMPT_MAX),), 1088)
MLA_F32_LAYERS = 4
# The VLM slice (phase 10): full-width phi-3-vision-4.2b; VLM_BATCH sequences,
# each the config's 256 patch embeddings (seeded normal, bf16) and VLM_TEXT
# text tokens, one prefill and VLM_STEPS decode steps on caches of
# VLM_MAX_SEQ = 1,088 slots (17 whole 64-row tiles); then the 16 requests of
# phase 4 served text-only through ServeEngine (the reference's engine takes
# no images).
VLM_ARCH = "phi-3-vision-4.2b"
VLM_BATCH = 8
VLM_TEXT = 768
VLM_STEPS = 32
VLM_MAX_SEQ = 1088
# The audio slice (phase 11): full-width hubert-xlarge encodes AUDIO_BATCH x
# AUDIO_LEN frames bidirectionally: the reference's prefill_32k length
# (configs/shapes.py), its batch cut from 32 to 2 for time.  The bidirectional
# kernel is held to its plain version at AUDIO_CHECK_LEN (the plain version's
# f32 logits at 32,768 would take 137 GB), the serve's own layer-0 launch in
# query chunks of AUDIO_CHUNK rows.
AUDIO_ARCH = "hubert-xlarge"
AUDIO_BATCH = 2
AUDIO_LEN = 32768
AUDIO_CHECK_LEN = 4096
AUDIO_CHUNK = 1024
# The xLSTM slice (phase 12): full-width xlstm-125m serves the 16 requests of
# phase 4 (DENSE_SPEC); then a long context of XLSTM_LONG = (batch, tokens):
# the reference's prefill_32k length (configs/shapes.py), its batch of 32 cut
# to 8 for time, one prefill and XLSTM_LONG_STEPS decode steps.  The scans
# are held to their plain versions at xlstm-125m's widths at
# XLSTM_CHECK_STEPS (S = 1 and 17 from a nonzero bf16 state, the cache's
# dtype; 256 and 2,048 from a nonzero f32 one) and at the reduced widths at
# XLSTM_SMALL_STEPS, each timed at XLSTM_LONG's length and its plain
# version at XLSTM_PLAIN_STEPS.  Gates drawn up to |20|
# (kernels.xlstm.GATE_RANGE), so that the stabiliser m switches branch.
XLSTM_ARCH = "xlstm-125m"
XLSTM_SRC = "src/repro_torch/kernels/csrc/xlstm.cu"
XLSTM_REPLACES = {"mlstm_scan": "src/repro/models/xlstm.py:104",
                  "slstm_scan": "src/repro/models/xlstm.py:183"}
XLSTM_CHECK_STEPS = (1, 17, 256, 2048)
XLSTM_SMALL_STEPS = 33
XLSTM_PLAIN_STEPS = 2048
XLSTM_LONG = (8, 32768)
XLSTM_LONG_STEPS = 16
# The first decode step after the long prefill against a prefill one token
# longer: in bf16 within XLSTM_LONG_TOL of the largest logit (the bf16
# cache rounds C, n and m, m to 2^-8 of itself, once at the prefill's end;
# the decode's conv rounds once where the prefill's rounds term by term;
# and the projections round their other-shaped sums: 0.0698 measured on
# the H100, above phase 4's 2^-4; the reference's own decode parts from its
# longer prefill as much at reduced width, tests/test_torch_xlstm.py).  Two
# planted faults, the state not carried and the state one token stale, are
# read the same way each run and must read above the limit.  The check runs
# again with the whole model in f32 at batch XLSTM_LONG_F32_BATCH within
# TEACHER_F32_TOL, where only the sums' order is left.
XLSTM_LONG_TOL = 2.0 ** -3
XLSTM_LONG_F32_BATCH = 2
# The scans against their plain versions (kernels.xlstm.compare_scan): 1e-5
# of each output's scale (both carry the state in f32, the sums run in
# another order); the mLSTM's h also within 1e-5 * kappa * |h|
# (kernels.xlstm.mlstm_condition: where the denominator's dot n . q nearly
# cancels, h has few correct digits in any order); a bf16 state written back
# within one bf16 ulp beyond that 1e-5 of its scale (where c' = f c + i z
# nearly cancels, the f32 difference is many ulps of the small result).
# f32 operations a step beyond the Dh^2 terms, the least the recurrence
# needs (transcendentals counted as one): the mLSTM's per-head scalars (the
# gates, the stabiliser, the denominator) and its 8 a row (k / sqrt(Dh), n's
# update, n . q, i times v, h's division); the sLSTM's 25 an element (four
# pre-activation adds, the gates, the cell).
MLSTM_STEP_OPS = 15
MLSTM_ROW_OPS = 8
SLSTM_ELEMENT_OPS = 25
# The sLSTM's chain floor a step: the pre-activation's dot over Dh summed as a
# tree, ceil(log2 Dh) dependent adds and the add of w, 4 cycles each.
FMA_LATENCY_CYCLES = 4
REDUCED_STEPS = 4
COMPRESS_REPLACES = {"compress_int8": "src/repro/distributed/compress.py:57",
                     "compress_bf16": "src/repro/distributed/compress.py:53",
                     "decompress_int8": "src/repro/distributed/compress.py:85"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds per call, from CUDA events recorded between
    consecutive calls.  The card is first held busy (``torch.cuda._sleep``)
    while the host enqueues the calls, so a short kernel is timed on the
    card and not at the host's launch rate; a call whose host work outlasts
    that head start (the plain packing loop) is timed with its host gaps."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(HEAD_START_CYCLES)
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    times = sorted(events[i].elapsed_time(events[i + 1]) for i in range(reps))
    return times[len(times) // 2]


def bound_ms(nbytes: float, nops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_bytes(N: int, T: int, R: int, best: bool) -> float:
    """Bytes the sweep function must move: its inputs read once (per app
    R+2 f32 values and two i32 tiers; per tier 3R+3 f32 values: capacity,
    ideal fractions and loads, and their task-count analogues; the weights),
    its outputs written once, and for the best variant the bool feasibility
    mask, the budget and (score, tier) per app."""
    inputs = N * ((R + 2) * 4 + 2 * 4) + T * (3 * R + 3) * 4 + 5 * 4
    if best:
        return inputs + N * T + 4 + N * 8
    return inputs + N * T * 4


def sweep_ops(N: int, T: int, R: int, best: bool) -> float:
    c = BEST_OPS if best else EVAL_OPS
    return float(N) * T * (c["per_resource"] * R + c["fixed"])


def random_sweep(N: int, T: int, device, scale_capacity: bool):
    """The reference's random kernel inputs (``kernels.ref``), with capacity
    and task limits scaled by N / (50 T) at the large shapes so that tiers
    are not all overloaded (which would make every move infeasible)."""
    import numpy as np
    import torch
    from repro_torch.kernels.ref import random_problem_arrays

    args = list(random_problem_arrays(N, T, seed=N + T, device=device))
    if scale_capacity:
        s = max(1.0, N / (50.0 * T))
        args[5] = args[5] * s
        args[6] = args[6] * s
    rng = np.random.default_rng(N)
    feas = torch.as_tensor(rng.random((N, T)) > 0.2, device=device)
    return tuple(args), feas


def tier_stats_work(T: int, R: int, S: int = 1) -> tuple[float, float]:
    """Bytes and f32 operations of the sweeps' tier table for S problems:
    capacity, loads, task limits and task loads read once; f, g, their R + 1
    means and the two inverses written once; a division and a reciprocal a
    (tier, resource) and a tier, T additions and a multiply a mean."""
    nbytes = S * 4 * ((2 * T * R + 2 * T) + (2 * T * R + 2 * T + R + 1))
    nops = S * (2 * T * R + 2 * T + (T + 1) * (R + 1))
    return float(nbytes), float(nops)


def check_tier_stats(label, args, record) -> None:
    """The tier table kernel against ``tier_stats_ref`` on the card, bit for
    bit: for the sweep's problem and for a stack of it, its tiers reversed
    (another summing order) and it again."""
    import torch
    from repro_torch.kernels import move_eval as K
    from repro_torch.kernels.ref import tier_stats_ref

    one = tuple(args[i] for i in (5, 6, 9, 10))
    stacked = tuple(torch.stack([x, x.flip(0), x]) for x in one)
    err = 0.0
    for ins in (one, stacked):
        got, want = K.tier_stats_cuda(*ins), tier_stats_ref(*ins)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, float((g - w).abs().max()))
            if not (g.shape == w.shape and torch.equal(g, w)):
                raise AssertionError(f"tier_stats {label}: max abs err {err:.3e} (must be 0)")
    record["tier_stats"]["max_abs_err"] = max(record["tier_stats"]["max_abs_err"], err)
    print(f"tier_stats     {label:>16}: one problem and a stack of 3, max abs err {err:.1e}",
          flush=True)


def check_tier_mean(label, args, record) -> None:
    """The objective's mean kernel against ``core.means.tier_mean`` on the
    card, value and gradient bit for bit: the sweep's load fractions f[T, R]
    (keepdim, as the objective takes them), the task fractions g[T] and a
    stack [3, T, R] of f."""
    import torch
    from repro_torch.core.means import tier_mean
    from repro_torch.kernels import move_eval as K

    f, g = args[9] / args[5], args[10] / args[6]
    err = 0.0
    for x, dim, keepdim in ((f, 0, True), (g, 0, False),
                            (torch.stack([f, f.flip(0), f]), -2, False)):
        xs = [x.clone().requires_grad_(True) for _ in range(2)]
        got, want = K.tier_mean_cuda(xs[0], dim, keepdim), tier_mean(xs[1], dim, keepdim)
        up = torch.linspace(-1.0, 1.0, want.numel(), device=x.device).reshape(want.shape)
        grads = [torch.autograd.grad(y, xi, up)[0] for y, xi in zip((got, want), xs)]
        torch.cuda.synchronize()
        err = max(err, float((got - want).detach().abs().max()),
                  float((grads[0] - grads[1]).abs().max()))
        if not (got.shape == want.shape and torch.equal(got, want)
                and torch.equal(grads[0], grads[1])):
            raise AssertionError(f"tier_mean {label}: max abs err {err:.3e} (must be 0)")
    record["tier_mean"]["max_abs_err"] = max(record["tier_mean"]["max_abs_err"], err)
    print(f"tier_mean      {label:>16}: f, g and a stack of 3, value and gradient, max abs err "
          f"{err:.1e}", flush=True)


def check_sweep(label, args, feas, moves_left_values, record, dev):
    """Hold both move_eval kernels against core.delta on the card; the best
    kernel also with the caller's totals against the wrapper's own."""
    import torch
    from repro_torch.core.delta import move_best_per_app, move_delta_cost
    from repro_torch.kernels import move_eval as K

    N = args[0].shape[0]
    check_tier_stats(label, args, record)
    check_tier_mean(label, args, record)
    totals = K.sweep_totals(args[1], args[2])
    inputs = K.eval_inputs(*args, totals=totals)
    d_kernel = K.launch_move_eval(inputs)
    d_absent = K.move_eval_cuda(*args)
    d_plain = move_delta_cost(*args)
    torch.cuda.synchronize()
    err = float((d_kernel - d_plain).abs().max())
    if not (torch.equal(d_kernel, d_plain) and torch.equal(d_absent, d_kernel)):
        raise AssertionError(f"move_eval {label}: max abs err {err:.3e} (must be 0), totals "
                             f"given = absent {torch.equal(d_absent, d_kernel)}")
    record["move_eval"]["max_abs_err"] = max(record["move_eval"]["max_abs_err"], err)
    line = f"move_eval      {label:>16}: max abs err {err:.1e}, totals given = absent"
    for ml in moves_left_values:
        moves_left = torch.tensor(ml, dtype=torch.int32, device=dev)
        s_k, t_k = K.launch_move_eval_best(K.best_inputs(*args, feas, moves_left))
        s_g, t_g = K.move_eval_best_cuda(*args, feas, moves_left, totals=totals)
        s_p, t_p = move_best_per_app(*args, feas, moves_left)
        torch.cuda.synchronize()
        if not (torch.equal(s_k, s_g) and torch.equal(t_k, t_g)):
            raise AssertionError(f"move_eval_best {label} ml={ml}: the caller's totals give "
                                 "another result than the wrapper's")
        finite = torch.isfinite(s_p)
        if not torch.equal(torch.isfinite(s_k), finite):
            raise AssertionError(f"move_eval_best {label} ml={ml}: +inf sets differ")
        if bool(finite.any()):
            scale_b = float(s_p[finite].abs().max()) + 1e-9
            err_b = float((s_k[finite] - s_p[finite]).abs().max())
        else:
            scale_b, err_b = 1.0, 0.0
        if not err_b / scale_b <= 1e-5:
            raise AssertionError(f"move_eval_best {label}: scaled error {err_b / scale_b:.3e}")
        differ = finite & (t_k != t_p)
        ties = int(differ.sum())
        if ties:
            rows = torch.nonzero(differ).squeeze(1)
            gap = (d_plain[rows, t_k[rows].long()] - d_plain[rows, t_p[rows].long()]).abs()
            if not float(gap.max()) / scale_b < 1e-6:
                raise AssertionError(f"move_eval_best {label}: tiers differ beyond a tie "
                                     f"(gap {float(gap.max()) / scale_b:.3e})")
        record["move_eval_best"]["max_abs_err"] = max(
            record["move_eval_best"]["max_abs_err"], err_b)
        record["move_eval_best"]["ties"] += ties
        line += (f" | best ml={ml}: finite {int(finite.sum())}/{N}, "
                 f"max abs err {err_b:.3e}, tie-flipped tiers {ties}, totals given = absent")
    print(line, flush=True)
    return inputs


def scalar_division_check(args) -> tuple[int, int, int]:
    """The one operation the sweep kernels do not repeat: on a card the plain
    version's d_mean = (dC_dst - dC_src) / T divides by a host scalar, which
    PyTorch runs as a multiply by its reciprocal, where the kernels divide.
    Returns, at these inputs, the quotients (resources and tasks) that differ
    between the two, all quotients, and the sums mean + d_mean that differ."""
    import torch
    from repro_torch.core.means import tier_mean

    demand, tasks, cap, klim, util, tier_tasks = (args[i] for i in (0, 1, 5, 6, 9, 10))
    T = cap.shape[0]
    src = args[3].long()
    f, g = util / cap, tier_tasks / klim
    pairs = ((demand[:, None, :] / cap[None] - (demand / cap[src])[:, None, :],
              tier_mean(f, 0)),
             (tasks[:, None] / klim[None] - (tasks / klim[src])[:, None], tier_mean(g, 0)))
    differ = total = sums = 0
    for diff, mean in pairs:
        by_host = diff / T
        divided = diff / torch.tensor(float(T), device=diff.device)
        differ += int((by_host != divided).sum())
        total += diff.numel()
        sums += int((mean + by_host != mean + divided).sum())
    return differ, total, sums


def time_sweep(args, feas, inputs, dev) -> dict:
    """Median ms of each sweep: as the whole call from the solver's
    arguments (with the totals the solver passes), without the totals, and
    the kernel alone on precomputed inputs (``inputs``: ``check_sweep``'s
    for ``move_eval``); each beside its plain version and its bound."""
    import torch
    from repro_torch.core.delta import move_best_per_app, move_delta_cost
    from repro_torch.core.means import tier_mean
    from repro_torch.kernels import move_eval as K
    from repro_torch.kernels.ref import tier_stats_ref

    N, R = args[0].shape
    T = args[5].shape[0]
    ml = torch.tensor(5, dtype=torch.int32, device=dev)
    totals = K.sweep_totals(args[1], args[2])
    best_in = K.best_inputs(*args, feas, ml, totals=totals)
    out = {}
    b, by = bound_ms(sweep_bytes(N, T, R, False), sweep_ops(N, T, R, False))
    out["move_eval"] = {"ms": time_ms(lambda: K.launch_move_eval(inputs)),
                        "whole_call_ms": time_ms(lambda: K.move_eval_cuda(*args, totals=totals)),
                        "absent_ms": time_ms(lambda: K.move_eval_cuda(*args)),
                        "plain_ms": time_ms(lambda: move_delta_cost(*args)),
                        "bound_ms": b, "bound_by": by}
    b, by = bound_ms(sweep_bytes(N, T, R, True), sweep_ops(N, T, R, True))
    out["move_eval_best"] = {
        "ms": time_ms(lambda: K.move_eval_best_cuda(*args, feas, ml, totals=totals)),
        "absent_ms": time_ms(lambda: K.move_eval_best_cuda(*args, feas, ml)),
        "kernel_ms": time_ms(lambda: K.launch_move_eval_best(best_in)),
        "plain_ms": time_ms(lambda: move_best_per_app(*args, feas, ml)),
        "bound_ms": b, "bound_by": by}
    tier_in = tuple(args[i] for i in (5, 6, 9, 10))
    b, by = bound_ms(*tier_stats_work(T, R))
    out["tier_stats"] = {"ms": time_ms(lambda: K.tier_stats_cuda(*tier_in)),
                         "plain_ms": time_ms(lambda: tier_stats_ref(*tier_in)),
                         "bound_ms": b, "bound_by": by}
    f = args[9] / args[5]                 # the objective's load fractions [T, R]
    b, by = bound_ms(4.0 * (T * R + R), float(T * R + R))
    out["tier_mean"] = {"ms": time_ms(lambda: K.tier_mean_cuda(f, 0, True)),
                        "plain_ms": time_ms(lambda: tier_mean(f, 0, True)),
                        "library_ms": time_ms(lambda: torch.mean(f, dim=0, keepdim=True)),
                        "bound_ms": b, "bound_by": by}
    return out


def print_sweep_times(where: str, times: dict) -> None:
    t = times["move_eval"]
    print(f"  time      move_eval {where}: whole call {t['whole_call_ms']:.4f} ms (totals "
          f"given; {t['absent_ms']:.4f} ms without), kernel alone {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
    t = times["move_eval_best"]
    print(f"  time move_eval_best {where}: whole call {t['ms']:.4f} ms (totals given; "
          f"{t['absent_ms']:.4f} ms without), kernel alone {t['kernel_ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
    t = times["tier_stats"]
    print(f"  time     tier_stats {where}: {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"bound {t['bound_ms']:.6f} ms ({t['bound_by']})", flush=True)
    t = times["tier_mean"]
    print(f"  time      tier_mean {where} (f[T, R]): {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
          f"ms, torch.mean {t['library_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
          f"({t['bound_by']})", flush=True)


def commit_inputs(args, feas, moves_left, dev):
    """The commit scan's inputs for one sweep of ``args``: the top-COMMIT_K
    candidates of the ``move_eval_best`` kernel's scores (launched directly,
    so it adds no count), the tier totals and the budget."""
    import torch
    from repro_torch.kernels import move_eval as K

    ml = torch.tensor(moves_left, dtype=torch.int32, device=dev)
    totals = K.sweep_totals(args[1], args[2])
    best_s, best_t = K.launch_move_eval_best(K.best_inputs(*args, feas, ml, totals=totals))
    cand_n = torch.sort(best_s, stable=True).indices[:COMMIT_K]
    return cand_n, best_s, best_t, totals, ml


def commit_config() -> tuple[float, float]:
    """(-tol as f32, batch_quality) of the solver's default configuration."""
    import numpy as np
    from repro_torch.core.solver_local import LocalSearchConfig

    cfg = LocalSearchConfig()
    return float(np.float32(-cfg.tol)), cfg.batch_quality


def commit_call(fn, args, inputs, state):
    """Run a commit implementation on ``state`` = (x, util, tier_tasks),
    which it updates in place; returns the status tensor."""
    (demand, tasks, crit, _, a0, cap, klim, ideal, ideal_t, _, _, w) = args
    cand_n, best_s, best_t, totals, ml = inputs
    x, util, tt = state
    neg_tol, batch_quality = commit_config()
    return fn(cand_n, best_s, best_t, x, util, tt, demand, tasks, crit, a0, cap, klim,
              ideal, ideal_t, w, totals, ml, neg_tol=neg_tol, batch_quality=batch_quality)


def commit_work(args, inputs, x_before, x_after, neg_tol: float) -> tuple[float, float]:
    """(bytes, f32 ops) the commit scan needs on these inputs, replayed in
    numpy with the accept set the run produced: per examined candidate its
    id, score, tier and two assignments; per screened one its demand and
    tasks and (R+1) fit tests; per exact re-check (screened, not the first)
    the O(T(R+1)) tier means and ~26 ops per resource plus ~40; the tier
    state read once and written once, and the accepted assignments."""
    import numpy as np

    (demand, tasks, _, _, a0, cap, klim, _, _, util, tt, _) = (
        a.cpu().numpy() for a in args)
    cand_n, best_s, best_t, _, ml = inputs
    n_all = cand_n.cpu().numpy()
    s_all, t_all = best_s.cpu().numpy()[n_all], best_t.cpu().numpy()[n_all]
    xb, xa = x_before.cpu().numpy(), x_after.cpu().numpy()
    T, R = cap.shape
    util, tt, left = util.copy(), tt.copy(), int(ml)
    nbytes = T * (3 * R + 3) * 4 + 5 * 4 + 2 * 4 + 4 + T * (R + 1) * 4 + 8
    nops = 0.0
    for i, (n, s, t) in enumerate(zip(n_all, s_all, t_all)):
        nbytes += 8 + 8 + 8
        nops += 1
        if not s < neg_tol:
            break
        src, home = int(xb[n]), int(a0[n])
        if t == src:
            continue
        already = src != home
        nbytes += 4 * (R + 1)
        nops += 3 * (R + 1)
        fits = (np.all(util[t] + demand[n] <= cap[t] + np.float32(1e-6))
                and tt[t] + tasks[n] <= klim[t] + np.float32(1e-6))
        if not (fits and (already or left > 0)):
            continue
        if i > 0:
            nbytes += 4
            nops += 2 * T * (R + 1) + (R + 1) + 26 * R + 40
        if xa[n] != xb[n]:
            util[src] -= demand[n]
            util[t] += demand[n]
            tt[src] -= tasks[n]
            tt[t] += tasks[n]
            left -= (-1 if t == home else 0) if already else 1
            nbytes += 4
            nops += 2 * (R + 1)
    return float(nbytes), float(nops)


def check_commit(label, args, feas, moves_left, record, dev) -> dict:
    """Hold the commit kernel against its plain version on the card: the
    same status, accepted moves and tier loads, bit for bit (the kernel adds
    in the same order); then time both."""
    import torch
    from repro_torch.kernels.commit import commit_topk_cuda
    from repro_torch.kernels.ref import commit_topk_ref

    inputs = commit_inputs(args, feas, moves_left, dev)
    x0, util0, tt0 = args[3], args[9], args[10]

    def fresh():
        return (x0.clone(), util0.clone().contiguous(), tt0.clone().contiguous())

    got_state, want_state = fresh(), fresh()
    got = commit_call(commit_topk_cuda, args, inputs, got_state)
    want = commit_call(commit_topk_ref, args, inputs, want_state)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"commit_topk {label}: status {got.tolist()} != {want.tolist()}")
    if not torch.equal(got_state[0], want_state[0]):
        raise AssertionError(f"commit_topk {label}: the accepted moves differ")
    err = max(float((got_state[i] - want_state[i]).abs().max()) for i in (1, 2))
    if not all(torch.equal(got_state[i], want_state[i]) for i in (1, 2)):
        raise AssertionError(f"commit_topk {label}: tier loads differ, max abs {err:.3e}")
    record["commit_topk"]["max_abs_err"] = max(record["commit_topk"]["max_abs_err"], err)

    nbytes, nops = commit_work(args, inputs, x0, got_state[0], commit_config()[0])
    b, by = bound_ms(nbytes, nops)
    pool = [fresh() for _ in range(24)]
    ms = time_ms(lambda: commit_call(commit_topk_cuda, args, inputs, pool.pop()))
    pool = [fresh() for _ in range(6)]
    plain_ms = time_ms(lambda: commit_call(commit_topk_ref, args, inputs, pool.pop()),
                       reps=5, warmup=1)
    improving, accepted = got.tolist()
    print(f"commit_topk    {label:>22}: k={COMMIT_K}, improving {improving}, accepted "
          f"{accepted}, max abs err {err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of 5), bound {b:.8f} ms ({by})", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by}


def pack_work(dem, capacity, hosts, pad: int) -> tuple[float, float]:
    """(bytes, f32 ops) the packing function needs on these inputs: the
    demand, capacity and host counts read once and the mask written once;
    for each non-zero item, R compares against every host a first-fit scan
    examines (up to the first that fits, every live host when none does)
    and R subtractions when one fits.  The count replays the scan in numpy
    on the same f32 values."""
    import numpy as np

    T, M, R = dem.shape
    nbytes = dem.size * 4 + T * M + R * 4 + T * 4
    live = np.minimum(hosts, pad).astype(np.int64)
    bins = np.where((np.arange(pad)[None, :] < live[:, None])[:, :, None],
                    np.asarray(capacity, np.float32)[None, None, :],
                    np.float32(-np.inf)).astype(np.float32)          # [T, H, R]
    rows = np.arange(T)
    nops = 0
    for i in range(M):
        d = dem[:, i, :]
        busy = d.any(axis=1)
        fit = (bins >= d[:, None, :]).all(axis=2)
        any_fit = fit.any(axis=1)
        first = fit.argmax(axis=1)
        examined = np.where(any_fit, first + 1, live)
        nops += int(np.sum(busy * (examined * R + any_fit * R)))
        take = busy & any_fit
        bins[rows[take], first[take]] += -d[take]
    return float(nbytes), float(nops)


def sm_clock_mhz() -> float:
    """The card's highest SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


def check_pack(label, dem, capacity, hosts, pad, record, dev, *, clock_mhz, timed=True,
               plain_reps=3):
    """Hold the pack kernel against its plain version on the card (0 reject-
    mask mismatches); when ``timed``, time both and give the bytes bound and
    the chain floor: FFD is a chain over each tier's items, so no kernel can
    beat the longest tier's non-zero items times one dependent f32 subtract
    and compare (8 cycles) at the card's highest SM clock."""
    import numpy as np
    import torch
    from repro_torch.kernels.pack import pack_ffd_tiers_cuda
    from repro_torch.kernels.ref import pack_ffd_tiers_ref

    d = torch.as_tensor(dem, device=dev)
    c = torch.as_tensor(capacity, device=dev)
    h = torch.as_tensor(hosts.astype(np.int32), device=dev)
    got = pack_ffd_tiers_cuda(d, c, h, num_hosts_pad=pad)
    want = pack_ffd_tiers_ref(d, c, h, num_hosts_pad=pad)
    torch.cuda.synchronize()
    mismatches = int((got != want).sum())
    if mismatches:
        raise AssertionError(f"pack_ffd_tiers {label}: {mismatches} reject-mask mismatches")
    err = float((got.to(torch.int32) - want.to(torch.int32)).abs().max()) if got.numel() else 0.0
    record["pack_ffd_tiers"]["max_abs_err"] = max(record["pack_ffd_tiers"]["max_abs_err"], err)
    nonzero = (dem != 0).any(axis=2).sum(axis=1)
    head = (f"pack_ffd_tiers {label:>22}: T={dem.shape[0]} M_b={dem.shape[1]} R={dem.shape[2]} "
            f"pad={pad} hosts {hosts.tolist()}, non-zero items a tier {nonzero.tolist()}, rejected "
            f"{int(got.sum())}, mismatches 0")
    if not timed:
        print(head, flush=True)
        return None
    ms = time_ms(lambda: pack_ffd_tiers_cuda(d, c, h, num_hosts_pad=pad))
    plain_ms = time_ms(lambda: pack_ffd_tiers_ref(d, c, h, num_hosts_pad=pad),
                       reps=plain_reps, warmup=1)
    nbytes, nops = pack_work(dem, capacity, hosts, pad)
    b, by = bound_ms(nbytes, nops)
    floor = int(nonzero.max()) * 8 / (clock_mhz * 1e6) * 1e3
    print(f"{head}, kernel {ms:.4f} ms, plain {plain_ms:.2f} ms (median of {plain_reps}), "
          f"bound {b:.6f} ms ({by}), chain floor {floor:.4f} ms ({int(nonzero.max())} items x 8 "
          f"cycles at {clock_mhz:.0f} MHz), kernel / max(bound, floor) "
          f"{ms / max(b, floor):.3f}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "chain_floor_ms": floor}


def round_work(args, status) -> tuple[float, float, int]:
    """(bytes, f32 ops, positions scanned) the rounding scan needs on these
    inputs and this result: the order, target and home of every position
    it must scan (all of them, or up to the last mover walked when the
    budget ran out), each walked mover's demand, tasks and feasibility byte
    and (R + 1) adds and compares, each accepted mover's assignment and
    2 (R + 1) load updates, and the tier tables read and written once."""
    import numpy as np

    order, target, a0 = (args[i].cpu().numpy() for i in (0, 1, 5))
    N, R = args[6].shape
    T = args[8].shape[0]
    accepted, walked = (int(v) for v in status.cpu().tolist())
    movers = np.nonzero(target[order] != a0[order])[0]
    spent = accepted == int(args[11].cpu())
    scanned = int(movers[walked - 1]) + 1 if (spent and walked) else N
    nbytes = (scanned * (8 + 8 + 4) + walked * (4 * R + 4 + 1) + accepted * 4
              + T * (R + 1) * 4 * 3 + 8)
    nops = walked * 2 * (R + 1) + accepted * 2 * (R + 1)
    return float(nbytes), float(nops), scanned


def check_round(label, args, record, *, clock_mhz, timed=False, plain=True) -> dict:
    """Hold the rounding kernel (launched directly, so it adds no count)
    against its plain version on CPU copies of the same inputs (f32 adds
    and compares round the same on both): status, assignment and tier loads
    bit for bit.  When ``timed``, time it on the card (and its plain version
    when ``plain``), with its staging and walk launches alone on the
    "registers" body, and give the bytes bound and the chain floor: the walk
    is a chain over the movers, each of which adds to the loads that the
    next one's fit test reads, so no kernel can beat the movers walked times
    one dependent f32 add (ROUND_CHAIN_CYCLES) at the card's highest SM
    clock (the fit tests of a block, its vote and the budget's count can be
    taken off that chain, as the "registers" body takes them)."""
    import torch
    from repro_torch.kernels import optimal_round as K
    from repro_torch.kernels.ref import optimal_round_ref

    fixed = args[:2] + args[5:]

    def fresh():
        return (args[2].clone(), args[3].clone(), args[4].clone())

    def call(fn, state):
        return fn(*fixed[:2], *state, *fixed[2:])

    state = fresh()
    got = call(K.optimal_round_cuda, state)
    cpu = [a.cpu().clone() for a in args]
    want = optimal_round_ref(*cpu)
    torch.cuda.synchronize()
    if got.cpu().tolist() != want.tolist():
        raise AssertionError(f"optimal_round {label}: status {got.tolist()} != {want.tolist()}")
    for i, name in ((0, "assignment"), (1, "tier loads"), (2, "task counts")):
        if not torch.equal(state[i].cpu(), cpu[2 + i]):
            err = float((state[i].cpu().double() - cpu[2 + i].double()).abs().max())
            raise AssertionError(f"optimal_round {label}: {name} differ, max abs {err:.3e}")
    N, R = args[6].shape
    T = args[8].shape[0]
    body = K.choose_body(T, R)
    accepted, walked = want.tolist()
    movers = int((args[1] != args[5].long()).sum())
    head = (f"optimal_round  {label:>22}: N={N} T={T} R={R} budget {int(args[11])}, movers "
            f"{movers}, walked {walked}, accepted {accepted}, {body} body, bit-identical")
    if not timed:
        print(head, flush=True)
        return {"accepted": accepted, "walked": walked, "movers": movers, "body": body}
    pool = [fresh() for _ in range(24)]
    ms = time_ms(lambda: call(K.optimal_round_cuda, pool.pop()))
    parts = ""
    stage_ms = walk_ms = None
    if body == "registers":
        scratch = K.staging_buffer(args)
        stage_ms = time_ms(lambda: K.stage(args, scratch))
        pool = [fresh() for _ in range(24)]
        walk_ms = time_ms(lambda: K.walk(fixed[:2] + pool.pop() + fixed[2:], scratch))
        walk_cycles = walk_ms * 1e-3 * clock_mhz * 1e6 / max(walked, 1)
        parts = (f", staging alone {stage_ms:.4f} ms, walk alone {walk_ms:.4f} ms "
                 f"({walk_cycles:.1f} cycles a walked mover)")
    plain_ms = None
    if plain:
        plain_pool = [fresh() for _ in range(4)]
        plain_ms = time_ms(lambda: call(optimal_round_ref, plain_pool.pop()), reps=3, warmup=1)
        parts += f", plain {plain_ms:.2f} ms on the card (median of 3)"
    nbytes, nops, scanned = round_work(args, want)
    b, by = bound_ms(nbytes, nops)
    floor = walked * ROUND_CHAIN_CYCLES / (clock_mhz * 1e6) * 1e3
    cycles = ms * 1e-3 * clock_mhz * 1e6 / max(walked, 1)
    print(f"{head}, kernel {ms:.4f} ms ({cycles:.1f} cycles a walked mover at {clock_mhz:.0f} "
          f"MHz){parts}, bound {b:.6f} ms ({by}; {scanned} positions scanned), chain floor "
          f"{floor:.4f} ms ({walked} movers x {ROUND_CHAIN_CYCLES} cycles), kernel / max(bound, floor) "
          f"{ms / max(b, floor):.3f}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
            "chain_floor_ms": floor, "accepted": accepted, "walked": walked, "movers": movers,
            "body": body,
            "stage_ms": stage_ms, "walk_ms": walk_ms, "cycles_a_mover": cycles}


def device_profile(fn) -> dict:
    """Run ``fn`` under ``torch.profiler``: wall seconds, the union of the
    card's kernel / copy / memset intervals in the trace (``busy_s``, None
    when the trace holds no device activity), the trace's span from its
    first to its last event, kernel microseconds by name, and launches by
    name."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans, by_name, counts, lo, hi = [], {}, {}, float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        lo, hi = min(lo, ts), max(hi, ts + dur)
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((ts, ts + dur))
            if e["cat"] == "kernel":
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur
                counts[e["name"]] = counts.get(e["name"], 0) + 1
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_s": wall, "busy_s": busy / 1e6 if spans else None,
            "span_s": (hi - lo) / 1e6 if spans else None, "launches": len(spans),
            "kernels": sorted(by_name.items(), key=lambda kv: -kv[1]), "counts": counts}


def solve_profile_line(what: str, prof: dict) -> str:
    """One line from ``device_profile`` of a solve: wall, the card's busy
    time and idle share of the traced span, launches, the six longest
    kernels by name."""
    if prof["busy_s"] is None:
        return (f"{what}, wall {prof['wall_s']:.4f} s; the profiler saw no device activity "
                "(device busy share not measured)")
    top = ", ".join(f"{name[:48]} {us / 1e3:.3f} ms" for name, us in prof["kernels"][:6])
    return (f"{what}, wall {prof['wall_s']:.4f} s, device busy {prof['busy_s']:.4f} s (idle "
            f"share {1.0 - prof['busy_s'] / prof['span_s']:.4f} of the traced span "
            f"{prof['span_s']:.4f} s), {prof['launches']} device launches; kernel time by name: "
            f"{top}")


def kernel_label(name: str, width: int = 160) -> str:
    """A profiled kernel's name without PyTorch's namespaces and argument
    list, cut to ``width`` characters (the template arguments say which
    elementwise op it is)."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "at::", "c10::"):
        name = name.replace(noise, "")
    return name[:width]


def _ops_call(name):
    return lambda f, n: n == name and f.endswith("ops.py")


def _layers_call(*names):
    return lambda f, n: n in names and f.endswith("layers.py")


# Host phases of a LocalSearch solve and of a decode step (cProfile
# (file, function) matchers; cumulative seconds, so nested phases overlap).
SOLVER_PHASES = {
    "commit scan (launch)": _ops_call("commit_topk"),
    "sweep (precompute + kernel launch)": _ops_call("move_eval_best"),
    "copies and waits for the card": lambda f, n: any(
        f"'{m}' of 'torch._C" in n for m in ("to", "cpu", "tolist", "item")),
    "candidate sort": lambda f, n: n == "<built-in method torch.sort>",
}
DECODE_PHASES = {
    "linear layers (mm + bias + cast)": _layers_call("linear"),
    "norms": _layers_call("rmsnorm", "layernorm"),
    "rope (tables + rotation)": _layers_call("rope_tables", "rotate"),
    "flash_decode (checks + launch)": _ops_call("flash_decode"),
    "cache writes": lambda f, n: "index_copy_" in n,
    "unembedding": lambda f, n: n == "_unembed",
    "wait for the card (token copy)": lambda f, n: "'cpu' of 'torch._C" in n,
}


# A granite decode step adds the MoE layers' routing, expert products and
# combine.
MOE_DECODE_PHASES = {
    **DECODE_PHASES,
    "moe_dispatch (checks + launch)": _ops_call("moe_dispatch"),
    "moe_combine (checks + launch)": _ops_call("moe_combine"),
    "expert products (bmm)": lambda f, n: n == "_bmm" and f.endswith("moe.py"),
}


# A deepseek-v2-lite decode step adds MLA's expansion of its compressed cache.
MLA_DECODE_PHASES = {
    **MOE_DECODE_PHASES,
    "MLA cache expansion (wk_up, wv_up, concat)": lambda f, n: (n == "expand"
                                                                and f.endswith("attention.py")),
}


# A Zamba2 decode step adds the Mamba2 layers' one-step forms.
HYBRID_DECODE_PHASES = {
    **DECODE_PHASES,
    "ssd_step": lambda f, n: n == "ssd_step" and f.endswith("mamba2.py"),
    "conv_step": lambda f, n: n == "conv_step" and f.endswith("mamba2.py"),
}


# An xLSTM decode step: projections, norms, one scan launch a layer.
XLSTM_DECODE_PHASES = {
    "linear layers (mm + cast)": _layers_call("linear"),
    "norms": _layers_call("rmsnorm"),
    "mlstm_scan (checks + launch)": _ops_call("mlstm_scan"),
    "slstm_scan (checks + launch)": _ops_call("slstm_scan"),
    "logits": lambda f, n: n == "_logits" and f.endswith("xlstm.py"),
    "wait for the card (token copy)": lambda f, n: "'cpu' of 'torch._C" in n,
}


def host_profile(fn, phases=SOLVER_PHASES) -> tuple[float, dict]:
    """Run ``fn`` under ``cProfile``: wall seconds and the cumulative seconds
    of each host phase (cProfile's own cost inflates the Python parts, so
    these are shares of a profiled run)."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t
    out = dict.fromkeys(phases, 0.0)
    for (file, _, name), (_, _, _, cum, _) in pstats.Stats(prof).stats.items():
        for label, match in phases.items():
            if match(file, name):
                out[label] += cum
    return wall, out


def attention_work(B, Sq, Skv, H, KV, D, itemsize, causal=True, window=None,
                   dv=None) -> tuple[float, float]:
    """(bytes, operations) flash attention needs: q, k, v read once and the
    output written once; 2 D + 2 Dv operations (the q.k and p.v products;
    Dv, V's head dim, defaults to D) for every (query, key) pair the masks
    leave visible."""
    dv = D if dv is None else dv
    import numpy as np

    if window is None:          # per query row i: every key, or keys 0..i
        rows = np.minimum(np.arange(1, Sq + 1), Skv) if causal else np.full(Sq, Skv)
        pairs = int(rows.sum())
    else:
        i = np.arange(Sq)[:, None]
        j = np.arange(Skv)[None, :]
        visible = j > i - window
        if causal:
            visible &= j <= i
        pairs = int(visible.sum())
    nbytes = (B * Sq * H * (D + dv) + B * Skv * KV * (D + dv)) * itemsize
    return float(nbytes), float(2 * (D + dv) * B * H * pairs)


def decode_work(B, kv_len, H, KV, D, itemsize, dv=None) -> tuple[float, float]:
    """(bytes, operations) one decode step's attention needs: the written
    cache rows of k and v, the query and the output, kv_len; 2 D + 2 Dv
    operations (Dv defaults to D) for every visible cache position of every
    query head."""
    dv = D if dv is None else dv
    nbytes = (B * H * (D + dv) + B * kv_len * KV * (D + dv)) * itemsize + 4
    return float(nbytes), float(2 * (D + dv) * B * H * kv_len)


def flash_bound_ms(nbytes: float, nops: float, dtype) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and operations over the peak
    rate for the inputs' type (bf16 tensor cores; f32 outside them)."""
    import torch

    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flash_close(got, want) -> tuple[bool, float]:
    """(all of |got - want| <= atol + rtol |want| at FLASH_TOL of want's
    dtype, max |got - want|)."""
    atol, rtol = FLASH_TOL[str(want.dtype).split(".")[-1]]
    diff = (got.float() - want.float()).abs()
    return bool((diff <= atol + rtol * want.float().abs()).all()), float(diff.max())


def tol_text(dtype) -> str:
    atol, rtol = FLASH_TOL[str(dtype).split(".")[-1]]
    return f"atol {atol:g}, rtol {rtol:g}"


def seeded_normal(shape, dtype, dev, gen):
    import torch

    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(dtype)


def sdpa_prefill(q, k, v, causal: bool = True):
    """One PyTorch call that computes the no-window, no-softcap case,
    causal or bidirectional (timed as the yardstick only)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), is_causal=causal,
                                          enable_gqa=True).transpose(1, 2)


def sdpa_decode(q, k, v, kv_len: int):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k[:, :kv_len].transpose(1, 2),
                                          v[:, :kv_len].transpose(1, 2),
                                          enable_gqa=True).transpose(1, 2)


def check_flash_attention(label, shape, dtype, dev, gen, record, *, window=None, softcap=None,
                          timed=False, dv=None, body=None, causal=True,
                          control=True) -> dict:
    """Hold the flash_attention kernel against its plain version on the
    card (FLASH_TOL); with ``timed``, time the kernel, the plain version
    and, for the no-window no-softcap case, SDPA, whose error in bf16 must
    fall outside the bound (the control) unless ``control`` is False: a
    long bidirectional row averages so many values that bf16
    probabilities part from f32 ones by less than one bf16 ulp of the
    output.  ``dv``: V's head dim (default D; the scale is then D ** -0.5
    all the same, MLA's); ``body``: the kernel body the call must take;
    ``causal`` False: bidirectional (hubert's encoder)."""
    import torch
    from repro_torch.kernels.flash_attention import body_launches, flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref

    B, S, H, KV, D = shape
    dv = D if dv is None else dv
    q = seeded_normal((B, S, H, D), dtype, dev, gen)
    k = seeded_normal((B, S, KV, D), dtype, dev, gen)
    v = seeded_normal((B, S, KV, dv), dtype, dev, gen)
    kw = dict(window=window, softcap=softcap, causal=causal)
    before = dict(body_launches)
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    ok, err = flash_close(got, want)
    if not ok or tuple(got.shape) != (B, S, H, dv):
        raise AssertionError(f"flash_attention {label}: max abs err {err:.3e} beyond "
                             f"{tol_text(dtype)}, or shape {tuple(got.shape)}")
    if body is not None and body_launches[body] != before[body] + 1:
        raise AssertionError(f"flash_attention {label}: not on the {body} body")
    record["flash_attention"]["max_abs_err"] = max(record["flash_attention"]["max_abs_err"], err)
    line = f"flash_attention {label:>40}: max abs err {err:.3e} ({tol_text(dtype)})"
    out = {}
    if timed:
        itemsize = torch.finfo(dtype).bits // 8
        work = attention_work(B, S, S, H, KV, D, itemsize, causal=causal, window=window, dv=dv)
        b, by = flash_bound_ms(*work, dtype)
        out = {"ms": time_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
               "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=5),
               "bound_ms": b, "bound_by": by, "library_ms": None}
        if window is None and softcap is None:
            lib_ok, lib_err = flash_close(sdpa_prefill(q, k, v, causal), want)
            if dtype == torch.bfloat16 and lib_ok and control:
                raise AssertionError(f"flash_attention {label}: the control (SDPA, bf16 "
                                     f"probabilities, max abs err {lib_err:.3e}) passes "
                                     f"{tol_text(dtype)}, which then cannot tell it from "
                                     "the kernel")
            out["library_ms"] = time_ms(lambda: sdpa_prefill(q, k, v, causal))
            line += (f", SDPA err vs plain {lib_err:.3e} "
                     + ("(control, outside the bound)" if control else
                        f"({'inside' if lib_ok else 'outside'} the bound; no control here)"))
        nbytes, nops = work
        line += (f" | kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, SDPA "
                 f"{out['library_ms']} ms, bound {b:.4f} ms ({by}); kernel "
                 f"{nops / out['ms'] / 1e9:.1f} TFLOP/s of the function's {nops / 1e9:.3f} "
                 f"GFLOP, {nbytes / out['ms'] / 1e6:.1f} GB/s of its {nbytes / 1e6:.1f} MB"
                 + (f", {out['ms'] / out['library_ms']:.3f}x SDPA's time"
                    if out["library_ms"] else ""))
    print(line, flush=True)
    return out


def check_flash_decode(label, shape, dtype, dev, gen, record, kv_lens, *, softcap=None,
                       timed_len=None, dv=None, window=None) -> dict:
    """Hold the flash_decode kernel against its plain version on the card
    at each kv_len (an int32 on the card); with ``timed_len``, time the
    kernel, the plain version and SDPA over the written positions there,
    each launch on another copy of the cache (L2_FLUSH_BYTES in all), so
    that it reads the cache from HBM as the serve path does.  ``dv``: V's
    head dim (default D); ``window``: only with no ``timed_len``."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode_cuda
    from repro_torch.kernels.ref import flash_decode_ref

    B, Smax, H, KV, D = shape
    dv = D if dv is None else dv
    q = seeded_normal((B, 1, H, D), dtype, dev, gen)
    k = seeded_normal((B, Smax, KV, D), dtype, dev, gen)
    v = seeded_normal((B, Smax, KV, dv), dtype, dev, gen)
    errs = []
    for n in kv_lens:
        n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
        got = flash_decode_cuda(q, k, v, n_dev, softcap=softcap, window=window)
        want = flash_decode_ref(q, k, v, n_dev, softcap=softcap, window=window)
        torch.cuda.synchronize()
        ok, err = flash_close(got, want)
        errs.append(err)
        if not ok or tuple(got.shape) != (B, 1, H, dv):
            raise AssertionError(f"flash_decode {label} kv_len={n}: max abs err {err:.3e} "
                                 f"beyond {tol_text(dtype)}")
    record["flash_decode"]["max_abs_err"] = max(record["flash_decode"]["max_abs_err"], *errs)
    line = (f"flash_decode {label:>37}: kv_len {list(kv_lens)} max abs err "
            f"{', '.join(f'{e:.2e}' for e in errs)} ({tol_text(dtype)})")
    out = {}
    if timed_len is not None:
        n_dev = torch.tensor(timed_len, dtype=torch.int32, device=dev)
        itemsize = torch.finfo(dtype).bits // 8
        b, by = flash_bound_ms(*decode_work(B, timed_len, H, KV, D, itemsize, dv=dv), dtype)
        copies = max(1, math.ceil(L2_FLUSH_BYTES / (k.nbytes + v.nbytes)))
        caches = itertools.cycle([(k.clone(), v.clone()) for _ in range(copies)])

        def rotated(fn):
            def call():
                kc, vc = next(caches)
                return fn(kc, vc)
            return call

        out = {"ms": time_ms(rotated(lambda kc, vc: flash_decode_cuda(q, kc, vc, n_dev,
                                                                       softcap=softcap))),
               "plain_ms": time_ms(rotated(lambda kc, vc: flash_decode_ref(q, kc, vc, n_dev,
                                                                            softcap=softcap))),
               "bound_ms": b, "bound_by": by, "library_ms": None}
        if softcap is None:
            want = flash_decode_ref(q, k, v, n_dev)
            lib_err = float((sdpa_decode(q, k, v, timed_len).float() - want.float()).abs().max())
            out["library_ms"] = time_ms(rotated(lambda kc, vc: sdpa_decode(q, kc, vc,
                                                                           timed_len)))
            line += f", SDPA err vs plain {lib_err:.3e}"
        nbytes, _ = decode_work(B, timed_len, H, KV, D, itemsize, dv=dv)
        line += (f" | at kv_len {timed_len}, over {copies} cache copies (L2 cold): kernel "
                 f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, SDPA "
                 f"{out['library_ms']} ms, bound {b:.6f} ms ({by}); kernel "
                 f"{nbytes / out['ms'] / 1e6:.1f} GB/s of the {nbytes / 1e6:.3f} MB it must read"
                 + (f", {out['ms'] / out['library_ms']:.3f}x SDPA's time"
                    if out["library_ms"] else ""))
    print(line, flush=True)
    return out


def serve_requests(cfg, spec: ServeSpec = DENSE_SPEC):
    """The slice's requests, drawn from SERVE_SEED: token ids uniform over
    the vocabulary, SLO classes as the reference CLI draws them, prompt
    lengths uniform in ``spec``'s range (drawn before each request's SLO
    class), or, with a range a wave, the SLO classes drawn first and each
    request's length from the range of the wave it is served in."""
    import numpy as np
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(SERVE_SEED)
    slo_p = [0.2, 0.2, 0.45, 0.15]
    if len(spec.prompt_ranges) == 1:
        (lo, hi), reqs = spec.prompt_ranges[0], []
        for i in range(spec.requests):
            n = int(rng.integers(lo, hi + 1))
            reqs.append(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                                slo=int(rng.choice(4, p=slo_p)), max_new_tokens=spec.new))
        return reqs
    slos = [int(rng.choice(4, p=slo_p)) for _ in range(spec.requests)]
    order = sorted(range(spec.requests), key=lambda i: slos[i])    # RequestQueue's order
    lengths = {}
    for k, i in enumerate(order):
        lo, hi = spec.prompt_ranges[k // spec.slots]
        lengths[i] = int(rng.integers(lo, hi + 1))
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, lengths[i]).astype(np.int32),
                    slo=slos[i], max_new_tokens=spec.new) for i in range(spec.requests)]


def serve_once(model, cfg, dev, spec: ServeSpec = DENSE_SPEC):
    """One run of the slice through the user's entry points: the requests
    queued, ``ServeEngine`` built, ``serve_all`` drained -> (finished
    requests in serving order, wall seconds, the engine)."""
    import torch
    from repro_torch.launch.serve import RequestQueue, ServeEngine, serve_all

    queue = RequestQueue()
    t0 = time.perf_counter()
    for r in serve_requests(cfg, spec):
        r.arrival_s = t0
        queue.push(r)
    engine = ServeEngine(model, slots=spec.slots, max_seq=spec.max_seq, device=dev)
    finished = serve_all(engine, queue)
    torch.cuda.synchronize()
    return finished, time.perf_counter() - t0, engine


def wave_stats(finished, t0: float, slots: int = SERVE_SLOTS) -> list[dict]:
    """Per wave (``slots`` requests in serving order): its longest prompt,
    decode steps, prefill seconds (first token minus the previous wave's
    end), decode ms per step."""
    waves, start = [], t0
    for w in range(0, len(finished), slots):
        reqs = finished[w:w + slots]
        first = reqs[0].first_token_s
        done = max(r.done_s for r in reqs)
        steps = max(len(r.tokens) for r in reqs) - 1
        waves.append({"prompt_len": max(len(r.prompt) for r in reqs), "steps": steps,
                      "prefill_s": first - start, "ttft_s": first - t0,
                      "decode_ms_per_step": (done - first) / steps * 1e3})
        start = done
    return waves


def padded_wave(reqs, dev, spec: ServeSpec = DENSE_SPEC):
    """(the wave's prompts left-padded with 0 to the longest, as
    ``ServeEngine`` admits them, [slots, maxlen]; each request's first
    generated token [slots, 1]), int32 on ``dev``."""
    import numpy as np
    import torch

    maxlen = max(len(r.prompt) for r in reqs)
    batch = np.zeros((spec.slots, maxlen), np.int32)
    first = np.zeros((spec.slots, 1), np.int32)
    for i, r in enumerate(reqs):
        batch[i, maxlen - len(r.prompt):] = r.prompt
        first[i, 0] = r.tokens[0]
    return torch.as_tensor(batch, device=dev), torch.as_tensor(first, device=dev)


def teacher_forced_check(model, reqs, dev, spec: ServeSpec = DENSE_SPEC,
                         against: str = "forward_train") -> dict:
    """The wave's padded prompts through ``prefill`` and one ``decode_step``
    of its first generated tokens, against ``forward_train`` over the
    padded prompts plus those tokens (the reference's own check,
    tests/test_models.py:63), or, with ``against="prefill"``, against the
    last logits of a ``prefill`` over them on a fresh cache (the same
    function without [B, S, vocab] f32 logits); returns the errors and the
    decode logits of the wave's rows (f32, on the host)."""
    import torch

    tokens, tok0 = padded_wave(reqs, dev, spec)
    cache = model.init_cache(spec.slots, spec.max_seq)
    pre, cache = model.prefill({"tokens": tokens}, cache)
    dec, cache = model.decode_step(tok0, cache)
    del cache
    if against == "prefill":
        full, _ = model.prefill({"tokens": torch.cat([tokens, tok0], dim=1)},
                                model.init_cache(spec.slots, spec.max_seq))
    else:
        full, _ = model.forward_train({"tokens": torch.cat([tokens, tok0], dim=1)})
    want = full[:, -1].float()
    got = dec[:, 0].float()
    n = len(reqs)
    out = {"finite": bool(torch.isfinite(pre).all() and torch.isfinite(dec).all()
                          and torch.isfinite(full).all()),
           "max_abs_err": float((got - want).abs().max()),
           "scale": float(want.abs().max()),
           "mean_abs_err": float((got - want).abs().mean()),
           "argmax_agree": int((got.argmax(-1) == want.argmax(-1))[:n].sum()),
           "prefill_tokens_agree": int((pre[:n, -1].argmax(-1).cpu().numpy()
                                        == tok0[:n, 0].cpu().numpy()).sum()),
           "rows": n, "decode_logits": got[:n].cpu()}
    del full
    return out


def teacher_forced_f32(cfg, dev, reqs) -> tuple[dict, float]:
    """Wave 1's teacher-forced check again with the parameters, caches and
    activations in f32 (TF32 off, as phase 4 set it), so that the bf16
    roundings drop out and what is left is the port's own arithmetic;
    returns the errors and the seconds it took."""
    import dataclasses

    import torch
    from repro_torch.models import build_model

    t = time.perf_counter()
    model = build_model(dataclasses.replace(cfg, param_dtype="float32"), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SERVE_SEED))
    tf = teacher_forced_check(model, reqs, dev)
    torch.cuda.synchronize()
    del model
    torch.cuda.empty_cache()
    return tf, time.perf_counter() - t


def wave_lengths(cfg, spec: ServeSpec = DENSE_SPEC) -> list[int]:
    """Each wave's longest prompt on the main path (waves follow SLO
    priority)."""
    from repro_torch.launch.serve import RequestQueue

    q = RequestQueue()
    reqs = serve_requests(cfg, spec)
    for r in reqs:
        q.push(r)
    order = [q.pop() for _ in range(len(reqs))]
    return [max(len(r.prompt) for r in order[w:w + spec.slots])
            for w in range(0, len(order), spec.slots)]


def serve_slice(cfg, dev, expected_launches, phases, spec: ServeSpec = DENSE_SPEC,
                teacher_waves: int = 1, against: str = "forward_train", hooks=None,
                checks=None, model=None) -> dict:
    """Full-width ``cfg`` in bf16 with seeded random weights serves the
    slice's requests (``spec``) through ``ServeEngine``, with the launch
    counters zeroed just before and read just after
    (``expected_launches(waves, steps)`` names the counts each kernel must
    show); then the checks (a repeat gives the same tokens, the first
    ``teacher_waves`` waves' first decode logits match a teacher-forced
    pass, ``against`` ``forward_train`` or ``prefill``, all logits finite),
    one profiled prefill (device time by kernel name) and one profiled
    decode step (device idle share, one ``flash_decode`` launch a call;
    host phases under cProfile).  Every ``flash_attention`` launch of the
    serve must have taken the tensor-core body.  ``hooks`` = (install,
    remove), each called with the model just before and just after the
    counted serve; ``checks(model, finished)``, run after the teacher-forced
    checks, returns what ``out["checks"]`` holds.  ``model``: the model to
    serve, in place of one built here."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import body_launches
    from repro_torch.launch.serve import latency_report
    from repro_torch.models import build_model

    arch = cfg.arch_id
    t = time.perf_counter()
    if model is None:
        model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
            SERVE_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    if hooks is not None:
        hooks[0](model)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    finished, wall, _ = serve_once(model, cfg, dev, spec)
    launches = dict(ops.launch_counts)
    if hooks is not None:
        hooks[1](model)
    bodies = dict(body_launches)
    peak = torch.cuda.max_memory_allocated()
    waves = wave_stats(finished, t0, spec.slots)
    steps = sum(w["steps"] for w in waves)
    for name, n in expected_launches(len(waves), steps).items():
        if launches[name] != n:
            raise AssertionError(f"{arch} serve launched {name} {launches[name]} times, "
                                 f"expected {n}")
    if bodies != {"simt": 0, "wgmma": launches["flash_attention"]}:
        raise AssertionError(f"{arch} prefill took the flash_attention bodies {bodies}, not the "
                             f"tensor-core body {launches['flash_attention']} times")
    for r in finished:
        if len(r.tokens) != spec.new or not all(0 <= x < cfg.vocab_size for x in r.tokens):
            raise AssertionError(f"{arch} request {r.rid}: tokens {r.tokens}")
    if sorted(r.rid for r in finished) != list(range(spec.requests)):
        raise AssertionError(f"{arch}: not every request was served once")
    for i, w in enumerate(waves):
        print(f"serve {arch} wave {i + 1}: B={spec.slots} prompt_len {w['prompt_len']} "
              f"(left-padded), prefill {w['prefill_s'] * 1e3:.3f} ms, TTFT from arrival "
              f"{w['ttft_s'] * 1e3:.3f} ms, {w['steps']} decode steps at "
              f"{w['decode_ms_per_step']:.4f} ms per step "
              f"({w['decode_ms_per_step'] / spec.slots:.4f} ms per token)", flush=True)
    report = latency_report(finished)
    print(f"serve {arch} full width ({n_params / 1e9:.4f} B params, bf16, init "
          f"{init_s:.3f} s): {len(finished)} requests in {len(waves)} waves, wall {wall:.4f} s, "
          f"{spec.requests * spec.new / wall:.2f} generated tokens/s, launches {launches} "
          f"(flash_attention bodies {bodies}), "
          f"peak memory {peak / 2**30:.3f} GiB; latency by SLO "
          + json.dumps({f"SLO{k + 1}": v for k, v in report.items()}), flush=True)

    # checks: repeat, teacher forcing, finite logits
    t0 = time.perf_counter()
    again, wall2, engine = serve_once(model, cfg, dev, spec)
    same = {r.rid: r.tokens for r in again} == {r.rid: r.tokens for r in finished}
    print(f"repeat serve {arch}: wall {wall2:.4f} s, tokens identical {same}; per wave "
          + "; ".join(f"prefill {w['prefill_s'] * 1e3:.3f} ms, {w['decode_ms_per_step']:.4f} ms "
                      "per step" for w in wave_stats(again, t0, spec.slots)), flush=True)
    if not same:
        raise AssertionError(f"a second {arch} serve of the same requests gave other tokens")
    cache_slots = [next(iter(layer.values())).shape[1]
                   for layer in engine.cache.get("layers", [])]
    engine.cache = None                    # the teacher-forced passes take their own caches
    torch.cuda.empty_cache()
    teachers = []
    for w in range(teacher_waves):
        tf = teacher_forced_check(model, finished[w * spec.slots:(w + 1) * spec.slots], dev,
                                  spec, against)
        teachers.append(tf)
        print(f"teacher-forced check {arch} (wave {w + 1}, {tf['rows']} rows): decode vs "
              f"{against} max abs err {tf['max_abs_err']:.4f} of max |logit| "
              f"{tf['scale']:.4f} (tol {TEACHER_TOL:g} x scale), mean abs err "
              f"{tf['mean_abs_err']:.5f}, argmax agree {tf['argmax_agree']}/{tf['rows']}, "
              f"prefill argmax = served first token {tf['prefill_tokens_agree']}/{tf['rows']}, "
              f"all finite {tf['finite']}", flush=True)
        if not tf["finite"]:
            raise AssertionError(f"non-finite logits at full width ({arch})")
        if not tf["max_abs_err"] <= TEACHER_TOL * tf["scale"]:
            raise AssertionError(f"{arch} decode logits part from the teacher-forced {against}")
        if tf["prefill_tokens_agree"] != tf["rows"]:
            raise AssertionError(f"a repeat {arch} prefill picked another first token than "
                                 "the served run")
    tf = teachers[0] if teachers else None
    extra = checks(model, finished) if checks is not None else None

    # one profiled prefill (a fresh wave), then one profiled decode step
    prompts = serve_requests(cfg, spec)[:spec.slots]
    plen = max(len(r.prompt) for r in prompts)
    pre = device_profile(lambda: engine.admit_wave(prompts))
    if pre["busy_s"] is None:
        print(f"profile {arch}: one prefill of {spec.slots} prompts (longest {plen}), wall "
              f"{pre['wall_s'] * 1e3:.3f} ms; the profiler saw no device activity", flush=True)
    else:
        ktot = sum(us for _, us in pre["kernels"])
        top = "; ".join(f"{kernel_label(name)} {us / 1e3:.3f} ms x{pre['counts'][name]} "
                        f"({us / ktot:.3f})" for name, us in pre["kernels"][:PROFILE_TOP])
        print(f"profile {arch}: one prefill of {spec.slots} prompts (longest {plen}), wall "
              f"{pre['wall_s'] * 1e3:.3f} ms, device busy {pre['busy_s'] * 1e3:.3f} ms (idle "
              f"share {1.0 - pre['busy_s'] / pre['span_s']:.4f}), kernel time "
              f"{ktot / 1e3:.3f} ms in {pre['launches']} device launches; by name (share of "
              f"kernel time): {top}", flush=True)
    prof = device_profile(engine.step)
    if prof["busy_s"] is None:
        idle = None
        print(f"profile {arch}: one decode step, wall {prof['wall_s'] * 1e3:.3f} ms; the "
              "profiler saw no device activity (idle share not measured)", flush=True)
    else:
        idle = 1.0 - prof["busy_s"] / prof["span_s"]
        top = ", ".join(f"{name[:48]} {us / 1e3:.4f} ms" for name, us in prof["kernels"][:6])
        decode_calls = expected_launches(1, 1)["flash_decode"]
        decode_kernels = sum(n for name, n in prof["counts"].items() if "flash_decode" in name)
        print(f"profile {arch}: one decode step, wall {prof['wall_s'] * 1e3:.3f} ms, device "
              f"busy {prof['busy_s'] * 1e3:.3f} ms (idle share {idle:.4f} of the traced span "
              f"{prof['span_s'] * 1e3:.3f} ms), {prof['launches']} device launches, "
              f"flash_decode kernels {decode_kernels} for {decode_calls} calls; kernel time by "
              f"name: {top}", flush=True)
        if decode_kernels != decode_calls:
            raise AssertionError(f"{arch}: {decode_kernels} flash_decode kernels for "
                                 f"{decode_calls} calls in one decode step, not one a call")
    wall_h, host_phases = host_profile(engine.step, phases)
    print(f"host profile {arch}: one decode step under cProfile, wall {wall_h * 1e3:.3f} ms; "
          "cumulative: " + ", ".join(f"{label} {sec * 1e3:.3f} ms ({sec / wall_h:.3f})"
                                     for label, sec in host_phases.items()), flush=True)
    del model, engine
    torch.cuda.empty_cache()
    return {"launches": launches, "waves": waves, "idle": idle, "peak_gib": peak / 2**30,
            "wave1": finished[:spec.slots], "teacher": tf, "teachers": teachers,
            "finished": finished, "param_bytes": param_bytes, "cache_slots": cache_slots,
            "checks": extra}


def serving_phase(dev, record) -> dict:
    """Phase 4: the flash kernels at the serve path's shapes, then the slice."""
    import torch
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False       # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    cfg = get_config(SERVE_ARCH)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    wave_lens = wave_lengths(cfg)

    # -- 4a. kernels against their plain versions --------------------------------
    times = {}
    check_flash_attention(f"B=8 S={PROMPT_MAX} H=16 KV=2 D=128 f32", (8, PROMPT_MAX, H, KV, D),
                          f32, dev, gen, record)
    times["prefill_1024"] = check_flash_attention(
        f"B=8 S={PROMPT_MAX} H=16 KV=2 D=128 bf16", (8, PROMPT_MAX, H, KV, D), bf16, dev, gen,
        record, timed=True)
    times["prefill_main"] = check_flash_attention(
        f"main path wave 1 B=8 S={wave_lens[0]} bf16", (SERVE_SLOTS, wave_lens[0], H, KV, D),
        bf16, dev, gen, record, timed=True)
    for dtype in (f32, bf16):
        check_flash_attention(f"window 256 softcap 50 D=256 KV=8 {str(dtype)[6:]}",
                              (2, 1024, 16, 8, 256), dtype, dev, gen, record, window=256,
                              softcap=50.0, timed=dtype == bf16)
    check_flash_attention("odd B=3 S=777 D=128 bf16", (3, 777, H, KV, D), bf16, dev, gen, record)
    check_flash_attention("odd smollm B=2 S=333 H=15 KV=5 D=64 f32", (2, 333, 15, 5, 64), f32,
                          dev, gen, record)
    check_flash_attention("odd B=2 S=45 H=4 KV=2 D=16 f32", (2, 45, 4, 2, 16), f32, dev, gen,
                          record)
    dshape = (SERVE_SLOTS, SERVE_MAX_SEQ, H, KV, D)
    main_len = wave_lens[0] + SERVE_NEW - 1        # the wave's last decode step
    times["decode_main"] = check_flash_decode(
        f"B=8 Smax={SERVE_MAX_SEQ} bf16", dshape, bf16, dev, gen, record,
        (1, 17, 1000, SERVE_MAX_SEQ, main_len), timed_len=main_len)
    check_flash_decode(f"B=8 Smax={SERVE_MAX_SEQ} f32", dshape, f32, dev, gen, record,
                       (1, 17, 1000, SERVE_MAX_SEQ))
    check_flash_decode(f"softcap 50 B=8 Smax={SERVE_MAX_SEQ} bf16", dshape, bf16, dev, gen,
                       record, (17, 517, SERVE_MAX_SEQ), softcap=50.0)
    check_flash_decode("odd B=3 Smax=777 D=256 KV=8 f32", (3, 777, 16, 8, 256), f32, dev, gen,
                       record, (1, 333, 777))

    # -- 4b. the slice, 4c. its checks ---------------------------------------------
    out = serve_slice(cfg, dev, lambda waves, steps: {
        "flash_attention": cfg.num_layers * waves, "flash_decode": cfg.num_layers * steps},
        DECODE_PHASES)
    return {**out, "times": times}


def ssd_work(B, C, Q, H, P, N, G) -> tuple[float, float, float, float]:
    """(bytes, products needed, other operations needed, products as the
    kernel does them) of the SSD per-chunk function.  Bytes: x, dt, A, B and
    C read once, y, state and cum written once, f32.  Products needed: C.B
    over the lower triangle once per (b, c) (it does not depend on the
    head), per (b, c, h) W x over the pairs j <= i and the state product
    (2 Q P N).  Other: per (b, c, h) the cumsum (2 Q), the weights of the
    pairs j <= i (subtract, exp, two multiplies), dw (3 Q) and x dw (Q P).
    As done: C.B once per group of G heads and W x, both over the 16 x 16
    blocks on and below the diagonal, and the state product, with Q rounded
    up to 16 (each is three TF32 products on the tensor cores)."""
    tri = Q * (Q + 1) // 2
    nbytes = 4 * (2 * B * C * Q * H * P + B * C * H * P * N + 2 * B * C * Q * H
                  + 2 * B * C * Q * N + H)
    products = B * C * (2 * tri * N + H * (2 * tri * P + 2 * Q * P * N))
    other = B * C * H * (2 * Q + 4 * tri + 3 * Q + Q * P)
    nb = -(-Q // 16)
    lower = nb * (nb + 1) // 2 * 256
    done = B * C * (-(-H // G) * 2 * lower * N + H * (2 * lower * P + 2 * 16 * nb * P * N))
    return float(nbytes), float(products), float(other), float(done)


def ssd_bound_ms(nbytes: float, products: float, other: float) -> tuple[float, str, float]:
    """(bound, what bounds it, operations time) of the SSD per-chunk
    function: the larger of its bytes over the memory rate and its
    operations, the products at the rate the card has for f32-exact
    products (3xTF32, a third of the TF32 peak) and the rest at the f32
    rate, the two units working side by side."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(products / (TF32_OPS_PER_S / 3), other / F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes", t_ops) if t_bytes >= t_ops else (t_ops, "operations", t_ops)


def check_ssd_chunk(label, shape, dev, gen, record, *, timed=False, x_scale=1.0,
                    group=None) -> dict:
    """Hold the ssd_chunk kernel against its plain version on the card
    (SSD_TOL on y, state and cum), x drawn at ``x_scale`` times the
    reference test's scale, with ``group`` heads a CTA or the wrapper's
    choice; with ``timed``, time both, and the kernel at every group size
    the wrapper may choose."""
    import torch
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd_chunk import MAX_GROUP, _launch, head_group

    B, C, Q, H, P, N = shape
    G = group or head_group(B * C, H, sm_count(dev.index))
    f32 = torch.float32
    x = seeded_normal((B, C, Q, H, P), f32, dev, gen) * x_scale
    dt = torch.rand((B, C, Q, H), generator=gen, device=dev) * (0.1 - 1e-3) + 1e-3
    A = -(torch.rand((H,), generator=gen, device=dev) * 1.5 + 0.5)
    Bm = seeded_normal((B, C, Q, N), f32, dev, gen)
    Cm = seeded_normal((B, C, Q, N), f32, dev, gen)
    got = _launch(x, dt, A, Bm, Cm, G)
    want = ssd_chunk_ref(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    errs, worst = [], 0.0
    for name, g, w in zip(("y", "state", "cum"), got, want):
        diff = (g - w).abs()
        errs.append(float(diff.max()))
        worst = max(worst, float((diff / (SSD_TOL + SSD_TOL * w.abs())).max()))
        if not bool((diff <= SSD_TOL + SSD_TOL * w.abs()).all()):
            raise AssertionError(f"ssd_chunk {label}: {name} max abs err {errs[-1]:.3e} beyond "
                                 f"atol = rtol = {SSD_TOL:g}")
    del got, want
    record["ssd_chunk"]["max_abs_err"] = max(record["ssd_chunk"]["max_abs_err"], *errs)
    line = (f"ssd_chunk {label:>44}: G={G} heads a CTA ({-(-H // G) * B * C} CTAs), body "
            f"3xTF32 tensor cores (its only body); max abs err y {errs[0]:.3e}, state "
            f"{errs[1]:.3e}, cum {errs[2]:.3e}, largest err / tol {worst:.3f} (atol = rtol = "
            f"{SSD_TOL:g})")
    out = {}
    if timed:
        nbytes, products, other, done = ssd_work(B, C, Q, H, P, N, G)
        b, by, t_ops = ssd_bound_ms(nbytes, products, other)
        out = {"ms": time_ms(lambda: _launch(x, dt, A, Bm, Cm, G)),
               "plain_ms": time_ms(lambda: ssd_chunk_ref(x, dt, A, Bm, Cm), reps=5),
               "bound_ms": b, "bound_by": by, "library_ms": None}
        sweep = {g: time_ms(lambda: _launch(x, dt, A, Bm, Cm, g))
                 for g in range(1, min(H, MAX_GROUP) + 1)}
        needed = products + other
        line += (f" | kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, bound "
                 f"{b:.4f} ms ({by}); bytes bound {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
                 f"({nbytes / 1e6:.1f} MB), operations bound {t_ops:.4f} ms "
                 f"({products / 1e9:.3f} GFLOP of products needed at "
                 f"{TF32_OPS_PER_S / 3e12:.0f} TFLOP/s, the 3xTF32 rate; "
                 f"{other / 1e9:.3f} GFLOP of other f32 work at {F32_OPS_PER_S / 1e12:.0f}); "
                 f"the kernel does {done / 1e9:.3f} GFLOP of products, "
                 f"{3 * done / 1e9:.3f} GFLOP of TF32 tensor-core work in 3xTF32 "
                 f"({3 * done / TF32_OPS_PER_S * 1e3:.4f} ms at the TF32 peak); "
                 f"{needed / out['ms'] / 1e9:.1f} TFLOP/s of the needed work, "
                 f"{nbytes / out['ms'] / 1e6:.1f} GB/s; library none | ms by heads a CTA: "
                 + ", ".join(f"G={g} {t:.4f}" for g, t in sweep.items()))
    print(line, flush=True)
    return out


def hybrid_phase(dev, record) -> dict:
    """Phase 5: the SSD chunk kernel and the flash kernels at the Zamba2
    path's shapes, then full-width zamba2-2.7b serves the slice's requests."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.mamba2 import CHUNK, mamba_dims

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 1)
    cfg = get_config(HYBRID_ARCH)
    wave_lens = wave_lengths(cfg)
    chunks = [-(-n // CHUNK) for n in wave_lens]   # prefill pads S to a multiple of CHUNK
    _, Hs = mamba_dims(cfg)
    P, N = cfg.ssm_headdim, cfg.ssm_state
    apps = cfg.num_layers // cfg.attn_every

    # -- 5a. kernels against their plain versions --------------------------------
    times = {}
    times["ssd_main"] = check_ssd_chunk(
        f"main path wave 1 x [8, {chunks[0]}, {CHUNK}, {Hs}, {P}] N={N}",
        (SERVE_SLOTS, chunks[0], CHUNK, Hs, P, N), dev, gen, record, timed=True)
    check_ssd_chunk(f"wave 2 x [8, {chunks[1]}, {CHUNK}, {Hs}, {P}] N={N}",
                    (SERVE_SLOTS, chunks[1], CHUNK, Hs, P, N), dev, gen, record)
    check_ssd_chunk("reduced x [2, 3, 128, 8, 16] N=16", (2, 3, 128, 8, 16, 16), dev, gen, record)
    check_ssd_chunk("ragged x [3, 1, 96, 4, 32] N=64", (3, 1, 96, 4, 32, 64), dev, gen, record)
    check_ssd_chunk("short x [2, 2, 17, 3, 16] N=64", (2, 2, 17, 3, 16, 64), dev, gen, record)
    check_ssd_chunk(f"ragged group x [2, 2, {CHUNK}, 81, {P}] N={N}", (2, 2, CHUNK, 81, P, N),
                    dev, gen, record, group=6)
    check_ssd_chunk(f"x * 30 x [2, 2, {CHUNK}, {Hs}, {P}] N={N}", (2, 2, CHUNK, Hs, P, N), dev,
                    gen, record, x_scale=30.0)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    times["prefill_d80"] = check_flash_attention(
        f"shared block B=8 S={wave_lens[0]} H={H} KV={KV} D={D} bf16",
        (SERVE_SLOTS, wave_lens[0], H, KV, D), bf16, dev, gen, record, timed=True)
    check_flash_attention(f"shared block B=8 S={wave_lens[1]} H={H} KV={KV} D={D} f32",
                          (SERVE_SLOTS, wave_lens[1], H, KV, D), f32, dev, gen, record)
    main_len = wave_lens[0] + SERVE_NEW - 1
    times["decode_d80"] = check_flash_decode(
        f"shared block B=8 Smax={SERVE_MAX_SEQ} D={D} bf16", (SERVE_SLOTS, SERVE_MAX_SEQ, H, KV, D),
        bf16, dev, gen, record, (1, 17, 1000, SERVE_MAX_SEQ, main_len), timed_len=main_len)
    check_flash_decode(f"shared block B=8 Smax={SERVE_MAX_SEQ} D={D} f32",
                       (SERVE_SLOTS, SERVE_MAX_SEQ, H, KV, D), f32, dev, gen, record,
                       (1, 17, 1000, SERVE_MAX_SEQ))

    # -- 5b. the slice, 5c. its checks ---------------------------------------------
    out = serve_slice(cfg, dev, lambda waves, steps: {
        "ssd_chunk": cfg.num_layers * waves, "flash_attention": apps * waves,
        "flash_decode": apps * steps}, HYBRID_DECODE_PHASES)

    print(f"ssd_chunk in the {cfg.arch_id} serve: {out['launches']['ssd_chunk']} launches "
          f"({cfg.num_layers} a prefill), all on its one body (3xTF32 tensor cores)", flush=True)

    # -- 5d. the same teacher-forced check in f32 at full width ----------------
    tf32, secs = teacher_forced_f32(cfg, dev, out["wave1"])
    tf16 = out["teacher"]
    print(f"teacher-forced check {cfg.arch_id} in f32 (wave 1, {tf32['rows']} rows, {secs:.1f} s "
          f"with the build): decode vs forward_train max abs err {tf32['max_abs_err']:.6g} of "
          f"max |logit| {tf32['scale']:.6g} ({tf32['max_abs_err'] / tf32['scale']:.3e} of "
          f"scale, limit {TEACHER_F32_TOL:g}), argmax agree {tf32['argmax_agree']}/"
          f"{tf32['rows']}, all finite {tf32['finite']}; in bf16 {tf16['max_abs_err']:.6g} of "
          f"{tf16['scale']:.6g} ({tf16['max_abs_err'] / tf16['scale']:.3e}), argmax agree "
          f"{tf16['argmax_agree']}/{tf16['rows']}", flush=True)
    if not (tf32["finite"] and tf32["max_abs_err"] <= TEACHER_F32_TOL * tf32["scale"]):
        raise AssertionError(f"{cfg.arch_id} in f32: decode parts from the teacher-forced "
                             "forward beyond what f32 roundings explain")
    return {**out, "times": times, "teacher_f32": tf32}


def windowed_decode_phase(cfg, dev, gen, record) -> dict:
    """Phase 7a: the windowed flash_decode kernel at gemma2's decode shape
    (B=8, Smax=8,192, H=16, KV=8, D=256, bf16, the model's query scale)
    against its plain version with the local layers' window, with softcap
    50 and without, at GEMMA2_DECODE_LENS (f32 at three of them); the ring
    read (Smax = window, no window, kv_len past it); then, at
    GEMMA2_TIMED_LEN over caches past the L2, the kernel beside its plain
    version, the bytes bound of the rows the window admits, SDPA over
    those rows (no softcap; timed only, used nowhere), the unwindowed call
    a global layer makes and the ring read."""
    import torch
    from repro_torch.kernels.flash_decode import choose_body, flash_decode_cuda
    from repro_torch.kernels.ref import flash_decode_ref

    B, Smax = GEMMA2_SPEC.slots, GEMMA2_SPEC.max_seq
    H, KV, D, W = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.window
    scale, cap = cfg.query_scale, cfg.attn_softcap
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = seeded_normal((B, 1, H, D), dtype, dev, gen)
        k = seeded_normal((B, Smax, KV, D), dtype, dev, gen)
        v = seeded_normal((B, Smax, KV, D), dtype, dev, gen)
        lens = GEMMA2_DECODE_LENS if dtype == torch.bfloat16 else (1, 4097, 8000)
        for softcap in (None, cap):
            for n in lens:
                n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
                kw = dict(scale=scale, softcap=softcap, window=W)
                got = flash_decode_cuda(q, k, v, n_dev, **kw)
                want = flash_decode_ref(q, k, v, n_dev, **kw)
                torch.cuda.synchronize()
                ok, err = flash_close(got, want)
                errs[(str(dtype)[6:], softcap, n)] = err
                if not ok:
                    raise AssertionError(f"windowed flash_decode {dtype} softcap {softcap} "
                                         f"kv_len={n}: max abs err {err:.3e} beyond "
                                         f"{tol_text(dtype)}")
        if dtype == torch.bfloat16:
            qb, kb, vb = q, k, v
    record["flash_decode"]["max_abs_err"] = max(record["flash_decode"]["max_abs_err"],
                                                *errs.values())
    print(f"flash_decode window {W} at gemma2's decode B={B} Smax={Smax} H={H} KV={KV} D={D} "
          f"({choose_body(torch.bfloat16, H // KV, D)} body in bf16): max abs err by (dtype, "
          f"softcap, kv_len) " + ", ".join(f"{key}: {e:.2e}" for key, e in errs.items())
          + f" (bf16 {tol_text(torch.bfloat16)}, f32 {tol_text(torch.float32)})", flush=True)

    # the ring read: a local layer's W slots, no window, kv_len past the ring
    kr, vr = kb[:, :W].contiguous(), vb[:, :W].contiguous()
    ring_errs = []
    for n in (W + 1, 5000, GEMMA2_TIMED_LEN):
        n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
        got = flash_decode_cuda(qb, kr, vr, n_dev, scale=scale, softcap=cap)
        want = flash_decode_ref(qb, kr, vr, n_dev, scale=scale, softcap=cap)
        torch.cuda.synchronize()
        ok, err = flash_close(got, want)
        ring_errs.append(err)
        if not ok:
            raise AssertionError(f"ring read kv_len={n}: max abs err {err:.3e}")
    record["flash_decode"]["max_abs_err"] = max(record["flash_decode"]["max_abs_err"],
                                                *ring_errs)

    # timed at kv_len 8,000: each call on one of the cache copies
    n = GEMMA2_TIMED_LEN
    n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
    local = flash_decode_cuda(qb, kb, vb, n_dev, scale=scale, softcap=cap, window=W)
    glob = flash_decode_cuda(qb, kb, vb, n_dev, scale=scale, softcap=cap)
    bites = float((local.float() - glob.float()).abs().max())
    if not bites > 0.0:
        raise AssertionError("the window changed nothing at kv_len 8,000")
    copies = max(2, math.ceil(L2_FLUSH_BYTES / (2 * kb.nbytes)))
    caches = itertools.cycle([(kb.clone(), vb.clone()) for _ in range(copies)])
    rings = itertools.cycle([(kr.clone(), vr.clone()) for _ in range(copies)])

    def rotated(fn, pool=caches):
        def call():
            kc, vc = next(pool)
            return fn(kc, vc)
        return call

    lo = n - W
    out = {"ms": time_ms(rotated(lambda kc, vc: flash_decode_cuda(
               qb, kc, vc, n_dev, scale=scale, softcap=cap, window=W))),
           "plain_ms": time_ms(rotated(lambda kc, vc: flash_decode_ref(
               qb, kc, vc, n_dev, scale=scale, softcap=cap, window=W))),
           "library_ms": time_ms(rotated(lambda kc, vc: sdpa_decode(
               qb, kc[:, lo:], vc[:, lo:], W))),
           "global_ms": time_ms(rotated(lambda kc, vc: flash_decode_cuda(
               qb, kc, vc, n_dev, scale=scale, softcap=cap))),
           "ring_ms": time_ms(rotated(lambda kc, vc: flash_decode_cuda(
               qb, kc, vc, n_dev, scale=scale, softcap=cap), rings))}
    out["bound_ms"], out["bound_by"] = flash_bound_ms(*decode_work(B, W, H, KV, D, 2),
                                                      torch.bfloat16)
    out["global_bound_ms"], _ = flash_bound_ms(*decode_work(B, n, H, KV, D, 2), torch.bfloat16)
    out["max_abs_err"] = max(errs.values())
    nbytes, _ = decode_work(B, W, H, KV, D, 2)
    print(f"flash_decode ring read B={B} W={W} no window, kv_len (W + 1, 5000, {n}): max abs "
          f"err {', '.join(f'{e:.2e}' for e in ring_errs)}; window {W} vs none at kv_len {n}: "
          f"max abs diff {bites:.4f} (the window bites) | at kv_len {n}, over {copies} cache "
          f"copies (L2 cold), softcap {cap}: windowed kernel {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, SDPA over rows [{lo}, {n}) without softcap "
          f"{out['library_ms']:.4f} ms, bound of the admitted rows {out['bound_ms']:.6f} ms "
          f"({out['bound_by']}; {nbytes / out['ms'] / 1e6:.1f} GB/s of its "
          f"{nbytes / 1e6:.3f} MB), {out['ms'] / out['library_ms']:.3f}x SDPA's time; the "
          f"unwindowed global-layer call {out['global_ms']:.4f} ms (bound "
          f"{out['global_bound_ms']:.6f} ms); the ring read {out['ring_ms']:.4f} ms", flush=True)
    del caches, rings, kb, vb, kr, vr
    return out


def decode_step_bound_ms(cfg, param_bytes: int, kv_len: int,
                         slots: int = GEMMA2_SPEC.slots) -> tuple[float, float]:
    """(bytes, ms at the HBM rate) one decode step of ``slots`` sequences at
    kv_len must move: every weight once (the embedding table whole, tied or
    not) and each layer's admitted cache rows of k and v (min(kv_len,
    window) on a local layer, kv_len on a global one; the ring holds the
    same rows)."""
    from repro_torch.models.transformer import layer_windows

    B, KV, D = slots, cfg.num_kv_heads, cfg.resolved_head_dim
    rows = sum(kv_len if w is None else min(kv_len, w) for w in layer_windows(cfg))
    nbytes = param_bytes + 2 * B * rows * KV * D * 2
    return float(nbytes), nbytes / HBM_BYTES_PER_S * 1e3


def small_card_vs_cpu(cfg_full, dev) -> list[dict]:
    """Phase 7e: reduced gemma2 in f32 on the card and on the CPU's plain
    path, with full and ring caches: a prefill past the window, then decode
    steps across it; logits within SMALL_REL of their scale, every cache
    tensor too, one flash_attention launch a layer and one flash_decode a
    layer a step on the card."""
    import copy

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, reduce_for_smoke

    B, S, steps, Smax = GEMMA2_SMALL
    out = []
    for ring in (False, True):
        cfg = dataclasses.replace(reduce_for_smoke(cfg_full), ring_cache=ring)
        cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
        card_model = copy.deepcopy(cpu_model).to(dev)
        toks = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                                 (B, S + steps)))
        runs = {}
        for name, model in (("cpu", cpu_model), ("card", card_model)):
            ops.reset_launch_counts()
            cache = model.init_cache(B, Smax)
            logits, cache = model.prefill({"tokens": toks[:, :S].to(model.device)}, cache)
            got = [logits.cpu()]
            for s in range(S, S + steps):
                logits, cache = model.decode_step(toks[:, s:s + 1].to(model.device), cache)
                got.append(logits.cpu())
            runs[name] = (got, [{k: t.cpu() for k, t in layer.items()}
                                for layer in cache["layers"]], dict(ops.launch_counts))
        (cl, cc, _), (gl, gc, counts) = runs["cpu"], runs["card"]

        def rel(a, b):
            return float((a.double() - b.double()).abs().max() / (b.double().abs().max() + 1e-30))

        logit_rel = max(rel(a, b) for a, b in zip(gl, cl))
        cache_rel = max(rel(a[k], b[k]) for a, b in zip(gc, cc) for k in ("k", "v"))
        slots = [layer["k"].shape[1] for layer in gc]
        print(f"reduced {cfg.arch_id} ring_cache={ring} (window {cfg.window}, cache slots "
              f"{slots}): prefill {S} then {steps} decode steps, card vs CPU logits max rel "
              f"{logit_rel:.3e}, caches max rel {cache_rel:.3e} (limit {SMALL_REL:g}), launches "
              f"flash_attention {counts['flash_attention']}, flash_decode "
              f"{counts['flash_decode']}", flush=True)
        if not (logit_rel <= SMALL_REL and cache_rel <= SMALL_REL):
            raise AssertionError(f"reduced gemma2 ring_cache={ring}: the card parts from the CPU")
        if (counts["flash_attention"], counts["flash_decode"]) != (
                cfg.num_layers, cfg.num_layers * steps):
            raise AssertionError(f"reduced gemma2 launches {counts}")
        out.append({"ring": ring, "logit_rel": logit_rel, "cache_rel": cache_rel})
    return out


def gemma2_phase(dev, record) -> dict:
    """Phase 7: the windowed decode kernel and the prefill kernel at
    gemma2's shapes, then full-width gemma2-9b serves the slice's requests
    with full caches and again with ring caches, then reduced gemma2 on
    card and CPU."""
    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 2)
    cfg = get_config(GEMMA2_ARCH)
    spec = GEMMA2_SPEC
    H, KV, D, W = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.window
    wave_lens = wave_lengths(cfg, spec)

    # -- 7a. the windowed decode kernel -----------------------------------------
    times = {"decode_window": windowed_decode_phase(cfg, dev, gen, record)}

    # -- 7b. flash_attention at the prefill shape: held to the plain version
    # and timed beside it at B=1, timed alone at B=8 (the plain version's f32
    # logits would take ~32 GB there) ----------------------------------------------
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    S, B = GEMMA2_PREFILL_LEN, spec.slots
    q = seeded_normal((B, S, H, D), bf16, dev, gen)
    k = seeded_normal((B, S, KV, D), bf16, dev, gen)
    v = seeded_normal((B, S, KV, D), bf16, dev, gen)
    for window in (W, None):
        kw = dict(window=window, softcap=cfg.attn_softcap, scale=cfg.query_scale)
        one = check_flash_attention(f"gemma2 B=1 S={S} window {window} softcap 50 D={D}",
                                    (1, S, H, KV, D), bf16, dev, gen, record, timed=True,
                                    window=window, softcap=cfg.attn_softcap)
        b, by = flash_bound_ms(*attention_work(B, S, S, H, KV, D, 2, window=window), bf16)
        ms = time_ms(lambda: flash_attention_cuda(q, k, v, **kw), reps=10)
        nbytes, nops = attention_work(B, S, S, H, KV, D, 2, window=window)
        times[f"prefill_{'local' if window else 'global'}"] = {
            "ms": ms, "bound_ms": b, "bound_by": by, "library_ms": None, "B": B,
            "plain_ms_b1": one["plain_ms"], "ms_b1": one["ms"], "bound_ms_b1": one["bound_ms"]}
        print(f"flash_attention gemma2 B={B} S={S} window {window} softcap 50 D={D} bf16: "
              f"kernel {ms:.4f} ms, bound {b:.4f} ms ({by}), {nops / ms / 1e9:.1f} TFLOP/s of "
              f"the function's {nops / 1e9:.3f} GFLOP, {b / ms:.3f} of the bound; no library "
              "call computes the softcap (SDPA none)", flush=True)
    del q, k, v
    torch.cuda.empty_cache()

    # -- 7c. the slice with full caches, 7d. with ring caches ----------------------
    def expected(waves, steps):
        return {"flash_attention": cfg.num_layers * waves, "flash_decode": cfg.num_layers * steps}

    runs = {}
    for ring in (False, True):
        c = dataclasses.replace(cfg, ring_cache=ring)
        runs[ring] = serve_slice(c, dev, expected, DECODE_PHASES, spec,
                                 teacher_waves=len(wave_lens), against="prefill")
        torch.cuda.empty_cache()
    full, ring = runs[False], runs[True]
    for run, local in ((full, spec.max_seq), (ring, min(W, spec.max_seq))):
        if run["cache_slots"] != [local, spec.max_seq] * (cfg.num_layers // 2):
            raise AssertionError(f"{GEMMA2_ARCH} cache slots {run['cache_slots']}, not "
                                 f"{local} on the local layers and {spec.max_seq} on the "
                                 "global ones")
    for name, run in (("full", full), ("ring", ring)):
        for i, w in enumerate(run["waves"]):
            mid = w["prompt_len"] + w["steps"] // 2
            nbytes, b = decode_step_bound_ms(cfg, run["param_bytes"], mid)
            w["step_bound_ms"] = b
            print(f"decode step bound {GEMMA2_ARCH} {name} caches wave {i + 1}: at kv_len {mid} "
                  f"(mid-wave) {nbytes / 1e9:.3f} GB, {b:.4f} ms at the HBM rate; measured "
                  f"{w['decode_ms_per_step']:.4f} ms a step ({b / w['decode_ms_per_step']:.3f} "
                  "of the bound's rate)", flush=True)
    same_tokens = sum(a.tokens == b.tokens for a, b in zip(full["finished"], ring["finished"]))
    for w, (a, b) in enumerate(zip(full["teachers"], ring["teachers"])):
        diff = float((a["decode_logits"] - b["decode_logits"]).abs().max())
        scale = float(a["decode_logits"].abs().max())
        agree = int((a["decode_logits"].argmax(-1) == b["decode_logits"].argmax(-1)).sum())
        print(f"ring vs full caches {GEMMA2_ARCH} wave {w + 1}: first decode logits max abs "
              f"diff {diff:.4f} of max |logit| {scale:.4f} (tol {TEACHER_TOL:g} x scale), "
              f"argmax agree {agree}/{a['rows']}", flush=True)
        if not diff <= TEACHER_TOL * scale:
            raise AssertionError(f"wave {w + 1}: the ring caches' decode parts from the full "
                                 "caches'")
    print(f"ring vs full caches {GEMMA2_ARCH}: {same_tokens}/{spec.requests} requests served "
          f"the same {spec.new} tokens; the local layers' caches {ring['cache_slots'][0]} "
          f"slots against {full['cache_slots'][0]}; peak memory full {full['peak_gib']:.3f} "
          f"GiB, ring {ring['peak_gib']:.3f} GiB", flush=True)

    # -- 7e. card against CPU, reduced ---------------------------------------------
    small = small_card_vs_cpu(cfg, dev)
    launches = {k: full["launches"][k] + ring["launches"][k]
                for k in ("flash_attention", "flash_decode")}
    print(f"phase 7 ({GEMMA2_ARCH}): {time.perf_counter() - t0:.1f} s", flush=True)
    return {"times": times, "full": full, "ring": ring, "launches": launches, "small": small}


MOE_OUTPUTS = ("idx", "gates", "slot", "counts", "buf")


def moe_work(probs, x, k: int, capacity: int, slot, shared: bool) -> dict:
    """Bytes each MoE kernel must move on these inputs (read once, written
    once), by kernel: the dispatch reads probs and each x row with a kept
    entry and writes the buffer (zeros included), idx, gates, slot and
    counts; the combine reads the kept rows of h, idx, slot, gates and the
    shared expert's output and writes y.  Their operations (E compares an
    entry, two an element a kept entry) are far below the f32 rate."""
    T, E = probs.shape
    d, es = x.shape[1], x.element_size()
    kept = slot >= 0
    n_kept, rows = int(kept.sum()), int(kept.any(dim=1).sum())
    dispatch = T * E * 4 + rows * d * es + E * capacity * d * es + 3 * T * k * 4 + E * 4
    combine = n_kept * d * es + 3 * T * k * 4 + (T * d * es if shared else 0) + T * d * es
    return {"moe_dispatch": (float(dispatch), float(T * k * E)),
            "moe_combine": (float(combine), float(2 * n_kept * d))}


def check_moe_bits(kernel: str, label: str, triples, record) -> None:
    """Each (what, kernel output, plain output) equal bit for bit; the
    largest abs difference goes into the record."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _bits import same_bits

    for what, got, want in triples:
        same, diff = same_bits(got, want)
        record[kernel]["max_abs_err"] = max(record[kernel]["max_abs_err"], diff)
        if not same:
            raise AssertionError(f"{kernel} {label}: {what} is not bit for bit the plain "
                                 f"version's (max abs err {diff:.3e})")


def check_moe_case(name: str, dev, record, *, timed=False) -> dict:
    """Both MoE kernels against their plain versions on the card at
    ``kernels.moe.MOE_CASES[name]`` (the combine with and without a shared
    expert's output); with ``timed``, each kernel (the combine without a
    shared expert, as granite runs it) beside its plain version and its
    bytes bound."""
    import torch
    from repro_torch.kernels.moe import moe_case, moe_combine_cuda, moe_dispatch_cuda
    from repro_torch.kernels.ref import moe_combine_ref, moe_dispatch_ref

    c = moe_case(name, seed=SERVE_SEED, device=dev)
    args = (c["probs"], c["x"], c["k"], c["capacity"])
    got = moe_dispatch_cuda(*args)
    want = moe_dispatch_ref(*args)
    torch.cuda.synchronize()
    check_moe_bits("moe_dispatch", name, zip(MOE_OUTPUTS, got, want), record)
    idx, gates, slot, counts, _ = want
    for shared in (None, c["shared"]):
        y = moe_combine_cuda(c["h"], idx, slot, gates, shared)
        check_moe_bits("moe_combine", f"{name} shared={shared is not None}",
                       [("y", y, moe_combine_ref(c["h"], idx, slot, gates, shared))], record)
    T, E = c["probs"].shape
    dropped = int((slot < 0).sum())
    line = (f"moe kernels {name:>16}: T={T} E={E} k={c['k']} d={c['x'].shape[1]} capacity "
            f"{c['capacity']} {str(c['x'].dtype)[6:]}, {dropped} of {T * c['k']} assignments "
            f"dropped, most routed to one expert {int(counts.max())}: dispatch (idx, gates, "
            "slot, counts, buffer) and combine (with and without shared) bit for bit")
    out = {}
    if timed:
        work = moe_work(*args, slot, shared=False)
        fns = {"moe_dispatch": (lambda: moe_dispatch_cuda(*args), lambda: moe_dispatch_ref(*args)),
               "moe_combine": (lambda: moe_combine_cuda(c["h"], idx, slot, gates, None),
                               lambda: moe_combine_ref(c["h"], idx, slot, gates, None))}
        for kernel, (kern, plain) in fns.items():
            b, by = bound_ms(*work[kernel])
            t = {"ms": time_ms(kern), "plain_ms": time_ms(plain, reps=10), "bound_ms": b,
                 "bound_by": by, "library_ms": None, "bytes": work[kernel][0]}
            out[kernel] = t
            line += (f" | {kernel} {t['ms']:.4f} ms ({t['bytes'] / t['ms'] / 1e6:.1f} GB/s of "
                     f"{t['bytes'] / 1e6:.3f} MB), bound {b:.4f} ms ({by}, {b / t['ms']:.3f} of "
                     f"it), plain {t['plain_ms']:.4f} ms")
    print(line, flush=True)
    return out


class MoeTap:
    """Wraps ``ops.moe_dispatch`` and ``ops.moe_combine`` while a model runs
    (``install`` / ``remove``): keeps, by reference and computing nothing on
    the card, each prefill's slots by layer and the inputs and outputs of
    the first MoE layer's first prefill and first decode step.  The model
    calls its MoE layers in order, one dispatch and one combine each, so a
    dispatch's layer is its call index modulo the number of MoE layers; a
    call over ``slots`` tokens is a decode step (``slots`` rows of one)."""

    def __init__(self, slots: int = SERVE_SLOTS):
        self.slots = slots
        self.prefills: list[list] = []        # a prefill: [(layer, slot [T, k], B)]
        self.captured: dict = {}              # "prefill" / "decode" -> {"dispatch", "combine"}
        self._pending = None

    def install(self, model) -> None:
        from repro_torch.kernels import ops

        self.layers = [i for i, b in enumerate(model.blocks) if b.is_moe]
        self.first = self.layers[0]
        self._calls = 0
        self._orig = (ops.moe_dispatch, ops.moe_combine)
        dispatch, combine = self._orig

        def tapped_dispatch(probs, x, k, capacity):
            out = dispatch(probs, x, k, capacity)
            self._on_dispatch(dict(probs=probs, x=x, k=k, capacity=capacity,
                                   **dict(zip(MOE_OUTPUTS, out))))
            return out

        def tapped_combine(h, idx, slot, gates, shared):
            y = combine(h, idx, slot, gates, shared)
            if self._pending is not None:
                self.captured[self._pending]["combine"] = dict(h=h, idx=idx, slot=slot,
                                                               gates=gates, shared=shared, y=y)
                self._pending = None
            return y

        ops.moe_dispatch, ops.moe_combine = tapped_dispatch, tapped_combine

    def remove(self, model) -> None:
        from repro_torch.kernels import ops

        ops.moe_dispatch, ops.moe_combine = self._orig

    def _on_dispatch(self, values: dict) -> None:
        layer = self.layers[self._calls % len(self.layers)]
        self._calls += 1
        T = values["probs"].shape[0]
        kind = "decode" if T == self.slots else "prefill"
        if kind == "prefill":
            if layer == self.first:
                self.prefills.append([])
            self.prefills[-1].append((layer, values["slot"], self.slots))
        if layer == self.first and kind not in self.captured:
            self.captured[kind] = {"dispatch": values}
            self._pending = kind

    def slot_drops(self, prefill: int):
        """Assignments dropped in one prefill: (by layer, by slot summed
        over the layers)."""
        by_layer, by_slot = [], 0
        for _, slot, B in self.prefills[prefill]:
            dropped = (slot < 0).reshape(B, -1).sum(dim=1)
            by_layer.append(int(dropped.sum()))
            by_slot = by_slot + dropped
        return by_layer, by_slot.tolist()


def check_captured_moe(tap: MoeTap, record) -> None:
    """The serve's own MoE launches at the first MoE layer of its first
    prefill and first decode step: their outputs against the plain
    versions on the captured inputs, bit for bit."""
    from repro_torch.kernels.ref import moe_combine_ref, moe_dispatch_ref

    for kind in ("prefill", "decode"):
        d, c = tap.captured[kind]["dispatch"], tap.captured[kind]["combine"]
        want = moe_dispatch_ref(d["probs"], d["x"], d["k"], d["capacity"])
        check_moe_bits("moe_dispatch", f"serve {kind}",
                       [(w, d[w], v) for w, v in zip(MOE_OUTPUTS, want)], record)
        y = moe_combine_ref(c["h"], c["idx"], c["slot"], c["gates"], c["shared"])
        check_moe_bits("moe_combine", f"serve {kind}", [("y", c["y"], y)], record)
        T, E = d["probs"].shape
        print(f"moe serve capture ({kind}, layer {tap.first}, T={T}, capacity "
              f"{d['capacity']}): the serve's dispatch and combine outputs bit for bit the "
              f"plain versions on its inputs; {int((d['slot'] < 0).sum())} of {T * d['k']} "
              "assignments dropped", flush=True)


def moe_teacher_check(model, reqs, dev, spec: ServeSpec = DENSE_SPEC,
                      require_slot0: bool = True) -> dict:
    """Wave 1's first decode logits against the last logits of a ``prefill``
    over its padded prompts plus those tokens, row by row.  The two runs
    prefill different lengths, so their capacities differ and a slot can
    lose assignments in one and not the other (the reference's semantics:
    left pads route alike and fill their experts, and the stable sort keeps
    the earlier slots' entries); a slot is held to TEACHER_TOL only when it
    lost none in either run.  Slot 0 never does when an expert's capacity
    holds a whole prompt (its entries come first), and must then be held;
    with ``require_slot0`` False (a capacity below the prompt length, where
    slot 0's own tokens can overflow an expert) it is held only if it lost
    none."""
    import torch

    tokens, tok0 = padded_wave(reqs, dev, spec)
    taps = [MoeTap(spec.slots), MoeTap(spec.slots)]
    taps[0].install(model)
    cache = model.init_cache(spec.slots, spec.max_seq)
    _, cache = model.prefill({"tokens": tokens}, cache)
    dec, cache = model.decode_step(tok0, cache)
    taps[0].remove(model)
    del cache
    taps[1].install(model)
    full, _ = model.prefill({"tokens": torch.cat([tokens, tok0], dim=1)},
                            model.init_cache(spec.slots, spec.max_seq))
    taps[1].remove(model)
    got, want = dec[:, 0].float(), full[:, -1].float()
    drops = [tap.slot_drops(0)[1] for tap in taps]
    n = len(reqs)
    checked = [i for i in range(n) if drops[0][i] == 0 and drops[1][i] == 0]
    skipped = {i: (drops[0][i], drops[1][i]) for i in range(n) if i not in checked}
    rows = torch.tensor(checked, dtype=torch.long, device=dev)
    err = (got - want).abs().max(dim=1).values
    scale = float(want[rows].abs().max()) if checked else float("nan")
    out = {"checked": checked, "skipped": skipped,
           "max_abs_err": float(err[rows].max()) if checked else float("nan"), "scale": scale,
           "row_err": err[:n].tolist(),
           "argmax_agree": int((got.argmax(-1) == want.argmax(-1))[rows].sum()),
           "finite": bool(torch.isfinite(dec).all() and torch.isfinite(full).all()),
           "drops": drops}
    print(f"teacher-forced check {model.cfg.arch_id} (wave 1): decode vs prefill over the "
          f"padded prompt + token, rows checked {checked} (no assignment dropped in either run), "
          f"max abs err {out['max_abs_err']:.4f} of max |logit| {scale:.4f} (tol "
          f"{TEACHER_TOL:g} x scale), argmax agree {out['argmax_agree']}/{len(checked)}; "
          "skipped (assignments dropped in the wave's prefill, in the teacher's prefill): "
          + (", ".join(f"slot {i} {a}, {b}" for i, (a, b) in skipped.items()) or "none")
          + "; every row's err " + ", ".join(f"{e:.4f}" for e in out["row_err"]), flush=True)
    if not out["finite"]:
        raise AssertionError("non-finite logits at full width (MoE)")
    if 0 not in checked and require_slot0:
        raise AssertionError("slot 0 lost assignments: its entries come first in the flat "
                             "order and cannot be dropped")
    if checked and not out["max_abs_err"] <= TEACHER_TOL * scale:
        raise AssertionError("MoE decode logits part from the teacher-forced prefill on a slot "
                             "that lost no assignment")
    del full, dec
    return out

def dropless_teacher_check(model, reqs, dev, spec: ServeSpec, *, tol: float, hold) -> dict:
    """``moe_teacher_check`` with every MoE layer's capacity raised past
    what a call can route (capacity factor E / k + 1: capacity > T), so that
    neither run drops an assignment and the two differ only by their
    arithmetic: wave 1's first decode logits against the last logits of a
    prefill over the padded prompts plus those tokens, the rows ``hold``
    (slot indices) within ``tol`` of the largest logit; each slot's error
    and the MoE layers whose top-k experts for that token differ between the
    runs (near ties that the two paths' roundings decide otherwise) are
    printed.  The model's MoE configs are put back after."""
    import torch
    from repro_torch.kernels import ops

    cfg = model.cfg
    moes = [b.moe for b in model.blocks if b.is_moe]
    saved = [m.cfg for m in moes]
    factor = cfg.num_experts / cfg.top_k + 1
    calls = []                                     # (idx [T, k], assignments dropped)
    dispatch = ops.moe_dispatch

    def tapped(probs, x, k, capacity):
        out = dispatch(probs, x, k, capacity)
        calls.append((out[0], (out[2] < 0).sum()))
        return out

    tokens, tok0 = padded_wave(reqs, dev, spec)
    try:
        for m in moes:
            m.cfg = dataclasses.replace(m.cfg, capacity_factor=factor)
        ops.moe_dispatch = tapped
        cache = model.init_cache(spec.slots, spec.max_seq)
        _, cache = model.prefill({"tokens": tokens}, cache)
        dec, cache = model.decode_step(tok0, cache)
        del cache
        full, _ = model.prefill({"tokens": torch.cat([tokens, tok0], dim=1)},
                                model.init_cache(spec.slots, spec.max_seq))
    finally:
        ops.moe_dispatch = dispatch
        for m, c in zip(moes, saved):
            m.cfg = c
    n, L, k = len(reqs), len(moes), cfg.top_k
    dropped = int(sum(int(d) for _, d in calls))
    decode_idx = [idx for idx, _ in calls[L:2 * L]]
    teacher_idx = [idx.reshape(spec.slots, -1, k)[:, -1] for idx, _ in calls[2 * L:]]
    differs = {i: [l for l in range(L)
                   if not torch.equal(decode_idx[l][i].sort().values,
                                      teacher_idx[l][i].sort().values)] for i in range(n)}
    got, want = dec[:, 0].float(), full[:, -1].float()
    err = (got - want).abs().max(dim=1).values[:n].tolist()
    scale = float(want[:n].abs().max())
    held = max(err[i] for i in hold)
    out = {"factor": factor, "dropped": dropped, "row_err": err, "scale": scale,
           "held": list(hold), "max_abs_err": held, "differs": differs,
           "argmax_agree": int((got.argmax(-1) == want.argmax(-1))[:n].sum()),
           "finite": bool(torch.isfinite(dec).all() and torch.isfinite(full).all())}
    print(f"dropless teacher-forced check {cfg.arch_id} {str(model.dtype)[6:]} at "
          f"{cfg.num_layers} layers (wave 1, capacity factor {factor:.4f}, {dropped} "
          f"assignments dropped in {len(calls)} dispatches): decode vs prefill over the padded "
          f"prompt + token, rows held {list(hold)} max abs err {held:.3e} of max |logit| "
          f"{scale:.4f} (tol {tol:g} x scale); every row's err "
          + ", ".join(f"{e:.3e}" for e in err)
          + "; MoE layers whose top-k set differs, by slot: "
          + ", ".join(f"slot {i} {v}" for i, v in differs.items() if v)
          + f"; argmax agree {out['argmax_agree']}/{n}, all finite {out['finite']}", flush=True)
    if dropped or len(calls) != 3 * L:
        raise AssertionError(f"dropless check: {dropped} dropped, {len(calls)} dispatches")
    if not out["finite"]:
        raise AssertionError(f"non-finite logits at full width ({cfg.arch_id})")
    if not held <= tol * scale:
        raise AssertionError(f"{cfg.arch_id} decode logits part from the teacher-forced prefill "
                             f"on rows {list(hold)} with nothing dropped")
    del full, dec
    return out


def moe_small_card_vs_cpu(dev) -> list[dict]:
    """Phase 8e: reduced granite and deepseek (with MLA, and with mla=False)
    in f32 on the card and on the CPU's plain path: a prefill and decode steps within
    SMALL_REL of scale, one dispatch and one combine launch an MoE layer a
    call on the card, and forward_train's aux loss within 1e-6."""
    import copy

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_port import reduced_moe_configs

    B, S, steps, Smax = MOE_SMALL
    out = []
    for name, cfg in reduced_moe_configs().items():
        cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
        card_model = copy.deepcopy(cpu_model).to(dev)
        toks = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab_size,
                                                                 (B, S + steps)))
        runs = {}
        for where, model in (("cpu", cpu_model), ("card", card_model)):
            ops.reset_launch_counts()
            cache = model.init_cache(B, Smax)
            logits, cache = model.prefill({"tokens": toks[:, :S].to(model.device)}, cache)
            got = [logits.cpu()]
            for s in range(S, S + steps):
                logits, cache = model.decode_step(toks[:, s:s + 1].to(model.device), cache)
                got.append(logits.cpu())
            counts = dict(ops.launch_counts)
            _, aux = model.forward_train({"tokens": toks.to(model.device)})
            runs[where] = (got, float(aux), counts)
        (cl, caux, _), (gl, gaux, counts) = runs["cpu"], runs["card"]
        rel = max(float((a.double() - b.double()).abs().max() / b.double().abs().max())
                  for a, b in zip(gl, cl))
        n_moe = sum(b.is_moe for b in card_model.blocks)
        print(f"reduced {name}: prefill {S} then {steps} decode steps, card vs CPU logits max rel "
              f"{rel:.3e} (limit {SMALL_REL:g}), aux {gaux:.8f} vs {caux:.8f}, launches "
              f"moe_dispatch {counts['moe_dispatch']}, moe_combine {counts['moe_combine']} "
              f"({n_moe} MoE layers of {cfg.num_layers})", flush=True)
        if not (rel <= SMALL_REL and abs(gaux - caux) <= 1e-6):
            raise AssertionError(f"reduced {name}: the card parts from the CPU")
        if counts["moe_dispatch"] != counts["moe_combine"] or counts["moe_dispatch"] != n_moe * (
                1 + steps):
            raise AssertionError(f"reduced {name} launches {counts}")
        out.append({"name": name, "logit_rel": rel, "aux": (gaux, caux)})
    return out


def moe_phase(dev, record) -> dict:
    """Phase 8: the MoE kernels at the shared cases (timed at granite's
    prefill and decode shapes) and the flash kernels at granite's heads,
    then full-width granite-moe-1b-a400m serves the slice's requests, then
    reduced granite and deepseek (with MLA, and with mla=False) on card and
    CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe import MOE_CASES, reference_capacity

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # the f32 plain versions in full f32
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(MOE_ARCH)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    # -- 8a. the MoE kernels against their plain versions, 8b. the flash kernels
    times = {name: check_moe_case(name, dev, record, timed=name in MOE_TIMED)
             for name in MOE_CASES}
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 3)
    wave_lens = wave_lengths(cfg)
    times["prefill_attention"] = check_flash_attention(
        f"granite B=8 S={wave_lens[0]} H={H} KV={KV} D={D} bf16", (SERVE_SLOTS, wave_lens[0], H,
                                                                   KV, D),
        bf16, dev, gen, record, timed=True)
    check_flash_attention(f"granite odd B=3 S=333 D={D} f32", (3, 333, H, KV, D), f32, dev, gen,
                          record)
    main_len = wave_lens[0] + SERVE_NEW - 1
    dshape = (SERVE_SLOTS, SERVE_MAX_SEQ, H, KV, D)
    times["decode_attention"] = check_flash_decode(
        f"granite B=8 Smax={SERVE_MAX_SEQ} D={D} bf16", dshape, bf16, dev, gen, record,
        (1, 17, 1000, SERVE_MAX_SEQ, main_len), timed_len=main_len)
    check_flash_decode(f"granite B=8 Smax={SERVE_MAX_SEQ} D={D} f32", dshape, f32, dev, gen,
                       record, (1, 17, 1000, SERVE_MAX_SEQ))

    # -- 8c. the slice, its checks -------------------------------------------------
    tap = MoeTap()
    moe_layers = cfg.num_layers - cfg.first_dense_layers

    def expected(waves, steps):
        return {"flash_attention": cfg.num_layers * waves, "flash_decode": cfg.num_layers * steps,
                "moe_dispatch": moe_layers * (waves + steps),
                "moe_combine": moe_layers * (waves + steps)}

    def checks(model, finished):
        check_captured_moe(tap, record)
        return moe_teacher_check(model, finished[:SERVE_SLOTS], dev)

    run = serve_slice(cfg, dev, expected, MOE_DECODE_PHASES, teacher_waves=0,
                      hooks=(tap.install, tap.remove), checks=checks)
    for w in range(len(tap.prefills)):
        by_layer, by_slot = tap.slot_drops(w)
        _, slot, B = tap.prefills[w][0]
        T = slot.shape[0]
        capacity = reference_capacity(T, cfg.top_k, cfg.num_experts, cfg.capacity_factor, T // B)
        print(f"moe drops {MOE_ARCH} prefill {w + 1} (T={T}, capacity {capacity}): "
              f"{sum(by_layer)} of {slot.numel() * len(by_layer)} assignments dropped; by layer "
              f"{by_layer}; by slot {by_slot}", flush=True)
    run["drops"] = [tap.slot_drops(w) for w in range(len(tap.prefills))]
    for i, w in enumerate(run["waves"]):
        mid = w["prompt_len"] + w["steps"] // 2
        nbytes, b = decode_step_bound_ms(cfg, run["param_bytes"], mid)
        w["step_bound_ms"] = b
        print(f"decode step bound {MOE_ARCH} wave {i + 1}: at kv_len {mid} (mid-wave) "
              f"{nbytes / 1e9:.4f} GB (every weight, all 32 experts' included, and the cache "
              f"rows), {b:.4f} ms at the HBM rate; measured {w['decode_ms_per_step']:.4f} ms a "
              f"step ({b / w['decode_ms_per_step']:.3f} of the bound's rate)", flush=True)
    tap.captured.clear()
    torch.cuda.empty_cache()

    # -- 8d. card against CPU, reduced ---------------------------------------------
    small = moe_small_card_vs_cpu(dev)
    launches = {k: run["launches"][k] for k in expected(0, 0)}
    print(f"phase 8 ({MOE_ARCH}): {time.perf_counter() - t0:.1f} s", flush=True)
    return {"times": times, "run": run, "launches": launches, "small": small}

def mla_step_bound_ms(cfg, param_bytes: int, kv_len: int,
                      spec: ServeSpec = MLA_SPEC) -> tuple[float, float]:
    """(bytes, ms at the HBM rate) one MLA decode step at kv_len moves as the
    port computes it (the reference's baseline, the whole cache expanded a
    step): every weight once (all 64 experts of every MoE layer: the
    experts' bmm reads them all) and in each layer the compressed cache
    [B, Smax, kv_lora + rope] read by the expansion, the expanded K and V
    [B, Smax, H, D + Dv] written by it, and their rows < kv_len read by
    ``flash_decode``."""
    B, Smax, H = spec.slots, spec.max_seq, cfg.num_heads
    width = cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim
    per_layer = (B * Smax * (cfg.kv_lora_rank + cfg.qk_rope_dim) + B * Smax * H * width
                 + B * kv_len * H * width) * 2
    nbytes = param_bytes + cfg.num_layers * per_layer
    return float(nbytes), nbytes / HBM_BYTES_PER_S * 1e3


def mla_phase(dev, record) -> dict:
    """Phase 9: the flash kernels with a V head dim of their own at
    deepseek-v2-lite's shapes, then full-width deepseek-v2-lite-16b serves
    the slice's requests (MLA over its compressed cache, the MoE kernels at
    E=64, k=6, d=2,048)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import choose_body
    from repro_torch.kernels.moe import reference_capacity
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # the f32 plain versions in full f32
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(MLA_ARCH)
    H, D, dv = cfg.num_heads, cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    Smax = MLA_SPEC.max_seq

    # -- 9a. flash_attention, 9b. flash_decode with K of D = 192 and V of 128
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 4)
    wave_lens = wave_lengths(cfg, MLA_SPEC)
    times = {"prefill_attention": check_flash_attention(
        f"deepseek B=8 S={wave_lens[0]} H=KV={H} D={D} Dv={dv} bf16",
        (SERVE_SLOTS, wave_lens[0], H, H, D), bf16, dev, gen, record, timed=True, dv=dv,
        body="wgmma")}
    check_flash_attention(f"deepseek odd B=3 S=333 D={D} Dv={dv} bf16", (3, 333, H, H, D), bf16,
                          dev, gen, record, dv=dv, body="wgmma")
    check_flash_attention(f"deepseek window 64 softcap 50 B=2 S=300 Dv={dv} bf16",
                          (2, 300, H, H, D), bf16, dev, gen, record, dv=dv, window=64,
                          softcap=50.0, body="wgmma")
    check_flash_attention(f"deepseek B=2 S=300 D={D} Dv={dv} f32", (2, 300, H, H, D), f32, dev,
                          gen, record, dv=dv, body="simt")
    check_flash_attention("reduced MLA odd B=2 S=77 H=KV=4 D=24 Dv=16 f32", (2, 77, 4, 4, 24),
                          f32, dev, gen, record, dv=16, body="simt")
    main_len = wave_lens[0] + SERVE_NEW - 1
    dshape = (SERVE_SLOTS, Smax, H, H, D)
    if choose_body(bf16, 1, D, dv) != "simt":
        raise AssertionError("MLA's decode is not on the SIMT body")
    times["decode_attention"] = check_flash_decode(
        f"deepseek B=8 Smax={Smax} D={D} Dv={dv} bf16", dshape, bf16, dev, gen, record,
        (1, 17, 1000, Smax, main_len), timed_len=main_len, dv=dv)
    check_flash_decode(f"deepseek B=8 Smax={Smax} D={D} Dv={dv} f32", dshape, f32, dev, gen,
                       record, (1, 17, 1000, Smax), dv=dv)
    check_flash_decode(f"deepseek window 256 softcap 50 Dv={dv} bf16", dshape, bf16, dev, gen,
                       record, (1, 300, 1000, Smax), dv=dv, window=256, softcap=50.0)
    check_flash_decode("reduced MLA odd B=3 Smax=130 D=24 Dv=16 f32", (3, 130, 4, 4, 24), f32,
                       dev, gen, record, (1, 17, 64, 65, 130), dv=16)

    # -- 9c. the slice, its checks -------------------------------------------------
    tap = MoeTap()
    moe_layers = cfg.num_layers - cfg.first_dense_layers

    def expected(waves, steps):
        return {"flash_attention": cfg.num_layers * waves, "flash_decode": cfg.num_layers * steps,
                "moe_dispatch": moe_layers * (waves + steps),
                "moe_combine": moe_layers * (waves + steps)}

    def checks(model, finished):
        check_captured_moe(tap, record)
        wave1 = finished[:SERVE_SLOTS]
        return {"by_rule": moe_teacher_check(model, wave1, dev, MLA_SPEC, require_slot0=False),
                "dropless": dropless_teacher_check(model, wave1, dev, MLA_SPEC, tol=TEACHER_TOL,
                                                   hold=[0])}

    run = serve_slice(cfg, dev, expected, MLA_DECODE_PHASES, MLA_SPEC, teacher_waves=0,
                      hooks=(tap.install, tap.remove), checks=checks)
    t = time.perf_counter()
    cut = dataclasses.replace(cfg, param_dtype="float32", num_layers=MLA_F32_LAYERS)
    small = build_model(cut, device=dev, generator=torch.Generator(device=dev).manual_seed(
        SERVE_SEED))
    run["checks"]["f32"] = dropless_teacher_check(small, run["wave1"], dev, MLA_SPEC,
                                                  tol=TEACHER_F32_TOL, hold=range(SERVE_SLOTS))
    del small
    torch.cuda.empty_cache()
    print(f"f32 dropless check {MLA_ARCH} at {MLA_F32_LAYERS} layers: "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if run["cache_slots"] != [Smax] * cfg.num_layers:
        raise AssertionError(f"{MLA_ARCH} cache slots {run['cache_slots']}")
    for w in range(len(tap.prefills)):
        by_layer, by_slot = tap.slot_drops(w)
        _, slot, B = tap.prefills[w][0]
        T = slot.shape[0]
        capacity = reference_capacity(T, cfg.top_k, cfg.num_experts, cfg.capacity_factor, T // B)
        print(f"moe drops {MLA_ARCH} prefill {w + 1} (T={T}, capacity {capacity}): "
              f"{sum(by_layer)} of {slot.numel() * len(by_layer)} assignments dropped; by layer "
              f"{by_layer}; by slot {by_slot}", flush=True)
    run["drops"] = [tap.slot_drops(w) for w in range(len(tap.prefills))]
    for i, w in enumerate(run["waves"]):
        mid = w["prompt_len"] + w["steps"] // 2
        nbytes, b = mla_step_bound_ms(cfg, run["param_bytes"], mid)
        w["step_bound_ms"] = b
        print(f"decode step bound {MLA_ARCH} wave {i + 1}: at kv_len {mid} (mid-wave) "
              f"{nbytes / 1e9:.4f} GB (every weight, all 64 experts' included, and each layer's "
              f"compressed cache read, K and V expanded over Smax={Smax} and read to kv_len), "
              f"{b:.4f} ms at the HBM rate; measured {w['decode_ms_per_step']:.4f} ms a step "
              f"({b / w['decode_ms_per_step']:.3f} of the bound's rate)", flush=True)
    tap.captured.clear()
    torch.cuda.empty_cache()
    launches = {k: run["launches"][k] for k in expected(0, 0)}
    print(f"phase 9 ({MLA_ARCH}): {time.perf_counter() - t0:.1f} s", flush=True)
    return {"times": times, "run": run, "launches": launches}


def reduced_card_vs_cpu(arch: str, dev) -> dict:
    """Reduced ``arch`` in f32 on the card and on the CPU's plain path, the
    same weights: phi-3-vision a prefill over its patches and 12 text
    tokens, then REDUCED_STEPS decode steps; hubert a forward with and
    without a mask and a prefill; xlstm a forward, a prefill of 12 tokens
    and REDUCED_STEPS decode steps, and its caches.  Logits (and xlstm's
    cache leaves) within SMALL_REL of their scale, one flash_attention
    launch a layer a forward on the card (xlstm: one scan launch a layer a
    call, no attention)."""
    import copy

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, reduce_for_smoke

    cfg = reduce_for_smoke(get_config(arch))
    cpu = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(7))
    card = copy.deepcopy(cpu).to(dev)
    rng = np.random.default_rng(7)
    runs = {}
    if cfg.family == "audio":
        frames = torch.as_tensor(rng.normal(0, 1, (2, 77, cfg.d_model)).astype(np.float32))
        mask = torch.as_tensor(rng.random((2, 77)) < 0.3)
        what = "forward with a mask, without, prefill (S=77)"
        for name, model in (("cpu", cpu), ("card", card)):
            ops.reset_launch_counts()
            got = [model.forward_train({"frames": frames, "mask": mask})[0].cpu(),
                   model.forward_train({"frames": frames})[0].cpu(),
                   model.prefill({"frames": frames})[0].cpu()]
            runs[name] = (got, dict(ops.launch_counts))
        want = {"flash_attention": 3 * cfg.num_layers, "flash_decode": 0}
    elif cfg.family == "ssm":
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12 + REDUCED_STEPS)))
        what = (f"forward_train over {12 + REDUCED_STEPS} tokens, a prefill of 12, "
                f"{REDUCED_STEPS} decode steps, every cache leaf")
        for name, model in (("cpu", cpu), ("card", card)):
            ops.reset_launch_counts()
            got = [model.forward_train({"tokens": toks})[0].cpu()]
            cache = model.init_cache(2, 40)
            logits, cache = model.prefill({"tokens": toks[:, :12]}, cache)
            got.append(logits.cpu())
            for s in range(12, 12 + REDUCED_STEPS):
                logits, cache = model.decode_step(toks[:, s:s + 1].to(model.device), cache)
                got.append(logits.cpu())
            got += [t.cpu() for layer in cache["layers"] for t in layer.values()]
            runs[name] = (got, dict(ops.launch_counts))
        n_s, calls = sum(cpu.is_slstm), 2 + REDUCED_STEPS
        want = {"mlstm_scan": (cfg.num_layers - n_s) * calls, "slstm_scan": n_s * calls,
                "flash_attention": 0, "flash_decode": 0}
    else:
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12 + REDUCED_STEPS)))
        patches = torch.as_tensor(rng.normal(0, 1, (2, cfg.num_patches, cfg.d_model))
                                  .astype(np.float32))
        what = (f"prefill over {cfg.num_patches} patches + 12 tokens, {REDUCED_STEPS} decode "
                "steps")
        for name, model in (("cpu", cpu), ("card", card)):
            ops.reset_launch_counts()
            cache = model.init_cache(2, 40)
            logits, cache = model.prefill({"tokens": toks[:, :12], "vision_embeds": patches},
                                          cache)
            got = [logits.cpu()]
            for s in range(12, 12 + REDUCED_STEPS):
                logits, cache = model.decode_step(toks[:, s:s + 1].to(model.device), cache)
                got.append(logits.cpu())
            if int(cache["pos"]) != cfg.num_patches + 12 + REDUCED_STEPS:
                raise AssertionError(f"reduced {arch}: cache pos {int(cache['pos'])}")
            runs[name] = (got, dict(ops.launch_counts))
        want = {"flash_attention": cfg.num_layers, "flash_decode": REDUCED_STEPS * cfg.num_layers}
    (cl, _), (gl, counts) = runs["cpu"], runs["card"]
    rel = max(float((a.double() - b.double()).abs().max() / (b.double().abs().max() + 1e-30))
              for a, b in zip(gl, cl))
    print(f"reduced {arch} f32 ({what}): card vs CPU logits max rel {rel:.3e} (limit "
          f"{SMALL_REL:g}), launches " + ", ".join(f"{k} {counts[k]}" for k in want), flush=True)
    if not rel <= SMALL_REL:
        raise AssertionError(f"reduced {arch}: the card parts from the CPU")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"reduced {arch} launches {counts}, expected {want}")
    return {"logit_rel": rel}


def vlm_phase(dev, record) -> dict:
    """Phase 10: the flash kernels at phi-3-vision's shapes (D = 96, H = KV
    = 32), then full-width phi-3-vision-4.2b takes an image prefix: one
    prefill over 256 patch embeddings and 768 text tokens a sequence, then
    VLM_STEPS decode steps, the counts zeroed just before; a repeat, the
    teacher-forced check, a profiled step; then the 16 requests of phase 4
    served text-only through ``ServeEngine``; then reduced phi-3-vision
    card against CPU."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as FD
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import body_launches
    from repro_torch.models import build_model
    from repro_torch.train.serve_step import greedy

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False     # the f32 plain versions in full f32
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(VLM_ARCH)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, P, T, Smax, steps = VLM_BATCH, cfg.num_patches, VLM_TEXT, VLM_MAX_SEQ, VLM_STEPS
    S = P + T
    last = S + steps                      # kv_len at the last decode step
    body = FD.choose_body(bf16, H // KV, D)

    # -- 10a. flash_attention, 10b. flash_decode at D = 96 ----------------------------
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 5)
    times = {"prefill_attention": check_flash_attention(
        f"phi-3 B={B} S={S} H=KV={H} D={D} bf16", (B, S, H, KV, D), bf16, dev, gen, record,
        timed=True, body="wgmma")}
    check_flash_attention(f"phi-3 B={B} S={S} H=KV={H} D={D} f32", (B, S, H, KV, D), f32, dev,
                          gen, record, body="simt")
    check_flash_attention(f"phi-3 odd B=3 S=333 D={D} bf16", (3, 333, H, KV, D), bf16, dev, gen,
                          record, body="wgmma")
    dshape = (B, Smax, H, KV, D)
    times["decode_attention"] = check_flash_decode(
        f"phi-3 B={B} Smax={Smax} D={D} G=1 bf16 ({body})", dshape, bf16, dev, gen, record,
        (1, 17, 1000, last, Smax), timed_len=last)
    check_flash_decode(f"phi-3 B={B} Smax={Smax} D={D} f32", dshape, f32, dev, gen, record,
                       (1, 17, 1000, last, Smax))
    check_flash_decode(f"phi-3 window 256 softcap 50 D={D} bf16", dshape, bf16, dev, gen,
                       record, (1, 300, 1000, Smax), window=256, softcap=50.0)
    check_flash_decode(f"odd B=3 Smax=777 H=16 KV=2 D={D} bf16", (3, 777, 16, 2, D), bf16, dev,
                       gen, record, (1, 17, 65, 333, 777))
    # the other body at phi-3's decode, for the choice of body: the wrapper's
    # choice forced to SIMT for these calls only
    chosen = FD.choose_body
    FD.choose_body = lambda *args: "simt"
    try:
        times["decode_attention_simt"] = check_flash_decode(
            f"phi-3 B={B} Smax={Smax} D={D} G=1 bf16 (simt, forced)", dshape, bf16, dev, gen,
            record, (1, 17, last), timed_len=last)
    finally:
        FD.choose_body = chosen
    times["prefill_attention"]["shape"] = f"B={B} S={S} H=KV={H} D={D} causal bf16"
    for key in ("decode_attention", "decode_attention_simt"):
        times[key]["shape"] = f"B={B} Smax={Smax} kv_len={last} H=KV={H} D={D} bf16"
    print(f"flash_decode at phi-3's decode: the {body} body (choose_body) "
          f"{times['decode_attention']['ms']:.4f} ms, the SIMT body "
          f"{times['decode_attention_simt']['ms']:.4f} ms", flush=True)

    # -- 10c. the image path -------------------------------------------------------
    t = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
        SERVE_SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{VLM_ARCH}: {n_params / 1e9:.4f} B parameters, {param_bytes / 1e9:.4f} GB (bf16), "
          f"built in {time.perf_counter() - t:.3f} s", flush=True)
    rng = np.random.default_rng(SERVE_SEED + 5)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
                                       device=dev),
             "vision_embeds": seeded_normal((B, P, cfg.d_model), bf16, dev,
                                            torch.Generator(device=dev).manual_seed(
                                                SERVE_SEED + 6))}

    def image_run():
        """Prefill, then ``steps`` greedy decode steps, each token read on
        the host as ``ServeEngine`` reads it -> (tokens [B, 1 + steps],
        TTFT s, decode ms a step, the first step's logits f32 [B, V], the
        cache, the last token)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        cache = model.init_cache(B, Smax)
        logits, cache = model.prefill(batch, cache)
        tok = greedy(logits)
        toks = [tok.cpu()]
        ttft = time.perf_counter() - t
        t = time.perf_counter()
        first = None
        for i in range(steps):
            logits, cache = model.decode_step(tok, cache)
            if first is None:
                first = logits[:, 0].float()
            tok = greedy(logits)
            toks.append(tok.cpu())
        ms = (time.perf_counter() - t) / steps * 1e3
        if int(cache["pos"]) != last:
            raise AssertionError(f"{VLM_ARCH}: cache pos {int(cache['pos'])}, expected {last}")
        return torch.cat(toks, dim=1), ttft, ms, first, cache, tok

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    toks, ttft, step_ms, first, cache, tok = image_run()
    launches, bodies = dict(ops.launch_counts), dict(body_launches)
    peak = torch.cuda.max_memory_allocated()
    want = {"flash_attention": cfg.num_layers, "flash_decode": cfg.num_layers * steps}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{VLM_ARCH} image path launched {launches}, expected {want}")
    if bodies != {"simt": 0, "wgmma": cfg.num_layers}:
        raise AssertionError(f"{VLM_ARCH} prefill took the flash_attention bodies {bodies}")
    nbytes, bound = decode_step_bound_ms(cfg, param_bytes, S + steps // 2, slots=B)
    print(f"image path {VLM_ARCH}: B={B}, {P} patches + {T} text tokens a sequence, prefill "
          f"then {steps} decode steps: TTFT {ttft * 1e3:.3f} ms, decode {step_ms:.4f} ms a step "
          f"({step_ms / B:.4f} ms a token) against a bound of {bound:.4f} ms ({nbytes / 1e9:.4f} "
          f"GB at kv_len {S + steps // 2}: every weight and each layer's k and v rows) = "
          f"{bound / step_ms:.3f} of it; launches flash_attention {launches['flash_attention']} "
          f"(bodies {bodies}), flash_decode {launches['flash_decode']} on the {body} body; peak "
          f"memory {peak / 2**30:.3f} GiB", flush=True)
    prof = device_profile(lambda: model.decode_step(tok, cache))
    idle = None if prof["busy_s"] is None else 1.0 - prof["busy_s"] / prof["span_s"]
    print(solve_profile_line(f"profile {VLM_ARCH}: one decode step at kv_len {last + 1}", prof),
          flush=True)
    del cache
    again, ttft2, step_ms2, _, cache, _ = image_run()
    del cache
    same = torch.equal(again, toks)
    print(f"repeat image path {VLM_ARCH}: TTFT {ttft2 * 1e3:.3f} ms, {step_ms2:.4f} ms a step, "
          f"tokens identical {same}", flush=True)
    if not same:
        raise AssertionError(f"a second {VLM_ARCH} image run gave other tokens")
    full, _ = model.forward_train({"tokens": torch.cat([batch["tokens"], toks[:, :1].to(dev)], 1),
                                   "vision_embeds": batch["vision_embeds"]})
    want_logits = full[:, -1].float()
    del full
    err, scale = float((first - want_logits).abs().max()), float(want_logits.abs().max())
    finite = bool(torch.isfinite(first).all() and torch.isfinite(want_logits).all())
    print(f"teacher-forced check {VLM_ARCH}: the first decode logits vs forward_train over "
          f"patches + text + that token, max abs err {err:.4f} of max |logit| {scale:.4f} (tol "
          f"{TEACHER_TOL:g} x scale), argmax agree "
          f"{int((first.argmax(-1) == want_logits.argmax(-1)).sum())}/{B}, all finite {finite}",
          flush=True)
    if not (finite and err <= TEACHER_TOL * scale):
        raise AssertionError(f"{VLM_ARCH} decode logits part from the teacher-forced pass")
    torch.cuda.empty_cache()
    image = {"launches": launches, "ttft_s": ttft, "decode_ms_per_step": step_ms,
             "step_bound_ms": bound, "idle": idle, "peak_gib": peak / 2**30,
             "teacher_err": err, "teacher_scale": scale}

    # -- 10d. text-only serve, 10e. reduced card against CPU ---------------------------
    serve = serve_slice(cfg, dev, lambda waves, steps: {
        "flash_attention": cfg.num_layers * waves, "flash_decode": cfg.num_layers * steps},
        DECODE_PHASES, model=model)
    del model
    torch.cuda.empty_cache()
    small = reduced_card_vs_cpu(VLM_ARCH, dev)
    launches = {k: image["launches"][k] + serve["launches"][k]
                for k in ("flash_attention", "flash_decode")}
    print(f"phase 10 ({VLM_ARCH}): {time.perf_counter() - t0:.1f} s", flush=True)
    return {"times": times, "image": image, "serve": serve, "small": small,
            "launches": launches,
            "by_path": {"image": {k: image["launches"][k] for k in launches},
                        "text": {k: serve["launches"][k] for k in launches}}}


class AttentionTap:
    """Wraps ``ops.flash_attention`` while a model runs (``install`` /
    ``remove``): records each call's ``causal`` flag and keeps, by
    reference and computing nothing on the card, the first call's inputs,
    keyword arguments and output."""

    def __init__(self):
        self.causal: list = []
        self.first = None

    def install(self) -> None:
        from repro_torch.kernels import ops

        self._orig = ops.flash_attention
        orig = self._orig

        def tapped(q, k, v, **kw):
            out = orig(q, k, v, **kw)
            self.causal.append(kw.get("causal", True))
            if self.first is None:
                self.first = (q, k, v, kw, out)
            return out

        ops.flash_attention = tapped

    def remove(self) -> None:
        from repro_torch.kernels import ops

        ops.flash_attention = self._orig


def check_captured_attention(tap: AttentionTap, record) -> float:
    """The encoder's own layer-0 ``flash_attention`` launch against the
    plain version on the inputs it received, AUDIO_CHUNK query rows at a
    time (bidirectional: a row depends on the keys alone) -> max abs err."""
    import torch
    from repro_torch.kernels.ref import flash_attention_ref

    q, k, v, kw, out = tap.first
    err = 0.0
    for i in range(0, q.shape[1], AUDIO_CHUNK):
        want = flash_attention_ref(q[:, i:i + AUDIO_CHUNK], k, v, **kw)
        ok, e = flash_close(out[:, i:i + AUDIO_CHUNK], want)
        err = max(err, e)
        if not ok:
            raise AssertionError(f"{AUDIO_ARCH} layer-0 flash_attention rows {i}..: max abs err "
                                 f"{e:.3e} beyond {tol_text(q.dtype)}")
        del want
    torch.cuda.empty_cache()
    record["flash_attention"]["max_abs_err"] = max(record["flash_attention"]["max_abs_err"], err)
    print(f"capture {AUDIO_ARCH}: the encoder's layer-0 flash_attention (B={q.shape[0]}, "
          f"S={q.shape[1]}, {kw}) against the plain version on its inputs, in chunks of "
          f"{AUDIO_CHUNK} query rows: max abs err {err:.3e} ({tol_text(q.dtype)})", flush=True)
    return err


def encoder_bound(cfg, B: int, S: int) -> dict:
    """Operations one forward of the encoder over B x S frames needs, and
    their time at the bf16 tensor-core rate: attention (every query sees
    every key, 2 D + 2 D a pair and head), the linears (q, k, v, o and the
    gated MLP's three, 2 a multiply-add) and the head."""
    D, H, d = cfg.resolved_head_dim, cfg.num_heads, cfg.d_model
    attn = cfg.num_layers * attention_work(B, S, S, H, cfg.num_kv_heads, D, 2, causal=False)[1]
    per_token = 2 * (d * H * D * 2 + d * cfg.num_kv_heads * D * 2 + 3 * d * cfg.d_ff)
    linears = cfg.num_layers * per_token * B * S + 2 * d * cfg.vocab_size * B * S
    return {"attention_ms": attn / BF16_OPS_PER_S * 1e3,
            "linears_ms": linears / BF16_OPS_PER_S * 1e3,
            "ms": (attn + linears) / BF16_OPS_PER_S * 1e3}


def audio_phase(dev, record) -> dict:
    """Phase 11: the bidirectional flash_attention at hubert's D = 80, H =
    KV = 16, then full-width hubert-xlarge encodes AUDIO_BATCH x AUDIO_LEN
    frames (a warm forward, then one with the counts zeroed: 48
    bidirectional launches on the tensor-core body), a repeat bit for bit,
    the serve's layer-0 launch against the plain version, a profiled
    forward; then reduced hubert card against CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import body_launches, flash_attention_cuda
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(AUDIO_ARCH)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, S, n = AUDIO_BATCH, AUDIO_LEN, AUDIO_CHECK_LEN
    print(f"{AUDIO_ARCH}: frames [{B}, {S}, {cfg.d_model}], the reference's prefill_32k length "
          "with its batch cut from 32 to 2 for time", flush=True)

    # -- 11a. the bidirectional kernel ------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 7)
    times = {"attention_check": check_flash_attention(
        f"hubert B={B} S={n} H=KV={H} D={D} bidirectional bf16", (B, n, H, KV, D), bf16, dev,
        gen, record, timed=True, body="wgmma", causal=False, control=False)}
    check_flash_attention(f"hubert B={B} S={n} D={D} bidirectional f32", (B, n, H, KV, D), f32,
                          dev, gen, record, body="simt", causal=False)
    check_flash_attention(f"hubert odd B=3 S=777 D={D} bidirectional bf16", (3, 777, H, KV, D),
                          bf16, dev, gen, record, body="wgmma", causal=False)
    q, k, v = (seeded_normal((B, S, H, D), bf16, dev, gen) for _ in range(3))
    nbytes, nops = attention_work(B, S, S, H, KV, D, 2, causal=False)
    b, by = flash_bound_ms(nbytes, nops, bf16)
    main = {"ms": time_ms(lambda: flash_attention_cuda(q, k, v, causal=False), reps=5,
                          warmup=1),
            "plain_ms": None, "bound_ms": b, "bound_by": by,
            "library_ms": time_ms(lambda: sdpa_prefill(q, k, v, False), reps=5, warmup=1)}
    del q, k, v
    times["attention_main"] = main
    for key, length in (("attention_check", n), ("attention_main", S)):
        times[key]["shape"] = f"B={B} S={length} H=KV={H} D={D} bidirectional bf16"
    print(f"flash_attention hubert B={B} S={S} H=KV={H} D={D} bidirectional bf16 | kernel "
          f"{main['ms']:.4f} ms, SDPA {main['library_ms']:.4f} ms "
          f"({main['ms'] / main['library_ms']:.3f}x SDPA's time), bound {b:.4f} ms ({by}), "
          f"{nops / main['ms'] / 1e9:.1f} TFLOP/s of {nops / 1e9:.1f} GFLOP; plain not measured "
          f"(its f32 logits would take {B * H * S * S * 4 / 1e9:.0f} GB)", flush=True)

    # -- 11b. the counted forward, 11c. its checks -------------------------------------
    t = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
        SERVE_SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{AUDIO_ARCH}: {n_params / 1e9:.4f} B parameters, {param_bytes / 1e9:.4f} GB (bf16), "
          f"built in {time.perf_counter() - t:.3f} s", flush=True)
    batch = {"frames": seeded_normal((B, S, cfg.d_model), f32, dev,
                                     torch.Generator(device=dev).manual_seed(SERVE_SEED + 8))}
    t = time.perf_counter()
    model.prefill(batch)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    tap = AttentionTap()
    tap.install()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    logits, cache = model.prefill(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches, bodies = dict(ops.launch_counts), dict(body_launches)
    tap.remove()
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    if launches["flash_attention"] != L or bodies != {"simt": 0, "wgmma": L}:
        raise AssertionError(f"{AUDIO_ARCH} forward launched {launches} (bodies {bodies})")
    if tap.causal != [False] * L or cache is not None:
        raise AssertionError(f"{AUDIO_ARCH} attention causal flags {set(tap.causal)}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) or logits.dtype != f32:
        raise AssertionError(f"{AUDIO_ARCH} logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{AUDIO_ARCH}: non-finite logits")
    bound = encoder_bound(cfg, B, S)
    print(f"encode {AUDIO_ARCH}: B={B} S={S}, warm forward {warm_s:.4f} s, counted forward "
          f"{wall:.4f} s against an operations bound of {bound['ms'] / 1e3:.4f} s (attention "
          f"{bound['attention_ms'] / 1e3:.4f} s + linears and head "
          f"{bound['linears_ms'] / 1e3:.4f} s at {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s) = "
          f"{bound['ms'] / 1e3 / wall:.3f} of it; launches flash_attention "
          f"{launches['flash_attention']} (bodies {bodies}, causal {set(tap.causal)}); peak "
          f"memory {peak / 2**30:.3f} GiB; max |logit| {float(logits.abs().max()):.4f}",
          flush=True)
    capture_err = check_captured_attention(tap, record)
    tap.first = None
    again, _ = model.prefill(batch)
    same = torch.equal(again, logits)
    del again
    print(f"repeat encode {AUDIO_ARCH}: logits bit-identical {same}", flush=True)
    if not same:
        raise AssertionError(f"a second {AUDIO_ARCH} forward gave other logits")
    del logits
    prof = device_profile(lambda: model.prefill(batch))
    idle = None if prof["busy_s"] is None else 1.0 - prof["busy_s"] / prof["span_s"]
    print(solve_profile_line(f"profile {AUDIO_ARCH}: one forward of B={B} S={S}", prof),
          flush=True)
    del model, batch
    torch.cuda.empty_cache()

    # -- 11d. reduced card against CPU ---------------------------------------------------
    small = reduced_card_vs_cpu(AUDIO_ARCH, dev)
    print(f"phase 11 ({AUDIO_ARCH}): {time.perf_counter() - t0:.1f} s", flush=True)
    return {"times": times, "launches": {"flash_attention": launches["flash_attention"],
                                         "flash_decode": 0},
            "wall_s": wall, "bound": bound, "idle": idle, "peak_gib": peak / 2**30,
            "capture_err": capture_err, "small": small}


def xlstm_work(kind: str, B: int, S: int, H: int, Dh: int, state_bytes: int,
               r_bytes: int = 0) -> tuple[float, float]:
    """(bytes, operations) of one scan.  Bytes: the inputs read once (q, k,
    v and the two gates, or w_in and the recurrent matrices), h written
    once, the state read and written.  Operations (f32), the least the
    recurrence needs: per step and head, the mLSTM's 5 a C element (f C,
    then a multiply-add of (i v_i) k_s_j; C q's multiply-add), MLSTM_ROW_OPS
    a row and MLSTM_STEP_OPS; the sLSTM's 8 Dh^2 (four mat-vecs) and
    SLSTM_ELEMENT_OPS an element.  The kernel spends a sixth operation an
    element of C, v_i k_s_j times i apart, to round as the plain version
    does; that is its choice, not work of the function."""
    if kind == "mlstm_scan":
        nbytes = 4 * B * S * H * (4 * Dh + 2) + 2 * state_bytes
        nops = B * H * S * (5 * Dh * Dh + MLSTM_ROW_OPS * Dh + MLSTM_STEP_OPS)
    else:
        nbytes = 4 * B * S * H * 5 * Dh + r_bytes + 2 * state_bytes
        nops = B * H * S * (8 * Dh * Dh + SLSTM_ELEMENT_OPS * Dh)
    return float(nbytes), float(nops)


def xlstm_case_args(kind: str, B: int, S: int, H: int, Dh: int, dev, *, state_dtype,
                    r_dtype=None, seed: int = 0):
    """The shared seeded inputs of ``kind``'s scan (a nonzero state)."""
    from repro_torch.kernels.xlstm import mlstm_case, slstm_case

    if kind == "mlstm_scan":
        return mlstm_case(B, S, H, Dh, state_dtype=state_dtype, seed=seed, device=dev)
    return slstm_case(B, S, H, Dh, state_dtype=state_dtype, r_dtype=r_dtype, seed=seed,
                      device=dev)


def xlstm_compare(kind: str, h, state, want_h, want_state, kappa) -> dict:
    """kernels.xlstm.compare_scan with the state leaves named for ``kind``."""
    from repro_torch.kernels.xlstm import compare_scan

    return compare_scan("Cnm" if kind == "mlstm_scan" else "cnhm", h, state, want_h, want_state,
                        kappa)


def check_xlstm(kind: str, B: int, S: int, H: int, Dh: int, dev, record, *, state_dtype,
                r_dtype=None, seed: int = 0) -> dict:
    """One scan kernel launch against its plain version on the same seeded
    inputs (a nonzero state in ``state_dtype``), both on the card; the
    launch goes through the CUDA wrapper, outside the counts."""
    import torch
    from repro_torch.kernels.ref import mlstm_scan_ref, slstm_scan_ref
    from repro_torch.kernels.xlstm import mlstm_condition, mlstm_scan_cuda, slstm_scan_cuda

    args = xlstm_case_args(kind, B, S, H, Dh, dev, state_dtype=state_dtype, r_dtype=r_dtype,
                           seed=seed)
    plain = [a.clone() for a in args]
    mlstm = kind == "mlstm_scan"
    kappa = mlstm_condition(*args) if mlstm else None
    h, state = (mlstm_scan_cuda if mlstm else slstm_scan_cuda)(*args)
    want_h, want_state = (mlstm_scan_ref if mlstm else slstm_scan_ref)(*plain)
    torch.cuda.synchronize()
    res = xlstm_compare(kind, h, state, want_h, want_state, kappa)
    record[kind]["max_abs_err"] = max(record[kind]["max_abs_err"], res["max_abs_err"])
    rdt = "" if mlstm else f", R {str(args[1].dtype)[6:]}"
    print(f"{kind} B={B} S={S} H={H} Dh={Dh} (state {str(state_dtype)[6:]}{rdt}, gates up to "
          f"|20|) vs plain: h max abs err {res['max_abs_err']:.3e} of scale {res['scale']:.4g}, "
          f"{res['share']:.3f} of the allowed error"
          + (f" (max kappa {res['kappa_max']:.4g})" if mlstm else "")
          + f"; state {res['state']}", flush=True)
    if not res["ok"]:
        raise AssertionError(f"{kind} at B={B} S={S} H={H} Dh={Dh} parts from its plain version")
    return res


def time_xlstm(kind: str, B: int, H: int, Dh: int, dev, *, clock_mhz: float) -> dict:
    """The kernel at XLSTM_LONG's length and at XLSTM_PLAIN_STEPS (a bf16
    state and bf16 recurrent matrices, the long-context path's dtypes),
    beside its bound and the plain version at XLSTM_PLAIN_STEPS; the sLSTM
    also beside its chain floor per (batch, head)."""
    import torch
    from repro_torch.kernels.ref import mlstm_scan_ref, slstm_scan_ref
    from repro_torch.kernels.xlstm import mlstm_scan_cuda, slstm_scan_cuda

    bf16 = torch.bfloat16
    cuda = mlstm_scan_cuda if kind == "mlstm_scan" else slstm_scan_cuda
    plain = mlstm_scan_ref if kind == "mlstm_scan" else slstm_scan_ref
    S = XLSTM_LONG[1]
    out = {}
    for steps, key in ((S, "ms"), (XLSTM_PLAIN_STEPS, "ms_at_plain_steps")):
        args = xlstm_case_args(kind, B, steps, H, Dh, dev, state_dtype=bf16, r_dtype=bf16,
                               seed=steps)
        out[key] = time_ms(lambda: cuda(*args), reps=3, warmup=1)
        if steps == XLSTM_PLAIN_STEPS:
            out["plain_ms"] = time_ms(lambda: plain(*args), reps=2, warmup=1)
        state_bytes = sum(t.numel() * t.element_size() for t in args[-3 if kind == "mlstm_scan"
                                                                     else -4:])
        r_bytes = 0 if kind == "mlstm_scan" else sum(r.numel() * r.element_size()
                                                     for r in args[1:5])
        del args
        torch.cuda.empty_cache()
        if steps == S:
            nbytes, nops = xlstm_work(kind, B, S, H, Dh, state_bytes, r_bytes)
            out["bound_ms"], out["bound_by"] = bound_ms(nbytes, nops)
            out["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
            out["ops_ms"] = nops / F32_OPS_PER_S * 1e3
    out["shape"] = (f"B={B} S={S} H={H} Dh={Dh}, bf16 state" + ("" if kind == "mlstm_scan"
                                                                else " and R"))
    out["plain_shape"] = f"S={XLSTM_PLAIN_STEPS}"
    chain = ""
    if kind == "slstm_scan":
        cycles = FMA_LATENCY_CYCLES * (math.ceil(math.log2(Dh)) + 1)
        out["chain_floor_ms"] = S * cycles / (clock_mhz * 1e6) * 1e3
        chain = (f", chain floor {out['chain_floor_ms']:.4f} ms ({cycles} cycles a step at "
                 f"{clock_mhz:.0f} MHz)")
    print(f"{kind} {out['shape']} | kernel {out['ms']:.4f} ms ({out['ms'] / S * 1e3:.4f} us a "
          f"step), bound {out['bound_ms']:.4f} ms ({out['bound_by']}; bytes {out['bytes_ms']:.4f} "
          f"ms, f32 operations {out['ops_ms']:.4f} ms){chain}; at S={XLSTM_PLAIN_STEPS} kernel "
          f"{out['ms_at_plain_steps']:.4f} ms, plain {out['plain_ms']:.4f} ms "
          f"({out['plain_ms'] / out['ms_at_plain_steps']:.1f}x); no one PyTorch call computes "
          "the recurrence (library: none)", flush=True)
    return out


class ScanTap:
    """Wraps ``ops.mlstm_scan`` while a model runs (``install`` /
    ``remove``): keeps the first call's inputs (by reference; the state it
    updates in place cloned before the launch) and its output h."""

    def __init__(self):
        self.first = None

    def install(self) -> None:
        from repro_torch.kernels import ops

        self._orig = ops.mlstm_scan
        orig = self._orig

        def tapped(q, k, v, i_raw, f_raw, C, n, m):
            state = (C.clone(), n.clone(), m.clone()) if self.first is None else None
            out = orig(q, k, v, i_raw, f_raw, C, n, m)
            if self.first is None:
                self.first = ((q, k, v, i_raw, f_raw) + state, out[0],
                              tuple(t.clone() for t in out[1]))
            return out

        ops.mlstm_scan = tapped

    def remove(self) -> None:
        from repro_torch.kernels import ops

        ops.mlstm_scan = self._orig


def xlstm_prefill_bound(cfg, B: int, S: int) -> float:
    """ms of the linears of a B x S prefill at the bf16 tensor-core rate (2
    operations a multiply-add; the last position's logits only)."""
    from repro_torch.models.xlstm import slstm_layers

    d, H = cfg.d_model, cfg.num_heads
    di = 2 * d
    d_ff = int(d * 4 / 3)
    n_s = sum(slstm_layers(cfg))
    mlstm = 2 * (2 * d * di + 3 * di * di + di * 2 * H + di * d)
    slstm = 2 * (4 * d * d + 3 * d * d_ff)
    ops = ((cfg.num_layers - n_s) * mlstm + n_s * slstm) * B * S + 2 * d * cfg.vocab_size * B
    return ops / BF16_OPS_PER_S * 1e3


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for layer in cache["layers"] for t in layer.values())


def xlstm_cache_bytes(cfg, B: int) -> int:
    """Bytes of an xLSTM cache of B slots in bf16, whatever its length:
    per mLSTM layer C, n, m and the conv's 3 rows, per sLSTM layer c, n, h,
    m."""
    from repro_torch.models.xlstm import slstm_layers

    d, H = cfg.d_model, cfg.num_heads
    di = 2 * d
    Dm, Ds = di // H, d // H
    n_s = sum(slstm_layers(cfg))
    mlstm = B * H * Dm * Dm + B * H * Dm + B * H + B * 3 * di
    return 2 * ((cfg.num_layers - n_s) * mlstm + n_s * 4 * B * H * Ds)


def xlstm_long_context(cfg, dev, record, times) -> dict:
    """XLSTM_LONG[0] sequences of XLSTM_LONG[1] tokens: one prefill and
    XLSTM_LONG_STEPS decode steps with the counts zeroed just before, the
    prefill's layer-0 mlstm_scan launch held to the plain version over all
    its steps, the first decode step against a prefill one token longer
    (and two planted faults read the same way)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mlstm_scan_ref
    from repro_torch.kernels.xlstm import mlstm_condition
    from repro_torch.models import build_model

    B, S = XLSTM_LONG
    steps = XLSTM_LONG_STEPS
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
        SERVE_SEED))
    n_s = sum(model.is_slstm)
    n_m = cfg.num_layers - n_s
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 12)
    toks = torch.randint(0, cfg.vocab_size, (B, S + steps), generator=gen, device=dev,
                         dtype=torch.int32)
    cache = model.init_cache(B, S + steps)
    short = model.init_cache(SERVE_SLOTS, SERVE_MAX_SEQ)
    long_bytes, short_bytes = cache_bytes(cache), cache_bytes(short)
    del short
    tap = ScanTap()
    tap.install()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    logits, cache = model.prefill({"tokens": toks[:, :S]}, cache)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    tap.remove()
    first = None
    t = time.perf_counter()
    for i in range(steps):
        out, cache = model.decode_step(toks[:, S + i:S + i + 1], cache)
        if first is None:
            first = out[:, 0].float()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t) / steps * 1e3
    launches = dict(ops.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    want = {"mlstm_scan": n_m * (1 + steps), "slstm_scan": n_s * (1 + steps),
            "flash_attention": 0, "flash_decode": 0}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"{XLSTM_ARCH} long context launched {launches}, expected {want}")
    if int(cache["pos"]) != S + steps or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{XLSTM_ARCH} long context: pos {int(cache['pos'])}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    if not long_bytes == short_bytes == xlstm_cache_bytes(cfg, B):
        raise AssertionError(f"the {XLSTM_ARCH} cache takes {long_bytes} bytes at {S} tokens, "
                             f"{short_bytes} at {SERVE_MAX_SEQ}")
    linears = xlstm_prefill_bound(cfg, B, S)
    scans = n_m * times["mlstm_scan"]["bound_ms"] + n_s * times["slstm_scan"]["bound_ms"]
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    step_bound = (param_bytes + 2 * long_bytes) / HBM_BYTES_PER_S * 1e3
    print(f"long context {XLSTM_ARCH}: B={B} S={S} (the reference's prefill_32k length, its "
          f"batch cut from 32 to {B} for time): prefill {prefill_s:.4f} s against a bound of "
          f"{(linears + scans) / 1e3:.4f} s (linears {linears / 1e3:.4f} s at "
          f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s + the scans' bounds {scans / 1e3:.4f} s), then "
          f"{steps} decode steps at {decode_ms:.4f} ms a step (bytes bound {step_bound:.4f} ms: "
          f"weights + the cache read and written); launches {want}; peak memory "
          f"{peak / 2**30:.3f} GiB; the cache {long_bytes} bytes at {S + steps} positions = "
          f"{short_bytes} at {SERVE_MAX_SEQ}", flush=True)

    # the prefill's own layer-0 launch against the plain version
    (args, h, state) = tap.first
    tap.first = None
    kappa = mlstm_condition(*args)
    want_h, want_state = mlstm_scan_ref(*[a.clone() for a in args])
    torch.cuda.synchronize()
    res = xlstm_compare("mlstm_scan", h, state, want_h, want_state, kappa)
    del args, h, want_h, kappa
    torch.cuda.empty_cache()
    record["mlstm_scan"]["max_abs_err"] = max(record["mlstm_scan"]["max_abs_err"],
                                              res["max_abs_err"])
    print(f"capture {XLSTM_ARCH}: the prefill's layer-0 mlstm_scan (B={B}, S={S}, H="
          f"{cfg.num_heads}, Dh={2 * cfg.d_model // cfg.num_heads}, bf16 state) against the plain "
          f"version on its inputs over all {S} steps: h max abs err {res['max_abs_err']:.3e} of "
          f"scale {res['scale']:.4g}, {res['share']:.3f} of the allowed error (max kappa "
          f"{res['kappa_max']:.4g}); state {res['state']}", flush=True)
    if not res["ok"]:
        raise AssertionError(f"{XLSTM_ARCH}: the prefill's layer-0 mlstm_scan parts from the "
                             "plain version")

    # one decode step against a prefill one token longer
    full, _ = model.prefill({"tokens": toks[:, :S + 1]}, model.init_cache(B, S + 1))
    full = full[:, 0].float()
    err, scale = float((first - full).abs().max()), float(full.abs().max())
    agree = int((first.argmax(-1) == full.argmax(-1)).sum())
    print(f"long-context check {XLSTM_ARCH}: the first decode step after {S} tokens vs a "
          f"prefill of {S + 1}: max abs err {err:.4f} of max |logit| {scale:.4f} "
          f"({err / scale:.4f} of it, tol {XLSTM_LONG_TOL:g}: the bf16 cache's rounding of the "
          f"state and the two conv paths' roundings), argmax agree {agree}/{B}", flush=True)
    if not (math.isfinite(err) and err <= XLSTM_LONG_TOL * scale):
        raise AssertionError(f"{XLSTM_ARCH}: decode after the long prefill parts from the "
                             "longer prefill")

    # two planted faults read the same way: what the check reads where the
    # state is wrong, so that its limit is seen to sit between the two
    nxt = toks[:, S:S + 1]
    dropped = model.init_cache(B, S + 1)            # the state not carried at all
    dropped["pos"].fill_(S)
    out, _ = model.decode_step(nxt, dropped)
    faults = {"state not carried": out[:, 0].float()}
    _, stale = model.prefill({"tokens": toks[:, :S - 1]}, model.init_cache(B, S + 1))
    out, _ = model.decode_step(nxt, stale)          # the state one token stale
    faults["state one token stale"] = out[:, 0].float()
    faults = {name: float((got - full).abs().max()) / scale for name, got in faults.items()}
    del dropped, stale, out
    print(f"long-context check {XLSTM_ARCH}, planted faults: " + ", ".join(
        f"{name} {rel:.4f} of max |logit|" for name, rel in faults.items())
        + f" (the check's limit {XLSTM_LONG_TOL:g}, its reading {err / scale:.4f})", flush=True)
    if not min(faults.values()) > XLSTM_LONG_TOL:
        raise AssertionError(f"{XLSTM_ARCH}: the long-context check's limit does not tell a "
                             f"planted fault: {faults}")
    del model, cache, toks, full, first, logits
    torch.cuda.empty_cache()

    # the same check with the whole model in f32
    t = time.perf_counter()
    B32 = XLSTM_LONG_F32_BATCH
    model = build_model(dataclasses.replace(cfg, param_dtype="float32"), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SERVE_SEED))
    toks = torch.randint(0, cfg.vocab_size, (B32, S + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    _, cache = model.prefill({"tokens": toks[:, :S]}, model.init_cache(B32, S + 1))
    dec, cache = model.decode_step(toks[:, S:], cache)
    full, _ = model.prefill({"tokens": toks}, model.init_cache(B32, S + 1))
    dec, full = dec[:, 0].float(), full[:, 0].float()
    err32, scale32 = float((dec - full).abs().max()), float(full.abs().max())
    print(f"long-context check {XLSTM_ARCH} in f32 (B={B32}, {time.perf_counter() - t:.1f} s): "
          f"the first decode step after {S} tokens vs a prefill of {S + 1}: max abs err "
          f"{err32:.6g} of max |logit| {scale32:.6g} ({err32 / scale32:.3e} of it, limit "
          f"{TEACHER_F32_TOL:g})", flush=True)
    if not (math.isfinite(err32) and err32 <= TEACHER_F32_TOL * scale32):
        raise AssertionError(f"{XLSTM_ARCH} in f32: decode after the long prefill parts from "
                             "the longer prefill beyond what f32 roundings explain")
    del model, cache, toks, dec, full
    torch.cuda.empty_cache()
    return {"launches": launches, "prefill_s": prefill_s, "bound_ms": linears + scans,
            "decode_ms": decode_ms, "step_bound_ms": step_bound, "peak_gib": peak / 2**30,
            "capture": res, "check": err / scale, "check_f32": err32 / scale32,
            "faults": faults}


def xlstm_phase(dev, record, *, clock_mhz: float) -> dict:
    """Phase 12: both scan kernels against their plain versions at
    xlstm-125m's widths and the reduced ones, timed at the long context's
    length; then full-width xlstm-125m serves the 16 requests of phase 4;
    then the long context; then reduced xlstm card against CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.xlstm import slstm_layers

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_config(XLSTM_ARCH)
    H = cfg.num_heads
    dims = {"mlstm_scan": 2 * cfg.d_model // H, "slstm_scan": cfg.d_model // H}
    small = {"mlstm_scan": 32, "slstm_scan": 16}          # the reduced config's head dims
    print(f"{XLSTM_ARCH}: {cfg.num_layers} layers (sLSTM every {cfg.slstm_every}), d_model "
          f"{cfg.d_model}, H={H}: mLSTM Dh={dims['mlstm_scan']}, sLSTM Dh={dims['slstm_scan']}",
          flush=True)

    # -- 12a. the scans against their plain versions, timed -------------------------
    for kind, Dh in dims.items():
        for S in XLSTM_CHECK_STEPS:
            check_xlstm(kind, SERVE_SLOTS, S, H, Dh, dev, record,
                        state_dtype=bf16 if S < 256 else f32, r_dtype=bf16, seed=S)
        check_xlstm(kind, 2, XLSTM_SMALL_STEPS, H, small[kind], dev, record, state_dtype=f32,
                    seed=7)
    times = {kind: time_xlstm(kind, SERVE_SLOTS, H, Dh, dev, clock_mhz=clock_mhz)
             for kind, Dh in dims.items()}

    # -- 12b. the serve ------------------------------------------------------------
    n_s = sum(slstm_layers(cfg))
    n_m = cfg.num_layers - n_s
    serve = serve_slice(cfg, dev, lambda waves, steps: {
        "mlstm_scan": n_m * (waves + steps), "slstm_scan": n_s * (waves + steps),
        "flash_attention": 0, "flash_decode": 0}, XLSTM_DECODE_PHASES)
    probe = xlstm_cache_bytes(cfg, SERVE_SLOTS)
    step_bound = (serve["param_bytes"] + 2 * probe) / HBM_BYTES_PER_S * 1e3
    for i, w in enumerate(serve["waves"]):
        print(f"serve {XLSTM_ARCH} wave {i + 1}: decode {w['decode_ms_per_step']:.4f} ms a step "
              f"against a bytes bound of {step_bound:.4f} ms (weights {serve['param_bytes']} B + "
              f"the cache read and written, 2 x {probe} B) = "
              f"{step_bound / w['decode_ms_per_step']:.3f} of it", flush=True)

    # -- 12c. the long context -------------------------------------------------------
    long = xlstm_long_context(cfg, dev, record, times)

    # -- 12d. reduced card against CPU -----------------------------------------------
    reduced = reduced_card_vs_cpu(XLSTM_ARCH, dev)
    print(f"phase 12 ({XLSTM_ARCH}): {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {kind: serve["launches"][kind] + long["launches"][kind] for kind in dims}
    by_path = {kind: {f"{XLSTM_ARCH} serve": serve["launches"][kind],
                      f"{XLSTM_ARCH} long context": long["launches"][kind]} for kind in dims}
    return {"times": times, "launches": launches, "by_path": by_path, "long": long,
            "serve_waves": serve["waves"], "step_bound_ms": step_bound, "small": reduced}


def optimal_phase(cluster, pp, obj0: float, record, dev, *, clock_mhz) -> dict:
    """Phase 3f.  (a) The rounding kernel bit for bit against its plain
    version: on the main path's own P (the port's ``_optimize`` on the card,
    256 steps at the padded N, timed a step) and on synthetic inputs
    (``kernels.optimal_round.round_case``: every kind at the main path's
    shape, then the other shapes of ``ROUND_SHAPES``; ``round_edge_cases``),
    the main path's and every kind at its shape timed beside the bound and
    the chain floor.  (b) The N=100k optimal balance,
    manual_cnst and no_cnst, each with the counts zeroed just before and read
    just after and once more for its digest.  (c) The N=300 optimal balance
    on the card against the CPU's plain path, and a profiled optimal solve."""
    import numpy as np
    import torch
    from repro_torch.core import (CoopConfig, OptimalSearchConfig, Sptlb, generate_cluster,
                                  solve_optimal)
    from repro_torch.core.problem import tier_loads
    from repro_torch.core.solver_optimal import _optimize, _round, round_inputs, start_noise
    from repro_torch.kernels import ops
    from repro_torch.kernels.optimal_round import (ROUND_KINDS, body_launches, round_case,
                                                   round_edge_cases)

    cfg = OptimalSearchConfig(steps=OPTIMAL_STEPS, seed=0)
    adam = dict(lr=cfg.lr, penalty=cfg.penalty, entropy=cfg.entropy)
    noise = start_noise(pp, cfg.seed)
    first = _optimize(pp, noise, steps=cfg.steps, **adam)      # warms the card's kernels
    torch.cuda.synchronize()
    t = time.perf_counter()
    probs = _optimize(pp, noise, steps=cfg.steps, **adam)
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t
    if not (torch.equal(first, probs) and bool(torch.isfinite(probs).all())):
        raise AssertionError("_optimize on the card is not finite or not reproducible")
    movers = int((probs.argmax(dim=1) != pp.assignment0.long()).sum())
    print(f"optimal _optimize N={pp.num_apps}: {cfg.steps} Adam steps in {opt_s:.4f} s "
          f"({opt_s / cfg.steps * 1e3:.4f} ms a step), argmax != home for {movers} apps, "
          f"movement budget {int(pp.move_budget)}", flush=True)
    main = check_round(f"main path N={pp.num_apps}", round_inputs(pp, probs), record,
                       clock_mhz=clock_mhz, timed=True)
    main["whole_call_ms"] = time_ms(lambda: _round(pp, probs))
    # What the whole call runs in torch before the kernel, part by part.
    p_target = torch.max(probs, dim=1)[0]
    gain = p_target - torch.gather(probs, 1, pp.assignment0.long()[:, None])[:, 0]
    prep = {"argmax and gain": lambda: torch.max(probs, dim=1)[0] - torch.gather(
                probs, 1, pp.assignment0.long()[:, None])[:, 0],
            "stable sort": lambda: torch.sort(-gain, stable=True),
            "start loads": lambda: tier_loads(pp, pp.assignment0),
            "feasibility mask": lambda: pp.feasible_mask(),
            "all of round_inputs": lambda: round_inputs(pp, probs)}
    main["prep_ms"] = {name: time_ms(fn) for name, fn in prep.items()}
    print(f"  _round whole call (argmax, gain, stable sort, start loads, copies, kernel): "
          f"{main['whole_call_ms']:.4f} ms; before the kernel: " + ", ".join(
              f"{name} {ms:.4f} ms" for name, ms in main["prep_ms"].items()), flush=True)
    main["kinds"] = {}
    for N, T, R in ROUND_SHAPES:
        for kind in ROUND_KINDS:
            # every kind at the main path's shape is timed, beside its floor
            timed = (N, T, R) == ROUND_SHAPES[0]
            got = check_round(f"{kind} N={N},T={T},R={R}",
                              round_case(N, T, R, kind, seed=N + T + R, device=dev), record,
                              clock_mhz=clock_mhz, timed=timed, plain=False)
            if timed:
                main["kinds"][kind] = {k: got[k] for k in (
                    "ms", "stage_ms", "walk_ms", "chain_floor_ms", "cycles_a_mover", "walked",
                    "accepted")}
            if T > 1 and kind == "budget" and not got["walked"] < got["movers"]:
                raise AssertionError(f"{kind} N={N}: the budget did not bind")
            if T > 1 and kind in ("capacity", "overfull") and got["accepted"] == got["walked"]:
                raise AssertionError(f"{kind} N={N}: capacity did not bind")
            if T > 1 and kind == "ties" and got["accepted"] == 0:
                raise AssertionError(f"{kind} N={N}: no move accepted")

    for name, (args, want) in round_edge_cases(device=dev).items():
        got = check_round(f"edge {name}", args, record, clock_mhz=clock_mhz)
        if (got["accepted"], got["walked"]) != want:
            raise AssertionError(f"optimal_round edge {name}: status {got} != {want}")

    runs = {}
    for variant in ("manual_cnst", "no_cnst"):
        coop = CoopConfig() if variant == "manual_cnst" else CoopConfig(variant="no_cnst")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        d = Sptlb(cluster, device=dev).balance("optimal", timeout_s=30, config=coop)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dict(ops.launch_counts)
        bodies = dict(body_launches)
        tm = d.cooperation.timings
        digest = assignment_digest(d.assignment)
        rep = Sptlb(cluster, device=dev).balance("optimal", timeout_s=30, config=coop)
        same = (assignment_digest(rep.assignment) == digest
                and rep.solve.objective == d.solve.objective)
        obj = d.solve.objective
        print(f"optimal slice {variant} N={cluster.problem.num_apps}: objective {obj0:.6f} -> "
              f"{obj:.6f}, violations ok {d.violations.ok}, rounds {tm['rounds']}, refine sweeps "
              f"{d.solve.extra['refine']['sweeps']}, moved {d.violations.num_moved}/"
              f"{d.violations.move_budget}, solve_s {tm['solve_s']:.4f}, pack_s "
              f"{tm.get('pack_s', 0.0):.4f}, balance wall {wall:.4f} s, digest {digest}, repeat "
              f"the same {same}, launches {launches}, optimal_round bodies {bodies}",
              flush=True)
        if not d.violations.ok:
            raise AssertionError(f"optimal {variant}: violations {d.violations}")
        if not (np.isfinite(obj) and obj <= obj0):
            raise AssertionError(f"optimal {variant}: objective {obj} is not <= the start {obj0}")
        if launches["optimal_round"] < tm["rounds"]:
            raise AssertionError(f"optimal {variant}: optimal_round launched "
                                 f"{launches['optimal_round']} times in {tm['rounds']} rounds")
        need = ("move_eval_best", "commit_topk") + (
            ("pack_ffd_tiers",) if variant == "manual_cnst" else ())
        for name in need:
            if launches[name] <= 0:
                raise AssertionError(f"optimal {variant}: launched {name} no time")
        if not same:
            raise AssertionError(f"optimal {variant}: a repeat pass gave another mapping")
        if sum(bodies.values()) != launches["optimal_round"]:
            raise AssertionError(f"optimal {variant}: bodies {bodies} for "
                                 f"{launches['optimal_round']} launches")
        runs[variant] = {"wall_s": wall, "launches": launches, "rounds": tm["rounds"],
                         "bodies": bodies}

    # (c) agreement with the plain path on a small input, as phase 3e.
    small = generate_cluster(num_apps=300, seed=3, device="cpu")
    coop = CoopConfig(max_rounds=8, timeout_s=1e9)
    d_cpu = Sptlb(small, device="cpu").balance("optimal", timeout_s=4, config=coop)
    d_gpu = Sptlb(small, device=dev).balance("optimal", timeout_s=4, config=coop)
    agree = float((d_gpu.assignment.cpu() == d_cpu.assignment).float().mean())
    rel = abs(d_gpu.solve.objective - d_cpu.solve.objective) / abs(d_cpu.solve.objective)
    rounds = (d_gpu.cooperation.timings["rounds"], d_cpu.cooperation.timings["rounds"])
    print(f"optimal small N=300 seed=3: card objective {d_gpu.solve.objective:.6f}, plain path "
          f"{d_cpu.solve.objective:.6f}, rel diff {rel:.3e}, rounds {rounds[0]}/{rounds[1]}, "
          f"assignment agreement {agree:.4f}, violations ok "
          f"{d_gpu.violations.ok}/{d_cpu.violations.ok}", flush=True)
    if not (d_gpu.violations.ok and d_cpu.violations.ok and rel <= 1e-4
            and rounds[0] == rounds[1] and agree >= 0.98):
        raise AssertionError("the card's optimal balance disagrees with the plain path at N=300")

    prof = device_profile(lambda: solve_optimal(pp, cfg, device=dev))
    print(solve_profile_line(f"profile: the main path's optimal solve ({cfg.steps} Adam steps, "
                             f"the rounding, a {max(32, cfg.steps // 4)}-sweep refine) at "
                             f"N={pp.num_apps}", prof), flush=True)
    return {"main": main, "runs": runs, "ms_a_step": opt_s / cfg.steps * 1e3}


def control_tick(tick: int) -> tuple[bool, int]:
    """(overloaded, staleness) of one tick of phase 3g's schedule."""
    return 2 <= tick <= 4, (3 if tick in (9, 10) else 0)


def overload_demand(demand, capacity):
    """The demand scaled so that the offered load (over capacity, max over
    resources, in f64) is ``CONTROL_OVERLOAD`` x the shedder's target."""
    import numpy as np

    offered = demand.astype(np.float64).sum(axis=0) / capacity.astype(np.float64).sum(axis=0)
    return demand * np.float32(CONTROL_OVERLOAD * CONTROL_TARGET / float(offered.max()))


def arrival_rows(tick: int) -> list:
    """The tick's seeded arrival records (the population's distributions);
    the same keys every tick, so that deferred keys back off."""
    import numpy as np

    n = CONTROL_ARRIVALS
    rng = np.random.default_rng(1000 + tick)
    cpu, mem = rng.lognormal(1.2, 0.9, n), rng.lognormal(1.8, 0.9, n)
    tasks = np.maximum(1, rng.poisson(rng.lognormal(1.6, 0.7, n)))
    slo = rng.choice(4, n, p=[0.2, 0.2, 0.45, 0.15])
    crit = rng.beta(2.0, 5.0, n)
    return [dict(demand=np.array([cpu[i], mem[i]]), tasks=float(tasks[i]), slo=int(slo[i]),
                 criticality=float(crit[i]), key=f"arrival_{i}") for i in range(n)]


def control_trajectory(base, device, *, profile_tick=None) -> dict:
    """Phase 3g's schedule through a ``BalanceController`` on ``device``
    (shedding at ``CONTROL_TARGET``, fault tolerance armed, ``timeout_s=30``,
    an ``AdmissionController`` attached), with the launch counters zeroed
    just before tick 0 and read after the last tick.  Per tick: the event's
    fields, the shed plan, the wall-clock split into the shed plan, the
    admissions and the balance's ``solve_s``.  ``profile_tick`` runs that
    tick's step under ``torch.profiler``."""
    import dataclasses

    import torch
    from repro_torch.core import (BalanceController, ControllerConfig, FaultToleranceConfig,
                                  ShedConfig, TickInput)
    from repro_torch.kernels import ops
    from repro_torch.streams import AdmissionController

    cuda = torch.device(device).type == "cuda"
    base = base.to(device)
    p = base.problem
    d_base = p.demand.cpu().numpy()
    d_over = overload_demand(d_base, p.capacity.cpu().numpy())
    ctl = BalanceController(base, ControllerConfig(
        shed=ShedConfig(target_frac=CONTROL_TARGET), fault=FaultToleranceConfig(),
        timeout_s=30), device=device)
    ctl.admission = AdmissionController()
    plan_fn, timing = ctl.shedder.plan, {}

    def timed_plan(*args, **kw):
        t = time.perf_counter()
        out = plan_fn(*args, **kw)
        timing["shed_s"] = time.perf_counter() - t
        timing["plan"] = out
        return out

    ctl.shedder.plan = timed_plan
    ticks, prof = [], None
    if cuda:
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    for tick in range(CONTROL_TICKS):
        over, stale = control_tick(tick)
        cluster = dataclasses.replace(base, problem=dataclasses.replace(
            p, demand=torch.as_tensor(d_over if over else d_base, device=device),
            assignment0=ctl.cluster.problem.assignment0))
        inp = TickInput(cluster=cluster, now=tick, collected_at=tick - stale if stale else None)
        shed0, readmit0 = ctl.shedder.shed_events, ctl.shedder.readmit_events
        t = time.perf_counter()
        if tick == profile_tick:
            box = {}
            prof = device_profile(lambda: box.setdefault("r", ctl.step(inp)))
            r = box["r"]
        else:
            r = ctl.step(inp)
        if cuda:
            torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        t = time.perf_counter()
        for row in arrival_rows(tick):
            ctl.admission.decide(ctl.cluster.problem, mode=ctl.mode.value, now=tick, **row)
        admit_s = time.perf_counter() - t
        d = r.decision
        ticks.append({
            "tick": tick, "triggered": r.triggered, "applied": r.applied, "mode": r.mode,
            "shed_active": r.shed_active, "shed": ctl.shedder.shed_events - shed0,
            "readmitted": ctl.shedder.readmit_events - readmit0, "moved": r.moved,
            "d2b_before": r.d2b_before, "d2b_after": r.d2b_after,
            "valid": None if d is None else bool(d.violations.ok),
            "step_s": step_s, "shed_s": timing.get("shed_s", 0.0), "admit_s": admit_s,
            "solve_s": 0.0 if d is None else d.solve.extra["balance_timings"]["solve_s"],
            "evaluate_s": 0.0 if d is None else d.solve.extra["balance_timings"]["evaluate_s"],
            "rounds": 0 if d is None else d.cooperation.timings["rounds"],
            "reason": r.reason, "plan": timing.pop("plan", None)})
    if cuda:
        torch.cuda.synchronize()
    return {"ticks": ticks, "launches": dict(ops.launch_counts), "ctl": ctl, "profile": prof,
            "digest": assignment_digest(ctl.cluster.problem.assignment0),
            "admission": ctl.admission.audit()}


CONTROL_FIELDS = ("triggered", "applied", "mode", "shed_active", "shed", "readmitted")


def control_phase(dev) -> dict:
    """Phase 3g: the control loop at N=100,000 on the card (the schedule of
    ``control_tick``), its checks, a repeat with tick 2 profiled, and the
    schedule at N=300 on the card against the CPU's plain path."""
    import dataclasses

    import numpy as np
    from repro_torch.core import attach_curves, generate_cluster

    def curved(cluster):
        return dataclasses.replace(cluster, problem=attach_curves(cluster.problem))

    base = curved(generate_cluster(num_apps=100_000, seed=1, device=dev))
    run = control_trajectory(base, dev)
    for r in run["ticks"]:
        print(f"control N={base.problem.num_apps} tick {r['tick']}: triggered {r['triggered']}, "
              f"applied {r['applied']}, mode {r['mode']}, capped {r['shed_active']} (shed "
              f"{r['shed']}, readmitted {r['readmitted']}), moved {r['moved']}, d2b "
              f"{r['d2b_before']:.6f} -> {r['d2b_after']}, valid {r['valid']}, rounds "
              f"{r['rounds']}; wall {r['step_s']:.4f} s step (shed plan {r['shed_s']:.4f} s, "
              f"balance solve_s {r['solve_s']:.4f} s, evaluate_s {r['evaluate_s']:.4f} s) + "
              f"{r['admit_s']:.4f} s for {CONTROL_ARRIVALS} admissions; "
              f"{r['reason'][:90]}", flush=True)
    ticks, launches = run["ticks"], run["launches"]
    print(f"control: launches over the {CONTROL_TICKS} ticks {launches}, admissions "
          f"{run['admission']}, final digest {run['digest']}, audit "
          f"{ {k: v for k, v in run['ctl'].audit().items() if not isinstance(v, (list, dict))} }",
          flush=True)

    # The shed tick: served (f64, from the caps) within the target, nobody
    # protected capped.
    p, shed_cfg = base.problem, run["ctl"].config.shed
    plan = ticks[2]["plan"]
    if not (ticks[2]["shed"] > 0 and ticks[2]["triggered"]):
        raise AssertionError(f"control: tick 2 shed {ticks[2]['shed']} apps, triggered "
                             f"{ticks[2]['triggered']}")
    demand = overload_demand(p.demand.cpu().numpy(), p.capacity.cpu().numpy()).astype(np.float64)
    demand *= p.valid.cpu().numpy()[:, None]
    served = (demand * plan.caps.astype(np.float64)[:, None]).sum(axis=0)
    target = CONTROL_TARGET * p.capacity.cpu().numpy().astype(np.float64).sum(axis=0)
    crit = p.criticality.cpu().numpy()
    print(f"control: tick 2 served {served.tolist()} of target {target.tolist()}, overload "
          f"{plan.overload_frac}, capped {int((plan.caps < 1).sum())}, highest criticality "
          f"capped {float(crit[plan.caps < 1].max()):.4f}", flush=True)
    if np.any(served > target * (1 + 1e-9)):
        raise AssertionError("control: the tick-2 plan serves more than the target")
    if np.any(crit[plan.caps < 1.0] >= shed_cfg.protect_critical):
        raise AssertionError("control: a protected app was capped")
    # Readmission: no cap lifts before tick 7, every cap lifts there.
    if any(ticks[t]["readmitted"] for t in range(2, 7)):
        raise AssertionError("control: a cap lifted during ticks 2-6")
    if not (ticks[7]["readmitted"] == ticks[6]["shed_active"] > 0
            and ticks[7]["shed_active"] == 0):
        raise AssertionError(f"control: tick 7 readmitted {ticks[7]['readmitted']} of "
                             f"{ticks[6]['shed_active']} capped")
    for name in ("move_eval_best", "commit_topk", "pack_ffd_tiers"):
        if launches[name] <= 0:
            raise AssertionError(f"control: the trajectory launched {name} no time")
    if any(r["applied"] and not r["valid"] for r in ticks):
        raise AssertionError("control: an applied decision is not valid")
    if not (all(r["mode"] == "normal" for r in ticks[:9]) and ticks[9]["mode"] != "normal"):
        raise AssertionError(f"control: modes {[r['mode'] for r in ticks]}")

    again = control_trajectory(base, dev, profile_tick=2)
    key = ("moved",) + CONTROL_FIELDS
    same = (again["digest"] == run["digest"]
            and [[r[k] for k in key] for r in again["ticks"]]
            == [[r[k] for k in key] for r in ticks])
    print(f"control repeat: digest {again['digest']}, the same records and digest {same}",
          flush=True)
    if not same:
        raise AssertionError("control: a repeat of the trajectory gave other records")
    print(solve_profile_line("profile: control tick 2 (shed plan, trigger, balance, "
                             f"evaluation) at N={p.num_apps}", again["profile"]), flush=True)

    small = curved(generate_cluster(num_apps=CONTROL_SMALL_N, seed=3, device="cpu"))
    on_card = control_trajectory(small, dev)["ticks"]
    on_cpu = control_trajectory(small, "cpu")["ticks"]
    agree = all(a[k] == b[k] for a, b in zip(on_card, on_cpu) for k in CONTROL_FIELDS)
    print(f"control N={CONTROL_SMALL_N}: card {[[r[k] for k in CONTROL_FIELDS] for r in on_card]}"
          f", plain path agrees {agree}; moved card/cpu "
          f"{[(a['moved'], b['moved']) for a, b in zip(on_card, on_cpu)]}", flush=True)
    if not agree:
        raise AssertionError("control: the card's N=300 trajectory disagrees with the plain path")
    return {"run": run, "again": again}


def batched_sweep_work(args, active) -> tuple[float, float]:
    """(bytes, f32 ops) of one shard-batched sweep: ``sweep_bytes`` and
    ``sweep_ops`` of each active shard, the (score, tier) written for each
    inactive one, and each shard's flag, budget and totals."""
    S, N, R = args[0].shape
    T = args[5].shape[1]
    act = int(active.sum())
    nbytes = act * sweep_bytes(N, T, R, True) + (S - act) * N * 8 + S * (4 + 4 + 8)
    return float(nbytes), act * sweep_ops(N, T, R, True)


def check_batched(label, sharded, record, dev) -> dict:
    """Hold both shard-batched kernels, at the start of ``sharded``'s solve
    with the shards ``FLEET_INACTIVE`` names left inactive, against their
    plain versions and against the unbatched kernels on each shard alone,
    bit for bit; then time each (the sweep as the whole call and the kernel
    alone; the unbatched kernels once a shard for comparison) beside its
    plain version and its bound."""
    import torch
    from repro_torch.core.solver_local import batched_start
    from repro_torch.kernels import move_eval as K
    from repro_torch.kernels.commit import commit_topk_batched_cuda, commit_topk_cuda
    from repro_torch.kernels.ref import commit_topk_batched_ref, move_eval_best_batched_ref

    sp = sharded.problems
    x, util, tasks, feas, budget, totals, wvec = batched_start(sp)
    S, N = x.shape
    T = sp.capacity.shape[1]
    active = torch.tensor([s not in FLEET_INACTIVE[S] for s in range(S)], device=dev)
    live = [s for s in range(S) if bool(active[s])]
    args = (sp.demand, sp.tasks, sp.criticality, x, sp.assignment0, sp.capacity,
            sp.task_limit, sp.ideal_frac, sp.ideal_task_frac, util, tasks, wvec, feas, budget)
    shard_args = [tuple(a[s] for a in args) for s in range(S)]

    # -- the sweep ---------------------------------------------------------------
    inputs = K.best_inputs_batched(*args, totals=totals, active=active)
    s_k, t_k = K.launch_move_eval_best_batched(inputs)
    s_p, t_p = move_eval_best_batched_ref(*args, active=active)
    same_1 = all(torch.equal(s_k[s], o[0]) and torch.equal(t_k[s], o[1]) for s, o in
                 ((s, K.move_eval_best_cuda(*shard_args[s], totals=totals[s])) for s in live))
    torch.cuda.synchronize()
    finite = torch.isfinite(s_p)
    err = float((s_k[finite] - s_p[finite]).abs().max()) if bool(finite.any()) else 0.0
    exact = torch.equal(s_k, s_p) and torch.equal(t_k, t_p)
    if not (exact and same_1):
        raise AssertionError(f"move_eval_best_batched {label}: plain version equal {exact} "
                             f"(max abs err {err:.3e}), unbatched kernel equal {same_1}")
    record["move_eval_best_batched"]["max_abs_err"] = max(
        record["move_eval_best_batched"]["max_abs_err"], err)
    b, by = bound_ms(*batched_sweep_work(args, active))
    sweep = {"ms": time_ms(lambda: K.move_eval_best_batched_cuda(*args, totals=totals,
                                                                 active=active)),
             "kernel_ms": time_ms(lambda: K.launch_move_eval_best_batched(inputs)),
             "unbatched_ms": time_ms(lambda: [K.move_eval_best_cuda(*shard_args[s],
                                                                    totals=totals[s])
                                              for s in live]),
             "plain_ms": time_ms(lambda: move_eval_best_batched_ref(*args, active=active),
                                 reps=5, warmup=1),
             "bound_ms": b, "bound_by": by}
    print(f"move_eval_best_batched {label} ({S} x {N} x {T}, {len(live)} active): bit for bit "
          f"the plain version and the unbatched kernel on each shard; whole call "
          f"{sweep['ms']:.4f} ms, kernel alone {sweep['kernel_ms']:.4f} ms, the unbatched "
          f"kernel once an active shard {sweep['unbatched_ms']:.4f} ms, plain "
          f"{sweep['plain_ms']:.4f} ms, bound {b:.4f} ms ({by})", flush=True)

    # -- the commit ---------------------------------------------------------------
    cand_n = torch.sort(s_k, dim=1, stable=True).indices[:, :COMMIT_K].contiguous()
    neg_tol, batch_quality = commit_config()
    knobs = dict(neg_tol=neg_tol, batch_quality=batch_quality)
    tail = (sp.demand, sp.tasks, sp.criticality, sp.assignment0, sp.capacity, sp.task_limit,
            sp.ideal_frac, sp.ideal_task_frac, wvec, totals, budget)

    def fresh():
        return [x.clone(), util.clone(), tasks.clone()]

    got, want, one = fresh(), fresh(), fresh()
    st_k = commit_topk_batched_cuda(cand_n, s_k, t_k, *got, *tail, active, **knobs)
    st_p = commit_topk_batched_ref(cand_n, s_k, t_k, *want, *tail, active, **knobs)
    same_1 = True
    for s in live:
        st_1 = commit_topk_cuda(cand_n[s], s_k[s], t_k[s], *(v[s] for v in one),
                                *(a[s] for a in tail), **knobs)
        same_1 = same_1 and torch.equal(st_k[s], st_1)
    same_1 = same_1 and all(torch.equal(a, c) for a, c in zip(got, one))
    torch.cuda.synchronize()
    exact = torch.equal(st_k, st_p) and all(torch.equal(a, c) for a, c in zip(got, want))
    err = max(float((a - c).abs().max()) for a, c in zip(got[1:], want[1:]))
    if not (exact and same_1):
        raise AssertionError(f"commit_topk_batched {label}: plain version equal {exact} "
                             f"(max abs err {err:.3e}), unbatched kernel equal {same_1}")
    record["commit_topk_batched"]["max_abs_err"] = max(
        record["commit_topk_batched"]["max_abs_err"], err)
    nbytes = nops = 0.0
    for s in live:
        w_b, w_o = commit_work(shard_args[s][:12], (cand_n[s], s_k[s], t_k[s], totals[s],
                                                      budget[s]), x[s], got[0][s], neg_tol)
        nbytes, nops = nbytes + w_b, nops + w_o
    b, by = bound_ms(nbytes, nops)
    pool = [fresh() for _ in range(24)]
    ms = time_ms(lambda: commit_topk_batched_cuda(cand_n, s_k, t_k, *pool.pop(), *tail, active,
                                                  **knobs))
    pool = [fresh() for _ in range(24)]

    def unbatched():
        state = pool.pop()
        for s in live:
            commit_topk_cuda(cand_n[s], s_k[s], t_k[s], *(v[s] for v in state),
                             *(a[s] for a in tail), **knobs)

    unbatched_ms = time_ms(unbatched)
    pool = [fresh() for _ in range(4)]
    plain_ms = time_ms(lambda: commit_topk_batched_ref(cand_n, s_k, t_k, *pool.pop(), *tail,
                                                       active, **knobs), reps=3, warmup=1)
    accepted = st_k[:, 1].tolist()
    commit = {"ms": ms, "unbatched_ms": unbatched_ms, "plain_ms": plain_ms, "bound_ms": b,
              "bound_by": by}
    print(f"commit_topk_batched    {label} ({S} x {N} x {T}, k={COMMIT_K}, {len(live)} active): "
          f"accepted {accepted}, bit for bit the plain version and the unbatched kernel on "
          f"each shard; kernel {ms:.4f} ms, the unbatched kernel once an active shard "
          f"{unbatched_ms:.4f} ms, plain {plain_ms:.4f} ms (median of 3), bound {b:.8f} ms "
          f"({by})", flush=True)
    return {"shape": [S, N, T], "active": len(live), "sweep": sweep, "commit": commit}


def fleet_phase(dev, record) -> dict:
    """Phase 3h: the sharded fleet solver at N=1,000,000 on the card.  The
    reference's case once warm and once measured (the counts zeroed just
    before the measured pass), its checks, each shard against
    ``solve_local`` on that shard alone, a delta pass, and both batched
    kernels against their plain versions at the two million-app shapes."""
    import math

    import torch
    from repro_torch.core import LocalSearchConfig, objective, solve_local, validate
    from repro_torch.device import host_array
    from repro_torch.kernels import ops
    from repro_torch.shard import (FleetConfig, ShardSolveConfig, partition_problem,
                                   plan_shards, solve_fleet, solve_shards, synthetic_fleet)
    from repro_torch.shard.fleet import global_objective

    t = time.perf_counter()
    cluster = synthetic_fleet(FLEET_APPS, num_tiers=FLEET_TIERS, seed=FLEET_SEED, device=dev)
    build_s = time.perf_counter() - t
    p = cluster.problem
    obj0 = global_objective(p, host_array(p.assignment0))
    cfg = FleetConfig(num_shards=FLEET_SHARDS, timeout_s=30)
    t = time.perf_counter()
    warm = solve_fleet(cluster, cfg, device=dev)
    warm_s = time.perf_counter() - t
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    fd = solve_fleet(cluster, cfg, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.launch_counts)
    sh, tm, res = fd.sharded, fd.timings, fd.solve
    digest, digest_warm = (assignment_digest(torch.as_tensor(a))
                           for a in (fd.assignment, warm.assignment))
    print(f"fleet N={FLEET_APPS} T={FLEET_TIERS} seed={FLEET_SEED} S={sh.num_shards} (built in "
          f"{build_s:.2f} s; warm pass {warm_s:.4f} s): buckets ({sh.app_bucket}, "
          f"{sh.tier_bucket}), objective {obj0:.6e} -> {fd.objective:.6f} (the reference's CPU "
          f"run: {FLEET_REFERENCE_OBJECTIVE}), stranded {fd.stranded}, migrations "
          f"{fd.migrations}, saturated {fd.saturated}; partition_s {tm['partition_s']:.4f}, "
          f"solve_s {tm['solve_s']:.4f}, merge_s {tm['merge_s']:.4f}, coordinator_s "
          f"{tm['coordinator_s']:.4f}, total_s {tm['total_s']:.4f} (wall {wall:.4f} s), "
          f"{fd.apps_per_s:.1f} apps/s; sweeps {res.sweeps}, per shard "
          f"{res.iterations.tolist()} (committed {res.committed.tolist()}), digest {digest} "
          f"(warm pass {digest_warm}); launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if fd.stranded != 0:
        raise AssertionError(f"the fleet pass stranded {fd.stranded} apps")
    if (sh.app_bucket, sh.tier_bucket) != FLEET_BUCKETS:
        raise AssertionError(f"buckets ({sh.app_bucket}, {sh.tier_bucket}), not {FLEET_BUCKETS}")
    # Each tier of this fleet starts at the same utilization, so the start is
    # balanced (objective ~1e-9) and the pass cannot improve on it: the
    # shards' own objectives count their inert padded tiers (unit capacity,
    # no load) in their means, and at 131,072 apps a shard the sweep's f32
    # deltas round below -tol for moves that are not improving, so the
    # global objective rises, in the reference as well (its CPU run:
    # 20.956).  The mapping is held to the hard constraints instead, and
    # every objective is printed.
    start = [float(objective(sh.shard(s), sh.problems.assignment0[s]))
             for s in range(sh.num_shards)]
    valid = validate(p, torch.as_tensor(fd.assignment, device=dev))
    print(f"  shard objectives {[round(v, 6) for v in start]} -> "
          f"{[round(float(v), 6) for v in res.objective]}; the global objective "
          f"{obj0:.6e} -> {fd.objective:.6f}; moved {valid.num_moved}/{valid.move_budget}, "
          f"violations ok {valid.ok}", flush=True)
    if not (valid.ok and math.isfinite(fd.objective)):
        raise AssertionError(f"fleet mapping: violations {valid}, objective {fd.objective}")
    if digest != digest_warm:
        raise AssertionError("a second fleet pass of the same cluster gave another mapping")
    if not (res.sweeps > 0 and launches["move_eval_best_batched"] == res.sweeps
            == launches["commit_topk_batched"]):
        raise AssertionError(f"{res.sweeps} sweeps made {launches['move_eval_best_batched']} "
                             f"batched sweep and {launches['commit_topk_batched']} batched "
                             "commit launches (one each a sweep for all shards)")
    if launches["move_eval_best"] or launches["commit_topk"]:
        raise AssertionError(f"the fleet pass launched the unbatched kernels: {launches}")

    # Each shard of the batched pass against solve_local on that shard alone.
    local = LocalSearchConfig(max_iters=cfg.max_iters, tol=cfg.tol, batch_moves=cfg.batch_moves,
                              batch_quality=cfg.batch_quality)
    t = time.perf_counter()
    for s in range(sh.num_shards):
        alone = solve_local(sh.shard(s), local, device=dev)
        if not (torch.equal(res.x[s], alone.assignment)
                and (int(res.iterations[s]), int(res.committed[s]), float(res.objective[s]))
                == (alone.iterations, alone.extra["committed_moves"], alone.objective)):
            raise AssertionError(f"shard {s} of the batched pass differs from solve_local on "
                                 "that shard alone")
    alone_s = time.perf_counter() - t
    print(f"  each of the {sh.num_shards} shards equals solve_local on that shard alone bit for "
          f"bit (assignment, sweeps, commits, objective); the {sh.num_shards} solves took "
          f"{alone_s:.4f} s", flush=True)

    # Where a batched solve's time goes: PROFILE_SWEEPS sweeps under the profiler.
    prof = device_profile(lambda: solve_shards(sh, ShardSolveConfig(max_iters=PROFILE_SWEEPS),
                                               device=dev))
    print(solve_profile_line(f"  profile: {PROFILE_SWEEPS} batched sweeps of the {sh.num_shards} "
                             "shards", prof), flush=True)

    # The delta pass: the dirty shards re-solve as in the full pass, the clean
    # ones keep their incumbents.
    t = time.perf_counter()
    fdd = solve_fleet(cluster, cfg, dirty_shards=FLEET_DIRTY, device=dev)
    delta_s = time.perf_counter() - t
    rd = fdd.solve
    for s in range(sh.num_shards):
        if s in FLEET_DIRTY:
            ok = torch.equal(rd.x[s], res.x[s]) and rd.iterations[s] == res.iterations[s]
        else:
            ok = (torch.equal(rd.x[s], sh.problems.assignment0[s]) and rd.iterations[s] == 0
                  and rd.committed[s] == 0 and math.isnan(float(rd.objective[s])))
        if not (ok and bool(rd.solved[s]) == (s in FLEET_DIRTY)):
            raise AssertionError(f"delta pass: shard {s} (dirty {s in FLEET_DIRTY}) is wrong")
    if fdd.stranded != 0:
        raise AssertionError(f"the delta pass stranded {fdd.stranded} apps")
    print(f"  delta pass, dirty shards {FLEET_DIRTY}: solved_shards "
          f"{fdd.timings['solved_shards']}, delta_reverted {fdd.timings['delta_reverted']}, "
          f"objective {fdd.objective:.6f}, {rd.sweeps} sweeps, solve_s "
          f"{fdd.timings['solve_s']:.4f}, total_s {fdd.timings['total_s']:.4f} (wall "
          f"{delta_s:.4f} s); dirty shards as in the full pass, clean ones at their "
          "incumbents", flush=True)

    # Both batched kernels at the two million-app shapes.
    main = check_batched(f"S={sh.num_shards}", sh, record, dev)
    wide_sh = partition_problem(p, plan_shards(cluster, FLEET_WIDE_SHARDS))
    wide = check_batched(f"S={wide_sh.num_shards}", wide_sh, record, dev)
    return {"launches": launches, "sweeps": res.sweeps, "main": main, "wide": wide}


def fleet_service_events(tick: int, loop) -> list:
    """Phase 3i's events for ``tick`` at N=100,000, drawn from the loop's
    shadow and seeds.  Tick 0: SERVICE_PRODUCERS threads submit telemetry
    themselves (``produce_telemetry``); 1 an advisory beyond the planning
    horizon; 3 the demand of the apps homed in shard 0's tiers at 1.3 x;
    5 a fault window to tick 7; 7 SERVICE_FLEET_MOVERS departures from
    the least-loaded tier of shard 0 (a membership change confined to one
    shard, for a DELTA scoped to it that moves apps: shard 0's tiers
    rebalance among themselves); 10 SERVICE_FLEET_MOVERS arrivals into free rows
    and one region pair over the latency budget; 13 one tier's capacity at
    0.8 x (FULL)."""
    import numpy as np
    from repro_torch import service as S
    from repro_torch.core.planner import CAPACITY, Advisory
    from repro_torch.shard import plan_shards

    sh = loop.shadow
    live = np.flatnonzero(sh._valid)
    if tick == 0:
        produce_telemetry(loop)
    elif tick == 1:
        return [S.AdvisoryBatch(advisories=(Advisory(at=40, kind=CAPACITY, tier=0,
                                                     scale=0.5),))]
    elif tick in (3, 7):
        plan = plan_shards(sh.view(), loop.num_shards)
        ids = live[plan.app_shard[live] == 0]
        if tick == 3:
            return [S.TelemetryDelta(app_ids=tuple(int(n) for n in ids),
                                     demand=sh._demand[ids] * np.float32(1.3),
                                     tasks=sh._tasks[ids].copy(), collected_at=tick)]
        tiers = np.asarray(plan.shard_tiers[0])
        cold = tiers[np.argmin(sh.tier_loads()[tiers])]
        ids = ids[sh._x0[ids] == cold]
        return [S.AppDeparture(app_id=int(n)) for n in ids[-SERVICE_FLEET_MOVERS:]]
    elif tick == 5:
        return [S.FaultSignal(source="telemetry", until=7, severity=0.4)]
    elif tick == 10:
        rng = np.random.default_rng(5)
        free = np.flatnonzero(~sh._valid)[:SERVICE_FLEET_MOVERS]
        lat = np.array(sh._region_latency, np.float64)
        lat[0, 1] = lat[1, 0] = 54.0     # 1.5 x the 36 ms region budget
        return [S.AppArrival(app_id=int(n), demand=rng.lognormal(1.2, 0.9, 2).astype(np.float32),
                             tasks=float(rng.integers(1, 8)), slo=int(rng.integers(4)),
                             criticality=float(rng.random())) for n in free] + [
            S.LatencyDelta(region_latency=lat, collected_at=tick)]
    elif tick == 13:
        cap = sh._capacity.copy()
        cap[2] *= np.float32(0.8)
        return [S.CapacityUpdate(capacity=cap)]
    return []


def produce_telemetry(loop) -> None:
    """Tick 0 of phase 3i: SERVICE_PRODUCERS threads, each submitting
    SERVICE_PRODUCER_EVENTS telemetry deltas for its quarter of the live
    apps (skew U(0.9, 1.15), as bench_service_ingest draws it)."""
    import threading

    import numpy as np

    from repro_torch.service import TelemetryDelta

    sh = loop.shadow
    dem0, tsk0 = sh._demand.copy(), sh._tasks.copy()
    chunks = np.array_split(np.flatnonzero(sh._valid), SERVICE_PRODUCERS)

    def produce(pid: int, ids) -> None:
        rng = np.random.default_rng(100 + pid)
        app_ids = tuple(int(n) for n in ids)
        for _ in range(SERVICE_PRODUCER_EVENTS):
            skew = rng.uniform(0.9, 1.15, size=(ids.size, 1)).astype(np.float32)
            loop.submit(TelemetryDelta(app_ids=app_ids, demand=dem0[ids] * skew,
                                       tasks=tsk0[ids].copy(), collected_at=0))

    threads = [threading.Thread(target=produce, args=(i, c)) for i, c in enumerate(chunks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(t.is_alive() for t in threads):
        raise AssertionError("service: a producer thread did not finish")


def clone_args(args) -> list:
    import torch

    return [a.clone() if torch.is_tensor(a) else a for a in args]


def service_trajectory(cluster, device, events, *, ticks: int, cooldown: int, timeout_s: float,
                       levels=None, capture: bool = False, profile_ticks=()) -> dict:
    """``ticks`` ticks of ``events(tick, loop)`` through ``ServiceLoop`` on
    a ``BalanceController`` on ``device``, with the netlat plane when
    ``levels`` names it; the launch counters zeroed just before the first
    tick and read after the last.  Per tick: the decision, the step's
    wall-clock, the balance's ``solve_s``, the kernels it launched, the
    netlat level's counters, and for a solve the apps that moved outside
    the dirty shards and how many of those the coordinator did not grant;
    the shadow's ``view`` calls and the loop's shard scoping (its two
    ``plan_shards``) timed.  With ``capture``, the first call of each
    shard-batched kernel in a tick is kept (inputs and outputs, cloned on
    the card) for ``check_service_kernels``.  ``profile_ticks`` run under
    ``torch.profiler``."""
    import numpy as np
    import torch
    from repro_torch import netlat as NL
    from repro_torch import service as S
    from repro_torch.core import BalanceController, ControllerConfig, CoopConfig
    from repro_torch.device import host_array
    from repro_torch.kernels import ops
    from repro_torch.shard import plan_shards
    from repro_torch.shard.coordinator import FleetCoordinator

    cuda = torch.device(device).type == "cuda"
    ctl = BalanceController(cluster, ControllerConfig(
        timeout_s=timeout_s, cooldown_rounds=cooldown,
        coop=CoopConfig(levels=levels) if levels else None), device=device)
    loop = S.ServiceLoop(controller=ctl)
    sh = loop.shadow
    netlat = bool(levels) and "netlat" in levels
    bank = NL.LinkSketchBank(cluster.region_latency.shape[0]) if netlat else None
    source = NL.LinkMeasurementSource(seed=SERVICE_SOURCE_SEED) if netlat else None
    truth = np.asarray(cluster.region_latency, np.float64)

    # Timers around the shadow's views and the loop's shard scoping, and a
    # record of what the controller was handed each solve.
    spent = {"view_s": 0.0, "views": 0, "scope_s": 0.0}

    def timed(fn, key):
        def call(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[key] += time.perf_counter() - t
                if key == "view_s":
                    spent["views"] += 1
        return call

    sh.view = timed(sh.view, "view_s")
    loop._dirty_shards = timed(loop._dirty_shards, "scope_s")
    loop._shard_apps = timed(loop._shard_apps, "scope_s")
    handed, ctl_step = [], ctl.step

    def recorded_step(inp):
        handed.append(inp)
        return ctl_step(inp)

    ctl.step = recorded_step

    # The coordinator's granted (app, tier) migrations, and with ``capture``
    # the first launch of each batched kernel a tick.
    granted, captured, now = [], {}, {"tick": None}
    plan_migrations = FleetCoordinator.plan_migrations

    def recorded_migrations(self, *args, **kw):
        moves = plan_migrations(self, *args, **kw)
        granted.extend((int(a), int(t)) for a, t in moves)
        return moves

    FleetCoordinator.plan_migrations = recorded_migrations
    uncapture = capture_batched(captured, now) if capture else (lambda: None)
    records, profiles = [], {}
    if netlat:
        NL.install_bank(bank, config=NL.NetlatConfig(), now=0)
    try:
        if cuda:
            torch.cuda.synchronize()
        ops.reset_launch_counts()
        for tick in range(ticks):
            for event in events(tick, loop):
                if event.kind == "latency":
                    truth = np.asarray(event.region_latency, np.float64)
                loop.submit(event)
            if netlat:
                bank.ingest(source.measure(truth, tick), tick)
                if not bank.calibrated and tick + 1 >= SERVICE_CALIBRATE_TICKS:
                    bank.calibrate(tick)
                NL.set_now(tick)
                if ctl.monitor is not None:
                    ctl.monitor.note_signal(bank.signal_health(tick))
            before = dict(ops.launch_counts)
            spent0 = dict(spent)
            n_handed, n_granted = len(handed), len(granted)
            now["tick"] = tick
            t = time.perf_counter()
            if tick in profile_ticks:
                box = {}
                profiles[tick] = device_profile(lambda: box.setdefault("out", loop.step(tick)))
                out = box["out"]
            else:
                out = loop.step(tick)
            if cuda:
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            res = out.result
            d = None if res is None else res.decision
            coop = None if d is None else d.cooperation
            rec = {"tick": tick, "action": out.action, "reason": out.reason,
                   "dirty_shards": out.dirty_shards, "applied": out.applied,
                   "drained": out.events_drained, "latency_s": out.latency_s, "wall_s": wall,
                   "delta": None if res is None else res.delta,
                   "moved": None if res is None else res.moved,
                   "valid": None if d is None else bool(d.violations.ok),
                   "solve_s": None if d is None else d.solve.extra["balance_timings"]["solve_s"],
                   "iterations": None if d is None else d.solve.iterations,
                   "sharded": None if d is None else d.solve.extra.get("sharded"),
                   "calibrated": None if bank is None else bank.calibrated,
                   "netlat": (dict(coop.timings.levels["netlat"])
                              if netlat and coop is not None else None),
                   "launched": {k: v - before[k] for k, v in ops.launch_counts.items()
                                if v != before[k]},
                   "view_s": spent["view_s"] - spent0["view_s"],
                   "views": spent["views"] - spent0["views"],
                   "scope_s": spent["scope_s"] - spent0["scope_s"]}
            if d is not None and res.delta and len(handed) > n_handed:
                inp = handed[-1]
                plan = plan_shards(inp.cluster, loop.num_shards)
                x0 = host_array(inp.cluster.problem.assignment0)
                x1 = host_array(ctl.cluster.problem.assignment0)
                outside = np.flatnonzero((x0 != x1) & ~np.isin(plan.app_shard,
                                                               np.asarray(out.dirty_shards)))
                moves = set(granted[n_granted:])
                rec["moved_outside"] = int(outside.size)
                rec["outside_not_granted"] = sum((int(a), int(x1[a])) not in moves
                                                 for a in outside)
            records.append(rec)
        if cuda:
            torch.cuda.synchronize()
        launches = dict(ops.launch_counts)
    finally:
        FleetCoordinator.plan_migrations = plan_migrations
        uncapture()
        if netlat:
            NL.install_bank(None)
    return {"ticks": records, "launches": launches, "stats": loop.stats(),
            "dropped": loop.dropped_events,
            "ordered": all(seqs == sorted(seqs) for seqs in sh.applied_seq.values()),
            "events": loop.applied_events,
            "digest": assignment_digest(ctl.cluster.problem.assignment0),
            "calibrated": None if bank is None else bank.calibrated,
            "health": None if bank is None else bank.signal_health(ticks - 1),
            "captured": captured, "profiles": profiles, "loop": loop}


def capture_batched(captured: dict, now: dict):
    """Hook the two shard-batched kernels' wrappers in ``ops`` so that the
    first call of each in every tick (``now["tick"]``) is kept in
    ``captured[tick]``: its inputs and outputs, cloned on the card, for
    ``check_batched_kernels``.  Returns the function that unhooks them."""
    from repro_torch.kernels import ops

    sweep_fn, commit_fn = ops.move_eval_best_batched, ops.commit_topk_batched

    def sweep_hook(*args, totals, active):
        out = sweep_fn(*args, totals=totals, active=active)
        box = captured.setdefault(now["tick"], {})
        if "sweep" not in box:
            box["sweep"] = {"args": clone_args(args), "active": active.clone(),
                            "out": clone_args(out)}
        return out

    def commit_hook(*args, neg_tol, batch_quality):
        box = captured.setdefault(now["tick"], {})
        before = None if "commit" in box else clone_args(args)
        out = commit_fn(*args, neg_tol=neg_tol, batch_quality=batch_quality)
        if before is not None:
            box["commit"] = {"args": before, "out": out.clone(), "state": clone_args(args[3:6]),
                             "knobs": {"neg_tol": neg_tol, "batch_quality": batch_quality}}
        return out

    ops.move_eval_best_batched, ops.commit_topk_batched = sweep_hook, commit_hook

    def unhook():
        ops.move_eval_best_batched, ops.commit_topk_batched = sweep_fn, commit_fn

    return unhook


def check_batched_kernels(label: str, captured: dict, record) -> list:
    """Hold the first ``move_eval_best_batched`` and ``commit_topk_batched``
    launch of each in every tick that solved sharded, its captured inputs
    as the main path gave them, to the plain versions bit for bit; fold the
    errors into ``record``.  One row a tick: (S, app bucket, tier bucket),
    active shards, errors."""
    import torch
    from repro_torch.kernels.ref import commit_topk_batched_ref, move_eval_best_batched_ref

    rows = []
    for tick, box in sorted(captured.items()):
        sw, cm = box["sweep"], box["commit"]
        s_k, t_k = sw["out"]
        s_p, t_p = move_eval_best_batched_ref(*sw["args"], active=sw["active"])
        finite = torch.isfinite(s_p)
        err_s = float((s_k[finite] - s_p[finite]).abs().max()) if bool(finite.any()) else 0.0
        exact_s = torch.equal(s_k, s_p) and torch.equal(t_k, t_p)
        args = clone_args(cm["args"])
        st_p = commit_topk_batched_ref(*args, **cm["knobs"])
        exact_c = (torch.equal(cm["out"], st_p)
                   and all(torch.equal(a, b) for a, b in zip(cm["state"], args[3:6])))
        err_c = max(float((a - b).abs().max()) for a, b in zip(cm["state"][1:], args[4:6]))
        S, N, _ = sw["args"][0].shape
        T = sw["args"][5].shape[1]
        row = {"tick": tick, "shape": (S, N, T), "active": int(sw["active"].sum()),
               "accepted": cm["out"][:, 1].tolist(), "sweep_err": err_s, "commit_err": err_c,
               "exact": exact_s and exact_c}
        print(f"{label} tick {tick}: move_eval_best_batched and commit_topk_batched at (S, app "
              f"bucket, tier bucket) = {row['shape']}, {row['active']} active, first sweep as "
              f"the main path launched it: sweep equal to its plain version {exact_s} (max abs "
              f"err {err_s:.3e}), commit (status, assignment, tier loads) equal {exact_c} (max "
              f"abs err {err_c:.3e}), accepted {row['accepted']}", flush=True)
        if not row["exact"]:
            raise AssertionError(f"{label} tick {tick}: a batched kernel disagrees with its "
                                 f"plain version at {row['shape']}")
        record["move_eval_best_batched"]["max_abs_err"] = max(
            record["move_eval_best_batched"]["max_abs_err"], err_s)
        record["commit_topk_batched"]["max_abs_err"] = max(
            record["commit_topk_batched"]["max_abs_err"], err_c)
        rows.append(row)
    return rows


SERVICE_FIELDS = ("action", "dirty_shards", "applied")


def service_phase(dev, record) -> dict:
    """Phase 3i: the streaming service at N=100,000 on the card
    (``fleet_service_events``), its checks, both batched kernels held to
    their plain versions on the inputs the run gave them, a repeat with the
    scoped DELTA tick and one FULL tick profiled, the host time of the
    shadow's view and the loop's ``plan_shards``, and the N=300 stream of
    tests/_service_stream.py on the card against the CPU's plain path."""
    import numpy as np
    import torch
    import repro_torch.core.planner as planner
    from repro_torch import service as S
    from repro_torch.core import generate_cluster
    from repro_torch.shard import plan_shards

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _service_stream as small

    fleet = {"ticks": SERVICE_FLEET_TICKS, "cooldown": SERVICE_FLEET_COOLDOWN,
             "timeout_s": SERVICE_FLEET_TIMEOUT_S, "levels": ("netlat", "host")}
    cluster = generate_cluster(num_apps=SERVICE_FLEET_APPS, seed=SERVICE_FLEET_SEED, device=dev)
    run = service_trajectory(cluster, dev, fleet_service_events, capture=True, **fleet)
    ticks, launches, stats = run["ticks"], run["launches"], run["stats"]
    shards = run["loop"].num_shards
    for r in ticks:
        sharded = r["sharded"] or {}
        print(f"service N={SERVICE_FLEET_APPS} tick {r['tick']}: {r['action']} (dirty shards "
              f"{r['dirty_shards']}), applied {r['applied']}, drained {r['drained']}, latency_s "
              f"{r['latency_s']:.4f} (wall {r['wall_s']:.4f}), solve_s {r['solve_s']}, moved "
              f"{r['moved']} (outside the dirty shards {r.get('moved_outside')}, of them not "
              f"granted by the coordinator {r.get('outside_not_granted')}; migrations "
              f"{sharded.get('migrations')}, delta_reverted {sharded.get('delta_reverted')}), "
              f"sweeps {r['iterations']}, valid {r['valid']}, launched {r['launched']}, bank "
              f"calibrated {r['calibrated']}, netlat level {r['netlat']}, views {r['views']} in "
              f"{r['view_s']:.4f} s, shard scoping {r['scope_s']:.4f} s; {r['reason'][:90]}",
              flush=True)
    keys = ("events_per_s", "resolve_p50_ms", "resolve_p99_ms", "noop_p50_ms", "delta_fraction")
    print(f"service: stats {stats}; {', '.join(f'{k} {stats[k]}' for k in keys)}; launches "
          f"{ {k: v for k, v in launches.items() if v} }, dropped {run['dropped']}, per-app "
          f"order kept {run['ordered']}, bank calibrated {run['calibrated']}, link health "
          f"{run['health']} (printed: the controller runs without the fault plane, so it has "
          f"no monitor to publish it to), final digest {run['digest']}", flush=True)

    actions = {r["action"] for r in ticks}
    if actions != {"noop", "delta", "full"}:
        raise AssertionError(f"service: actions {sorted(actions)}, not all of noop/delta/full")
    delta_ticks = [r for r in ticks if r["action"] == "delta" and r["delta"] and r["iterations"]
              and r["launched"].get("move_eval_best_batched") == r["iterations"]
              == r["launched"].get("commit_topk_batched")
              and not r["launched"].get("move_eval_best") and not r["launched"].get("commit_topk")]
    if not delta_ticks:
        raise AssertionError("service: no DELTA tick ran the sharded route with one launch of "
                             "each batched kernel a sweep")
    scoped = [r for r in delta_ticks if r["applied"] and 0 < len(r["dirty_shards"]) < shards
              and r["moved"] and not r["sharded"]["delta_reverted"]]
    print(f"service: DELTA ticks on the sharded route {[r['tick'] for r in delta_ticks]}, of "
          f"them applied, scoped to a strict subset of the {shards} shards and moving apps "
          f"(not reverted) {[(r['tick'], r['dirty_shards'], r['moved']) for r in scoped]}",
          flush=True)
    if not scoped:
        raise AssertionError("service: no applied DELTA tick scoped to a strict subset of the "
                             "shards moved an app")
    full_ticks = [
        r for r in ticks if r["action"] == "full" and all(
            r["launched"].get(k, 0) > 0 for k in ("move_eval_best", "commit_topk",
                                                  "pack_ffd_tiers"))
        and not r["launched"].get("move_eval_best_batched")]
    if not full_ticks:
        raise AssertionError("service: no FULL tick ran the unbatched path (sweep, commit, pack)")
    if run["dropped"] != 0 or not run["ordered"] or run["events"] != stats["events_submitted"]:
        raise AssertionError(f"service: dropped {run['dropped']}, ordered {run['ordered']}, "
                             f"applied {run['events']} of {stats['events_submitted']}")
    if any(r["applied"] and not r["valid"] for r in ticks):
        raise AssertionError("service: an applied decision is not valid")
    for r in ticks:
        if r.get("outside_not_granted"):
            raise AssertionError(f"service tick {r['tick']}: {r['outside_not_granted']} apps "
                                 f"outside the dirty shards {r['dirty_shards']} moved with no "
                                 "coordinator migration")
    if not run["calibrated"]:
        raise AssertionError("service: the netlat bank never calibrated")
    vetted = [r for r in full_ticks if r["calibrated"]]
    if not vetted or any((r["netlat"] or {}).get("measured") != 1 for r in vetted):
        raise AssertionError(f"service: the netlat level did not run on measured budgets on "
                             f"the FULL ticks after calibration "
                             f"{[(r['tick'], r['netlat']) for r in vetted]}")
    kernel_rows = check_batched_kernels("service", run["captured"], record)
    if sorted(row["tick"] for row in kernel_rows) != [r["tick"] for r in delta_ticks]:
        raise AssertionError("service: the batched kernels were not held to their plain "
                             "versions on every DELTA tick")

    profile_ticks = (scoped[0]["tick"], full_ticks[-1]["tick"])
    again = service_trajectory(cluster, dev, fleet_service_events, profile_ticks=profile_ticks,
                               **fleet)
    same = (again["digest"] == run["digest"]
            and [[r[k] for k in SERVICE_FIELDS] for r in again["ticks"]]
            == [[r[k] for k in SERVICE_FIELDS] for r in ticks])
    print(f"service repeat: digest {again['digest']}, the same actions, dirty shards, applied "
          f"flags and digest {same}; stats {again['stats']}", flush=True)
    if not same:
        raise AssertionError("service: a repeat of the phase gave other decisions")
    for tick in profile_ticks:
        print(solve_profile_line(f"profile: service tick {tick} "
                                 f"({again['ticks'][tick]['action']}, dirty shards "
                                 f"{again['ticks'][tick]['dirty_shards']})",
                                 again["profiles"][tick]), flush=True)

    # The host time of the shadow's view and of one plan_shards at N=100,000.
    loop = run["loop"]
    view_s, plan_s = [], []
    for _ in range(5):
        t = time.perf_counter()
        view = loop.shadow.view()
        torch.cuda.synchronize()
        view_s.append(time.perf_counter() - t)
        t = time.perf_counter()
        plan_shards(view, loop.num_shards)
        plan_s.append(time.perf_counter() - t)
    steps = len(ticks)
    print(f"service: the shadow's view {np.median(view_s) * 1e3:.4f} ms and plan_shards "
          f"{np.median(plan_s) * 1e3:.4f} ms at N={SERVICE_FLEET_APPS} (median of 5); a step "
          f"made {sum(r['views'] for r in ticks) / steps:.2f} views ("
          f"{sum(r['view_s'] for r in ticks) / steps * 1e3:.4f} ms) and spent "
          f"{sum(r['scope_s'] for r in ticks) / steps * 1e3:.4f} ms in its shard scoping "
          f"(the two plan_shards), mean over {steps} steps", flush=True)

    def small_events(tick, loop):
        return small.service_events(tick, loop, S, planner, plan_shards)

    script = {"ticks": small.SERVICE_TICKS, "cooldown": small.SERVICE_COOLDOWN,
              "timeout_s": small.SERVICE_TIMEOUT_S}
    few = generate_cluster(num_apps=small.SERVICE_APPS, seed=small.SERVICE_SEED, device="cpu")
    on_card = service_trajectory(few, dev, small_events, **script)["ticks"]
    on_cpu = service_trajectory(few, "cpu", small_events, **script)["ticks"]
    agree = all(a[k] == b[k] for a, b in zip(on_card, on_cpu) for k in SERVICE_FIELDS)
    print(f"service N={small.SERVICE_APPS}: card "
          f"{[[r[k] for k in SERVICE_FIELDS] for r in on_card]}, plain path agrees {agree}; "
          f"moved card/cpu {[(a['moved'], b['moved']) for a, b in zip(on_card, on_cpu)]}",
          flush=True)
    if not agree:
        raise AssertionError("service: the card's N=300 stream disagrees with the plain path")
    return {"run": run, "again": again, "kernels": kernel_rows}


def sim_trajectory(sc, device, *, profile_tick=None, workload_fn=None,
                   capture: bool = False) -> dict:
    """``run_pair(sc)`` on ``device`` with the launch counters zeroed just
    before, every tick timed and read: its wall-clock split into the world
    (workload step, events, arrivals), the controller's ``step`` and the
    accountant's ``observe`` (each between synchronisations), the kernels it
    launched, whether its applied decision was valid, the digest of the
    assignment it scored and its ``TickStats`` without the wall clock.  One
    record a run (the static baseline, then the controller); the balanced
    run's ``profile_tick`` steps under ``torch.profiler``.  With
    ``capture``, the first call of each shard-batched kernel in a tick is
    kept (``capture_batched``, keyed by the tick's index in its run)."""
    import dataclasses

    import torch
    import repro_torch.sim.harness as H
    from repro_torch.core.controller import BalanceController
    from repro_torch.kernels import ops
    from repro_torch.sim import slo

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    runs, now, captured = [], {"tick": None}, {}
    build, step, observe = H.build_fleet, BalanceController.step, slo.SloAccountant.observe

    def timed_build(sc, **kw):
        sync()
        t = time.perf_counter()
        fleet = build(sc, **kw)
        sync()
        runs.append({"build_s": time.perf_counter() - t, "ticks": []})
        now.update(mark=time.perf_counter(), ctl_s=0.0, result=None,
                   launches=dict(ops.launch_counts))
        return fleet

    def timed_step(ctl, inp=None):
        sync()
        now["tick"] = len(runs[-1]["ticks"])
        t = time.perf_counter()
        if now["tick"] == profile_tick:
            box = {}
            runs[-1]["profile"] = device_profile(lambda: box.setdefault("r", step(ctl, inp)))
            r = box["r"]
        else:
            r = step(ctl, inp)
        sync()
        now["ctl_s"] += time.perf_counter() - t
        now["result"] = r
        return r

    def timed_observe(acct, cluster, **kw):
        sync()
        t = time.perf_counter()
        stat = observe(acct, cluster, **kw)
        sync()
        end = time.perf_counter()
        r, counts = now["result"], dict(ops.launch_counts)
        runs[-1]["ticks"].append({
            "tick": stat.tick, "wall_s": end - now["mark"], "controller_s": now["ctl_s"],
            "accounting_s": end - t, "world_s": t - now["mark"] - now["ctl_s"],
            "launched": {k: v - now["launches"].get(k, 0) for k, v in counts.items()
                         if v != now["launches"].get(k, 0)},
            "valid": (None if r is None or r.decision is None
                      else bool(r.decision.violations.ok)),
            "digest": assignment_digest(cluster.problem.assignment0),
            "record": {k: v for k, v in dataclasses.asdict(stat).items() if k != "solve_s"}})
        runs[-1]["cluster"] = cluster
        now.update(mark=time.perf_counter(), ctl_s=0.0, result=None, launches=counts)
        return stat

    H.build_fleet, BalanceController.step = timed_build, timed_step
    slo.SloAccountant.observe = timed_observe
    uncapture = capture_batched(captured, now) if capture else (lambda: None)
    sync()
    ops.reset_launch_counts()
    t = time.perf_counter()
    try:
        out = H.run_pair(sc, device=device, workload_fn=workload_fn)
        sync()
    finally:
        H.build_fleet, BalanceController.step = build, step
        slo.SloAccountant.observe = observe
        uncapture()
    return {"out": out, "runs": runs, "total_s": time.perf_counter() - t,
            "launches": dict(ops.launch_counts), "captured": captured}


def accounting_parts(cluster) -> dict:
    """Host seconds (median of 5, between synchronisations) of each part of
    the accountant's ``observe`` on ``cluster``, each on a fresh copy, so
    that the memoized matrices are rebuilt as every tick rebuilds them."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core import metrics as M
    from repro_torch.core.hierarchy import RegionScheduler
    from repro_torch.core.telemetry import shard_affinity_of
    from repro_torch.sim.slo import score_cluster

    parts = {"score_cluster": lambda c: score_cluster(c.problem),
             "region worst latency [G, T]": RegionScheduler,
             "shard affinity [N, T]": shard_affinity_of,
             "placement_p99_ms": M.placement_p99_ms}
    out = {}
    for name, fn in parts.items():
        times = []
        for _ in range(5):
            c = dataclasses.replace(cluster)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(c)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        out[name] = float(np.median(times))
    return out


def sim_phase(dev, record) -> dict:
    """Phase 3j: ``run_pair`` of each of ``SIM_SCENARIOS`` at N=100,000 on
    the card for ``SIM_TICKS`` ticks, its checks, fleet_scale's batched
    kernels held to their plain versions on the inputs its run gave them, a
    repeat of tier_drain with its first triggered tick profiled, and
    tier_drain at N=300 on the card against the CPU's plain path (the same
    host draws): the same decisions and assignment every tick."""
    import numpy as np
    from repro_torch.sim import get_scenario

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _sim_world

    t_phase = time.perf_counter()
    unbatched = ("move_eval_best", "commit_topk", "move_eval")
    results = {}
    for name in SIM_SCENARIOS:
        sc = get_scenario(name, num_apps=SIM_APPS, ticks=SIM_TICKS)
        run = sim_trajectory(sc, dev, capture=name == "fleet_scale")
        out, (static, balanced) = run["out"], run["runs"]
        for policy, r in (("static", static), ("balanced", balanced)):
            print(f"sim {name} N={SIM_APPS} {policy}: fleet built in {r['build_s']:.4f} s",
                  flush=True)
            for t in r["ticks"]:
                rec = t["record"]
                print(f"sim {name} {policy} tick {t['tick']}: wall {t['wall_s']:.4f} s = world "
                      f"{t['world_s']:.4f} + controller {t['controller_s']:.4f} + accounting "
                      f"{t['accounting_s']:.4f}; triggered {rec['triggered']}, applied "
                      f"{rec['applied']}, moved {rec['moved']}, valid {t['valid']}, mode "
                      f"{rec['mode']}, d2b {rec['d2b']:.4f}, slo {rec['slo_violating_apps']}, "
                      f"over ideal {rec['over_ideal_tiers']}, cost {rec['movement_cost']:.2f}, "
                      f"launched {t['launched']}", flush=True)
        ticks = balanced["ticks"]
        parts = {k: float(np.sum([t[k] for t in ticks])) for k in
                 ("wall_s", "world_s", "controller_s", "accounting_s")}
        summary = out["balanced"].summary()
        print(f"sim {name}: run_pair {run['total_s']:.4f} s; the balanced run's ticks "
              f"{ {k: round(v, 4) for k, v in parts.items()} }, static ticks "
              f"{sum(t['wall_s'] for t in static['ticks']):.4f} s; launches {run['launches']}; "
              f"rebalances {summary['rebalances']}, triggers {summary['triggers']}, unsafe moves "
              f"{summary['unsafe_moves']}, mode ticks {summary['mode_ticks']}", flush=True)
        print(f"sim {name}: compare {json.dumps(out['compare'])}", flush=True)
        acct = accounting_parts(balanced["cluster"])
        print(f"sim {name}: the accountant's parts on the last tick's cluster (s, median of 5) "
              f"{ {k: round(v, 6) for k, v in acct.items()} }", flush=True)

        if summary["rebalances"] < 1 or summary["triggers"] < 1:
            raise AssertionError(f"sim {name}: the controller never triggered and applied")
        if any(t["launched"] for t in static["ticks"]):
            raise AssertionError(f"sim {name}: the static baseline launched a kernel")
        if summary["unsafe_moves"] != 0:
            raise AssertionError(f"sim {name}: {summary['unsafe_moves']} unsafe moves")
        if any(t["record"]["applied"] and not t["valid"] for t in ticks):
            raise AssertionError(f"sim {name}: an applied mapping is not valid")
        solved = [t for t in ticks if t["valid"] is not None]
        if name == "fleet_scale":
            for t in solved:
                launched = t["launched"]
                if not (launched.get("move_eval_best_batched", 0) > 0
                        and launched.get("commit_topk_batched", 0) > 0
                        and not any(launched.get(k, 0) for k in unbatched)):
                    raise AssertionError(f"sim fleet_scale tick {t['tick']}: the sharded tick "
                                         f"launched {launched}")
            rows = check_batched_kernels(f"sim {name}", run["captured"], record)
            launched = [t["tick"] for t in ticks if t["launched"].get("move_eval_best_batched")]
            if not launched or [row["tick"] for row in rows] != launched:
                raise AssertionError(f"sim {name}: the batched kernels were not held to their "
                                     f"plain versions on every tick that launched them "
                                     f"{launched}")
            run["captured"].clear()
        else:
            for k in ("move_eval_best", "commit_topk", "pack_ffd_tiers"):
                if run["launches"][k] <= 0:
                    raise AssertionError(f"sim {name}: the global path launched {k} no time")
            if not out["compare"]["movement"]["within_budget"]:
                raise AssertionError(f"sim {name}: movement {out['compare']['movement']}")
        results[name] = {"run": run, "first_triggered": solved[0]["tick"]}

    name = SIM_SCENARIOS[0]
    first = results[name]
    sc = get_scenario(name, num_apps=SIM_APPS, ticks=SIM_TICKS)
    again = sim_trajectory(sc, dev, profile_tick=first["first_triggered"])
    keys = ("record", "digest")
    same = ([[t[k] for k in keys] for t in again["runs"][1]["ticks"]]
            == [[t[k] for k in keys] for t in first["run"]["runs"][1]["ticks"]])
    print(f"sim {name} repeat: run_pair {again['total_s']:.4f} s, final digest "
          f"{again['runs'][1]['ticks'][-1]['digest']} (first run "
          f"{first['run']['runs'][1]['ticks'][-1]['digest']}), the same per-tick records and "
          f"digests {same}", flush=True)
    if not same:
        raise AssertionError(f"sim {name}: a repeat of the balanced run gave other records")
    print(solve_profile_line(f"profile: sim {name} tick {first['first_triggered']} (the "
                             f"controller's step, triggered) at N={SIM_APPS}",
                             again["runs"][1]["profile"]), flush=True)

    small = get_scenario(name, num_apps=SIM_SMALL_N, ticks=SIM_SMALL_TICKS)
    pairs = {d: sim_trajectory(small, d, workload_fn=_sim_world.host_draws(SIM_DRAW_SEED))
             for d in (dev, "cpu")}
    small_s = {str(d): round(r["total_s"], 4) for d, r in pairs.items()}
    card, cpu = ([[[t["record"][k] for k in _sim_world.SIM_DECISIONS] + [t["digest"]]
                   for t in run["ticks"]] for run in pairs[d]["runs"]] for d in (dev, "cpu"))
    agree = card == cpu
    print(f"sim {name} N={SIM_SMALL_N}: card (static, then balanced; per tick "
          f"{_sim_world.SIM_DECISIONS} and the assignment digest) {card}; plain path agrees "
          f"{agree}", flush=True)
    if not agree:
        print(f"sim {name} N={SIM_SMALL_N}: plain path {cpu}", flush=True)
        raise AssertionError(f"sim: the card's N={SIM_SMALL_N} {name} disagrees with the plain "
                             "path")
    print(f"sim: phase 3j took {time.perf_counter() - t_phase:.4f} s (the N={SIM_SMALL_N} "
          f"run_pair {small_s} s)", flush=True)
    return {name: r["run"] for name, r in results.items()} | {"again": again}


def stream_phase(dev, record) -> dict:
    """Phase 3k: the stream router and the fault path at ``STREAM_APPS``
    (``tests/_stream_fleet.py::stream_script`` on the card, each step timed
    between synchronisations with the launch counters zeroed just before
    it): ``build_cluster``, ``route`` (valid, no worse than the start, every
    app in one slice's partitions, ``move_eval_best``, ``commit_topk``,
    ``pack_ffd_tiers`` and ``tier_stats`` launched; a repeat under the
    profiler gives the same digest), four arrivals through ``admit`` (an
    admitted app ends ``assignment0`` in its priced tier), the service
    records, ``rebalance`` after the injector's schedule (valid, within the
    budget, the same kernels launched), a region outage and its restore
    (the as-built capacity back), one controller tick on the faulted fleet
    that ``sync`` adopts; then the script at ``STREAM_SMALL_N`` on the card
    and on the CPU's plain path, which must agree."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.streams import StreamRouter

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import _stream_fleet as SF

    t_phase = time.perf_counter()
    times, counts = {}, {}

    def timed(label, fn):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[label] = time.perf_counter() - t
        counts[label] = {k: v for k, v in ops.launch_counts.items() if v}
        return out

    run = SF.stream_script(STREAM_APPS, dev, timed=timed)
    route, rb, router = run["route"], run["rebalance"], run["router"]
    scheduling = ("move_eval_best", "commit_topk", "pack_ffd_tiers", "tier_stats")
    print(f"stream N={STREAM_APPS}: build_cluster {times['build_cluster']:.4f} s; route "
          f"{times['route']:.4f} s, objective {run['start_objective']:.6f} -> "
          f"{route['objective']:.6f}, valid {route['ok']}, rounds {route['rounds']}, moved "
          f"{route['moved']}/{route['budget']}, sweeps {counts['route'].get('move_eval_best', 0)}"
          f", digest {SF.digest(route['assignment'])}, launches {counts['route']}", flush=True)
    names = [name for part in run["partitions"] for name in part]
    if not (route["ok"] and route["objective"] <= run["start_objective"]):
        raise AssertionError(f"stream route: valid {route['ok']}, objective "
                             f"{route['objective']} from {run['start_objective']}")
    if len(names) != STREAM_APPS or len(set(names)) != STREAM_APPS:
        raise AssertionError(f"stream route: the slices' partitions list {len(names)} apps "
                             f"({len(set(names))} distinct) of {STREAM_APPS}")
    for label in ("route", "rebalance"):
        missing = [k for k in scheduling if counts[label].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"stream {label} launched {missing} no time")

    again = []
    prof = device_profile(lambda: again.append(StreamRouter(run["cluster"]).route()))
    same = SF.digest(again[0].assignment) == SF.digest(route["assignment"])
    print(solve_profile_line(f"profile: stream route repeat at N={STREAM_APPS} (the same "
                             f"digest {same})", prof), flush=True)
    if not same:
        raise AssertionError("stream route: a repeat gave another assignment")

    n = STREAM_APPS
    for i, (state, tier, cap, admitted, num_apps, last) in enumerate(run["admit"]):
        print(f"stream admit {i} ({SF.ARRIVAL_MODES[i]}): {state}, tier {tier}, cap {cap:.4f}, "
              f"{times[f'admit {i}']:.4f} s, cluster of {num_apps} apps", flush=True)
        if admitted:
            n += 1
            if (num_apps, last) != (n, tier):
                raise AssertionError(f"stream admit {i}: the grown cluster ({num_apps} apps) "
                                     f"ends assignment0 in tier {last}, priced {tier}")
        elif num_apps != n:
            raise AssertionError(f"stream admit {i}: a {state} arrival grew the cluster")
    state, tier, cap, ev = run["arrival_event"]
    if ev is None or ev[1] != tier or ev[2] != run["arrival_demand"]:
        raise AssertionError(f"stream arrival_event: decision {(state, tier, cap)}, record "
                             f"{ev}, capped demand {run['arrival_demand']}")
    if run["departure_event"] != 3:
        raise AssertionError(f"stream departure_event: app {run['departure_event']}")

    print(f"stream rebalance after {len(run['schedule'][0])} injector events "
          f"({run['schedule'][1]} advisories): {times['rebalance']:.4f} s, valid {rb['ok']}, "
          f"moved {rb['moved']}/{rb['budget']}, rounds {rb['rounds']}, objective "
          f"{rb['objective']:.6f}, launches {counts['rebalance']}", flush=True)
    if not (rb["ok"] and rb["moved"] <= rb["budget"]):
        raise AssertionError(f"stream rebalance: valid {rb['ok']}, moved {rb['moved']} of "
                             f"{rb['budget']}")
    if not (np.array_equal(run["restored_capacity"], run["built_capacity"])
            and not np.array_equal(run["outage_capacity"], run["built_capacity"])):
        raise AssertionError("stream degrade: the outage and restore did not give the as-built "
                             "capacity back")
    applied, tick = run["tick"]
    print(f"stream controller step on the faulted fleet: {times['controller step']:.4f} s, "
          f"applied {applied}, synced digest {run['synced_digest']}, launches "
          f"{counts['controller step']}", flush=True)
    if not (applied and run["synced_digest"] == SF.digest(tick["assignment"])):
        raise AssertionError("stream sync: the router did not adopt the applied tick")

    small = {str(d): SF.stream_script(STREAM_SMALL_N, d) for d in (dev, "cpu")}
    card, cpu = small[str(dev)], small["cpu"]
    mismatches = SF.script_mismatches(card, cpu)
    print(f"stream N={STREAM_SMALL_N}: card route objective {card['route']['objective']:.6f}, "
          f"plain path {cpu['route']['objective']:.6f}, rebalance "
          f"{card['rebalance']['objective']:.6f} / {cpu['rebalance']['objective']:.6f}, "
          f"admissions {[g[0] for g in card['admit']]}; mismatches {mismatches}", flush=True)
    if mismatches:
        raise AssertionError(f"stream: the card's N={STREAM_SMALL_N} script disagrees with the "
                             f"plain path: {mismatches}")
    launches = {k: sum(c.get(k, 0) for c in counts.values()) for k in ops.launch_counts}
    print(f"stream: phase 3k took {time.perf_counter() - t_phase:.4f} s; seconds by part "
          f"{ {k: round(v, 4) for k, v in times.items()} }", flush=True)
    return {"times": times, "launches": launches, "profile": prof}


def compress_work(n: int, g_bytes: int) -> dict:
    """(bytes, f32 operations) each compression kernel needs for a leaf of
    n elements: inputs read once, outputs written once (the int8 payload
    padded to whole blocks of 128)."""
    nb = -(-n // 128)
    return {"compress_int8": (n * (g_bytes + 4) + nb * 128 + nb * 4 + n * 4, 9 * n),
            "compress_bf16": (n * (g_bytes + 4) + n * 2 + n * 4, 3 * n),
            "decompress_int8": (nb * 128 + nb * 4 + n * 4, n)}


def check_compress(label, g, e, record, *, timed=False) -> dict:
    """The three compression kernels against their plain versions on the
    card inputs (g, e), bit for bit, NaN as NaN (the compare launches are
    not counted); with ``timed``, each beside its plain version, its bytes
    bound and a library call: for compress_bf16 ``.to(torch.bfloat16)`` of
    gf alone, for decompress_int8 ``torch.mul(q, scale)`` (cut to n)."""
    import torch
    from repro_torch.kernels import compress as K
    from repro_torch.kernels import ref as R

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _bits import same_bits

    shape = tuple(g.shape)
    q, scale, err = K.compress_int8_cuda(g, e)
    runs = {"compress_int8": ((q, scale, err), R.compress_int8_ref(g, e)),
            "compress_bf16": (K.compress_bf16_cuda(g, e), R.compress_bf16_ref(g, e)),
            "decompress_int8": ((K.decompress_int8_cuda(q, scale, shape),),
                                (R.decompress_int8_ref(q, scale, shape),))}
    torch.cuda.synchronize()
    errs = {}
    for name, (got, want) in runs.items():
        errs[name] = 0.0
        for a, b in zip(got, want):
            same, diff = same_bits(a, b)
            errs[name] = max(errs[name], diff)
            if not same:
                raise AssertionError(f"{name} {label}: not bit for bit its plain version "
                                     f"(max abs err {diff:.3e})")
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], errs[name])
    nan = int(torch.isnan(err).sum())
    print(f"compress       {label:>24}: n={g.numel()} {str(g.dtype)[6:]}, all three kernels bit "
          f"for bit their plain versions (NaN residuals {nan}), max abs err "
          f"{max(errs.values()):.1e}", flush=True)
    if not timed:
        return {}
    gf = g.float() + e
    n = g.numel()

    def mul():                      # the whole function in one library launch
        return torch.mul(q, scale).view(-1)[:n].view(shape)

    same, _ = same_bits(mul(), K.decompress_int8_cuda(q, scale, shape))
    fns = {"compress_int8": (lambda: K.compress_int8_cuda(g, e),
                             lambda: R.compress_int8_ref(g, e), None),
           "compress_bf16": (lambda: K.compress_bf16_cuda(g, e),
                             lambda: R.compress_bf16_ref(g, e),
                             (lambda: gf.to(torch.bfloat16),
                              ".to(bfloat16) of gf alone (the payload only)")),
           "decompress_int8": (lambda: K.decompress_int8_cuda(q, scale, shape),
                               lambda: R.decompress_int8_ref(q, scale, shape),
                               (mul, f"torch.mul(q, scale) (bit for bit the kernel: {same})"))}
    times = {}
    for name, (kern, plain, library) in fns.items():
        nbytes, nops = compress_work(n, g.element_size())[name]
        b_ms, by = bound_ms(nbytes, nops)
        t = {"ms": time_ms(kern), "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": by,
             "library_ms": time_ms(library[0]) if library is not None else None,
             "bytes": nbytes}
        times[name] = t
        lib = (f", {library[1]} {t['library_ms']:.4f} ms ({t['ms'] / t['library_ms']:.3f}x "
               "its time)" if library is not None else "")
        print(f"  {name} {label}: {t['ms']:.4f} ms a launch ({nbytes / t['ms'] / 1e6:.1f} GB/s), "
              f"bound {b_ms:.4f} ms ({by}, {b_ms / t['ms']:.3f} of it), plain "
              f"{t['plain_ms']:.4f} ms{lib}", flush=True)
    return times


def compress_steps(comp, params, draw, dev) -> dict:
    """``COMPRESS_STEPS`` steps of ``comp`` over a gradient tree shaped as
    ``params`` (a fresh draw a step) with error feedback: each step's
    compress and decompress timed (host clock after a sync) with the
    launch counts zeroed just before and read just after; then every leaf's
    payload, residual and decompressed value held bit for bit to the plain
    versions on the same inputs (not counted)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _bits import same_bits

    mode, leaves = comp.mode, len(params)
    kernel = "compress_int8" if mode == "int8" else "compress_bf16"
    grads = draw()
    state = comp.init_state(grads)
    n = sum(p.numel() for p in params.values())
    formula = {"bf16": 2 * n, "int8": n + 4 * (n // 128 + 1)}[mode]
    if comp.wire_bytes(grads) != formula:
        raise AssertionError(f"{mode} wire_bytes {comp.wire_bytes(grads)} != {formula}")
    nbytes = sum(compress_work(p.numel(), 2)[kernel][0] for p in params.values())
    dbytes = sum(compress_work(p.numel(), 2)["decompress_int8"][0] for p in params.values())
    launches = {"compress_int8": 0, "compress_bf16": 0, "decompress_int8": 0}
    steps = []
    for step in range(COMPRESS_STEPS):
        if step:
            grads = draw()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        payload, new_state = comp.compress(grads, state)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dec = comp.decompress(payload)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = {k: ops.launch_counts[k] for k in launches}
        want = {kernel: leaves, "decompress_int8": leaves if mode == "int8" else 0}
        for k, v in counts.items():
            if v != want.get(k, 0):
                raise AssertionError(f"{mode} step {step}: {k} launched {v} times, expected "
                                     f"{want.get(k, 0)} (one a leaf)")
            launches[k] += v
        for k, g in grads.items():
            if mode == "int8":
                q, scale, err = R.compress_int8_ref(g, state[k])
                pairs = ((payload[k]["q"], q), (payload[k]["scale"], scale),
                         (new_state[k], err),
                         (dec[k], R.decompress_int8_ref(q, scale, tuple(g.shape))))
            else:
                c, err = R.compress_bf16_ref(g, state[k])
                pairs = ((payload[k], c), (new_state[k], err), (dec[k], c.float()))
            for a, b in pairs:
                if not same_bits(a, b)[0]:
                    raise AssertionError(f"{mode} step {step} leaf {k}: the card's compression "
                                         "is not bit for bit the plain version's")
        state = new_state
        steps.append({"compress_s": t1 - t0, "decompress_s": t2 - t1})
    for i, st in enumerate(steps):
        print(f"  GradCompressor({mode!r}) step {i}: compress {st['compress_s'] * 1e3:.3f} ms "
              f"({nbytes / st['compress_s'] / 1e9:.1f} GB/s over {nbytes / 1e9:.3f} GB), "
              f"decompress {st['decompress_s'] * 1e3:.3f} ms"
              + (f" ({dbytes / st['decompress_s'] / 1e9:.1f} GB/s)" if mode == "int8" else
                 " (a dtype cast a leaf)"), flush=True)
    print(f"  GradCompressor({mode!r}): {COMPRESS_STEPS} steps x {leaves} leaves, every leaf's "
          f"payload, residual and decompressed value bit for bit the plain versions', "
          f"wire_bytes {comp.wire_bytes(grads)} (the formula), launches {launches}", flush=True)
    return {"steps": steps, "launches": launches, "state": state, "bytes": nbytes}


def tree_nbytes(tree) -> int:
    from repro_torch.distributed import tree as PT

    return sum(x.numel() * x.element_size() for x in PT.leaves(tree))


def assert_trees_equal(got, want, label: str) -> None:
    import torch
    from repro_torch.distributed import tree as PT

    gl, wl = PT.leaves(got), PT.leaves(want)
    if len(gl) != len(wl):
        raise AssertionError(f"{label}: {len(gl)} leaves, expected {len(wl)}")
    for a, b in zip(gl, wl):
        if not (a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)):
            raise AssertionError(f"{label}: a leaf differs ({a.dtype} {a.device} against "
                                 f"{b.dtype} {b.device})")


def checkpoint_run(train_state, comp_state, draw, dev) -> dict:
    """6c and 6e: a blocking save from the card, a save with blocking=False
    while the int8 compressor runs, a restore onto the card, two more saves
    (keep=3 leaves three) beside a torn .tmp directory, then ``Recovery``
    with a one-device mesh; in a temporary directory that is removed."""
    import shutil
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from repro_torch.distributed import CheckpointManager, GradCompressor, Recovery
    from repro_torch.distributed.sharding import Mesh

    total = tree_nbytes(train_state)
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {"bytes": total}
    try:
        free = shutil.disk_usage(root).free
        need = (CKPT_KEEP + 1) * total
        print(f"checkpoint: {root}, {free / 1e9:.2f} GB free; the train state {total / 1e9:.3f} "
              f"GB in {len(train_state['params'])} + {2 * len(train_state['opt']['m'])} + "
              f"{len(train_state['compress_err'])} + 2 leaves; {CKPT_KEEP} kept + 1 being "
              f"written need {need / 1e9:.2f} GB", flush=True)
        if free < need:
            raise AssertionError(f"the temporary directory has {free / 1e9:.2f} GB free, the "
                                 f"checkpoints need {need / 1e9:.2f} GB")
        mgr = CheckpointManager(root, keep=CKPT_KEEP)
        torch.cuda.synchronize()
        t = time.perf_counter()
        mgr.save(1, train_state)
        out["save_s"] = time.perf_counter() - t
        grads = draw()
        comp = GradCompressor("int8")
        state = comp_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mgr.save(2, train_state, blocking=False)
        out["async_held_s"] = time.perf_counter() - t0
        t = time.perf_counter()
        for _ in range(COMPRESS_STEPS):
            _, state = comp.compress(grads, state)
        torch.cuda.synchronize()
        out["async_compress_s"] = time.perf_counter() - t
        t = time.perf_counter()
        mgr.wait()
        out["async_wait_s"] = time.perf_counter() - t
        out["async_total_s"] = time.perf_counter() - t0
        del grads, state
        torch.cuda.synchronize()
        t = time.perf_counter()
        restored, step = mgr.restore(train_state)
        torch.cuda.synchronize()
        out["restore_s"] = time.perf_counter() - t
        if step != 2:
            raise AssertionError(f"restored step {step}, expected 2")
        assert_trees_equal(restored, train_state, "restore")
        del restored
        t = time.perf_counter()
        for s in (3, 4):
            mgr.save(s, train_state)
        out["save_3_4_s"] = time.perf_counter() - t
        torn = Path(root) / "step_00000005.tmp"
        torn.mkdir()
        (torn / "shard_00000.msgpack").write_bytes(b"\x81")
        kept = mgr.all_steps()
        on_disk = sorted(p.name for p in Path(root).iterdir())
        if kept != [2, 3, 4] or mgr.latest_step() != 4:
            raise AssertionError(f"keep={CKPT_KEEP} after 4 saves left {kept} ({on_disk})")
        mesh = Mesh(np.array([[dev]], dtype=object), ("data", "model"))
        seen = []
        rec = Recovery(mgr, rebuild_mesh=lambda: mesh, on_rebalance=seen.append)
        torch.cuda.synchronize()
        t = time.perf_counter()
        state_r, step_r, mesh_r = rec.recover(train_state)
        torch.cuda.synchronize()
        out["recover_s"] = time.perf_counter() - t
        if not (step_r == 4 and mesh_r is mesh and seen == [mesh]):
            raise AssertionError(f"Recovery gave step {step_r}, mesh {mesh_r}, on_rebalance saw "
                                 f"{seen}")
        assert_trees_equal(state_r, train_state, "Recovery")
        del state_r
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gb = total / 1e9
    print(f"checkpoint: blocking save {out['save_s']:.4f} s ({gb / out['save_s']:.3f} GB/s); "
          f"async save held the caller {out['async_held_s']:.4f} s, {COMPRESS_STEPS} int8 "
          f"compress steps meanwhile {out['async_compress_s']:.4f} s, wait "
          f"{out['async_wait_s']:.4f} s ({out['async_total_s']:.4f} s from save to the end of "
          f"wait); restore onto the card {out['restore_s']:.4f} s ({gb / out['restore_s']:.3f} "
          f"GB/s), leaf for leaf equal; saves 3 and 4 {out['save_3_4_s']:.4f} s; keep="
          f"{CKPT_KEEP} left steps {kept} beside {torn.name} ({on_disk}); Recovery restored step "
          f"{step_r} in {out['recover_s']:.4f} s, leaf for leaf equal, on_rebalance saw the "
          f"one-device mesh {mesh.shape}", flush=True)
    return out


def batch_digest(batches) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for b in batches:
        for k in ("tokens", "targets"):
            h.update(np.ascontiguousarray(b[k]).tobytes())
    return h.hexdigest()[:16]


def stream_run(case: dict, dev) -> dict:
    """6d: a ``Prefetcher`` over ``StreamConfig(**case)`` for STREAM_STEPS
    steps, each batch copied to the card (pinned, non-blocking); the
    digest of steps 0-3 as they came back from the card against the same
    batches made on the CPU in this run."""
    import numpy as np
    import torch
    from repro_torch.streams import Prefetcher, StreamConfig, TokenStream

    cfg = StreamConfig(**case)
    pf = Prefetcher(TokenStream(cfg))
    waits, copies, back = [], [], []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STREAM_STEPS):
            t = time.perf_counter()
            batch = next(pf)
            waits.append(time.perf_counter() - t)
            if batch["_step"] != i:
                raise AssertionError(f"the prefetcher gave step {batch['_step']} at {i}")
            host = [torch.from_numpy(np.ascontiguousarray(batch[k])).pin_memory()
                    for k in ("tokens", "targets")]
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            on_card = [h.to(dev, non_blocking=True) for h in host]
            end.record()
            end.synchronize()
            copies.append(start.elapsed_time(end))
            if i < 4:
                back.append({k: v.cpu().numpy() for k, v in zip(("tokens", "targets"), on_card)})
        wall = time.perf_counter() - t0
    finally:
        pf.close()
    stream = TokenStream(cfg)
    cpu = batch_digest(stream.batch(i) for i in range(4))
    card = batch_digest(back)
    if card != cpu:
        raise AssertionError(f"steps 0-3 from the card {card} != the CPU's {cpu}")
    tokens = cfg.global_batch * cfg.seq_len
    out = {"batches_per_s": pf.stats.produced / wall, "tokens_per_s": STREAM_STEPS * tokens / wall,
           "copy_ms": float(np.median(copies)), "wait_ms": float(np.median(waits)) * 1e3,
           "wait_max_ms": max(waits) * 1e3, "wall_s": wall, "digest": card}
    print(f"stream {cfg.global_batch} x {cfg.seq_len} (vocab {cfg.vocab_size}, "
          f"{cfg.num_partitions} partitions, prefetch {cfg.prefetch}): {STREAM_STEPS} steps in "
          f"{wall:.4f} s, produced {pf.stats.produced} ({out['batches_per_s']:.2f} batches/s), "
          f"{out['tokens_per_s']:.0f} tokens/s, host-to-card copy {out['copy_ms']:.4f} ms a "
          f"batch (median), consumer wait {out['wait_ms']:.4f} ms a batch (median; max "
          f"{out['wait_max_ms']:.4f}), stalls {pf.stats.stalls}, dropped {pf.stats.dropped}; "
          f"steps 0-3 digest {card}, the CPU's the same", flush=True)
    return out


def stream_backpressure() -> dict:
    """6d: a slow consumer (the producer stalls, keeps its batch, skips and
    repeats nothing) and a wedged one (``BackpressureError``)."""
    from repro_torch.streams import BackpressureError, Prefetcher, StreamConfig, TokenStream

    base = dict(STREAM_CASES[1], prefetch=1)
    pf = Prefetcher(TokenStream(StreamConfig(**base, stall_timeout_s=0.02, max_stalls=10_000)))
    try:
        steps = []
        for _ in range(5):
            time.sleep(0.1)
            steps.append(next(pf)["_step"])
    finally:
        pf.close()
    slow = pf.stats
    if steps != [0, 1, 2, 3, 4] or slow.stalls < 3 or slow.dropped != slow.produced - 5:
        raise AssertionError(f"slow consumer: steps {steps}, stats {slow}")
    pf = Prefetcher(TokenStream(StreamConfig(**base, stall_timeout_s=0.01, max_stalls=3)))
    try:
        deadline = time.monotonic() + 10.0
        while pf._error is None and time.monotonic() < deadline:
            time.sleep(0.01)
        try:
            next(pf)
        except BackpressureError as e:
            raised = str(e)
        else:
            raise AssertionError("a wedged consumer got no BackpressureError")
    finally:
        pf.close()
    print(f"stream backpressure: a consumer 0.1 s a batch took steps {steps} with {slow.stalls} "
          f"stalls (longest run {slow.max_stall_run}), {slow.dropped} dropped at close; a wedged "
          f"one raised BackpressureError({raised!r})", flush=True)
    return {"slow": slow, "wedged": raised}


def feeders_phase(dev, record) -> dict:
    """Phase 6: the training feeders at smollm-360m's full width."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import GradCompressor
    from repro_torch.kernels import ops
    from repro_torch.kernels.compress import compress_edge_cases
    from repro_torch.models import build_model

    cfg = get_config(FEEDER_ARCH)
    t = time.perf_counter()
    model = build_model(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(FEEDER_SEED))
    torch.cuda.synchronize()
    params = {k: p.detach() for k, p in model.named_parameters()}
    n_params = sum(p.numel() for p in params.values())
    print(f"feeders: {FEEDER_ARCH} at its published widths in {time.perf_counter() - t:.2f} s, "
          f"{len(params)} parameter leaves, {n_params} elements, dtypes "
          f"{sorted({str(p.dtype) for p in params.values()})}", flush=True)
    if params["embed"].dtype != torch.bfloat16:
        raise AssertionError(f"{FEEDER_ARCH}'s weights are not bf16")
    gen = torch.Generator(device=dev).manual_seed(FEEDER_SEED + 1)

    def draw():
        return {k: (torch.randn(p.shape, generator=gen, device=dev) * 1e-2).to(torch.bfloat16)
                for k, p in params.items()}

    # -- 6a. the compression kernels against their plain versions ---------------
    for dtype in (torch.bfloat16, torch.float32):
        for name, (g, e) in sorted(compress_edge_cases(FEEDER_SEED).items()):
            check_compress(name, torch.as_tensor(g, device=dev).to(dtype),
                           torch.as_tensor(e, device=dev), record)
    embed = params["embed"]
    g_embed = (torch.randn(embed.shape, generator=gen, device=dev) * 1e-2).to(torch.bfloat16)
    e_embed = torch.randn(embed.shape, generator=gen, device=dev) * 1e-5
    times = check_compress(f"embed {tuple(embed.shape)}", g_embed, e_embed, record, timed=True)
    check_compress(f"embed {tuple(embed.shape)}", g_embed.float(), e_embed, record)
    del g_embed, e_embed

    # -- 6b. GradCompressor over the whole gradient tree ------------------------
    runs = {mode: compress_steps(GradCompressor(mode), params, draw, dev)
            for mode in ("bf16", "int8")}
    launches = {k: runs["bf16"]["launches"][k] + runs["int8"]["launches"][k]
                for k in runs["int8"]["launches"]}

    # -- 6c. CheckpointManager, 6e. Recovery --------------------------------------
    train_state = {
        "params": params,
        "opt": {"count": torch.tensor(COMPRESS_STEPS, dtype=torch.int32, device=dev),
                "m": {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-3
                      for k, p in params.items()},
                "v": {k: torch.rand(p.shape, generator=gen, device=dev) * 1e-6
                      for k, p in params.items()}},
        "step": torch.tensor(COMPRESS_STEPS, dtype=torch.int32, device=dev),
        "compress_err": runs["int8"]["state"]}
    ckpt = checkpoint_run(train_state, runs["int8"]["state"], draw, dev)
    del train_state
    torch.cuda.empty_cache()

    # -- 6d. the token pipeline -----------------------------------------------------
    streams = [stream_run(case, dev) for case in STREAM_CASES]
    backpressure = stream_backpressure()

    # -- 6f. attn_batch_shard on one card -------------------------------------------
    flagged = build_model(dataclasses.replace(cfg, attn_batch_shard=True), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(FEEDER_SEED))
    for (k, a), b in zip(model.named_parameters(), flagged.parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"the flagged model drew other weights ({k})")
    B, S = ATTN_SHARD_SHAPE
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    logits, flash = [], []
    for m in (model, flagged):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with torch.no_grad():
            logits.append(m.forward_train({"tokens": toks})[0])
        torch.cuda.synchronize()
        flash.append(ops.launch_counts["flash_attention"])
    if not (torch.equal(logits[0], logits[1]) and flash[0] == flash[1] == cfg.num_layers):
        raise AssertionError(f"attn_batch_shard: logits equal {torch.equal(*logits)}, "
                             f"flash_attention launches {flash}")
    print(f"attn_batch_shard on one card: forward_train B={B}, S={S}: logits "
          f"{tuple(logits[0].shape)} bit for bit those without the flag, finite "
          f"{bool(torch.isfinite(logits[0]).all())}, flash_attention launched {flash[1]} times "
          f"(without the flag {flash[0]})", flush=True)
    return {"times": times, "launches": launches, "runs": runs, "checkpoint": ckpt,
            "streams": streams, "backpressure": backpressure}


def host_gumbel(sweep: int, size: int, device):
    """Gumbel noise drawn on the host with numpy (one seed a sweep), for the
    sampled solve's ``gumbel_fn``."""
    import numpy as np
    import torch

    noise = np.random.default_rng(sweep).gumbel(size=size).astype(np.float32)
    return torch.as_tensor(noise, device=device)


def assignment_digest(x) -> str:
    """A short hash of an assignment's i32 values, to compare mappings
    across runs and trees."""
    import hashlib

    import numpy as np

    return hashlib.sha256(x.cpu().numpy().astype(np.int32).tobytes()).hexdigest()[:16]


def probe(src: str) -> int:
    """``--probe SRC``: the balancing slice of the ``repro_torch`` package
    under SRC (this tree's ``src``, or a ``git archive`` of another commit's),
    so that two trees are compared on one card in one call.  Prints one JSON
    line: the fused sweep's whole call at the main path's input (from the
    solver's arguments to (score, tier), with the totals where the wrapper
    takes them) and its kernel alone, the same two for the full sweep
    (``move_eval``), two N=100,000 passes (wall-clock, solve_s, pack_s, rounds,
    sweeps, objective and mapping digest), the pack kernel on the last
    proposal, and the rounding kernel (its wrapper, from the solver's
    arguments) on the main path's P (the tree's own ``_optimize``, 256 Adam
    steps) and on every ``round_case`` kind at (131,072, 5, 2)."""
    sys.path.insert(0, os.path.abspath(src))
    import inspect

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --probe: needs a card", file=sys.stderr)
        return 2
    from repro_torch.core import CoopConfig, Sptlb, generate_cluster, pad_problem
    from repro_torch.core.hierarchy import HostScheduler
    from repro_torch.core.problem import tier_loads
    from repro_torch.kernels import move_eval as K
    from repro_torch.kernels.pack import pack_ffd_tiers_cuda

    dev = torch.device("cuda", torch.cuda.current_device())
    cluster = generate_cluster(num_apps=100_000, seed=1, device=dev)
    pp = pad_problem(cluster.problem)
    util, tasks = tier_loads(pp, pp.assignment0)
    args = (pp.demand, pp.tasks, pp.criticality, pp.assignment0, pp.assignment0, pp.capacity,
            pp.task_limit, pp.ideal_frac, pp.ideal_task_frac, util, tasks, pp.weights.vector(),
            pp.feasible_mask().contiguous(),
            torch.tensor(int(pp.move_budget), dtype=torch.int32, device=dev))
    kw = {}
    if "totals" in inspect.signature(K.move_eval_best_cuda).parameters:
        kw["totals"] = torch.stack([torch.clamp(torch.sum(pp.tasks), min=1.0),
                                    torch.clamp(torch.sum(pp.criticality), min=1.0)])
    sweep_ms = time_ms(lambda: K.move_eval_best_cuda(*args, **kw))
    kernel_ms = None                       # the kernel alone, where the tree splits it out
    if hasattr(K, "best_inputs"):
        best_in = K.best_inputs(*args, **kw)
        kernel_ms = time_ms(lambda: K.launch_move_eval_best(best_in))
    # The full sweep: its whole call (with the totals where the wrapper takes
    # them) and its kernel alone, on either tree's split (eval_inputs, or
    # the older prepare_launch).
    kw_e = kw if "totals" in inspect.signature(K.move_eval_cuda).parameters else {}
    eval_ms = time_ms(lambda: K.move_eval_cuda(*args[:12], **kw_e))
    if hasattr(K, "eval_inputs"):
        eval_in = K.eval_inputs(*args[:12], **kw_e)
    else:
        eval_in = K.prepare_launch(*args[:12])
    eval_kernel_ms = time_ms(lambda: K.launch_move_eval(eval_in))
    passes = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        d = Sptlb(cluster, device=dev).balance("local", timeout_s=30, config=CoopConfig())
        torch.cuda.synchronize()
        tm = d.cooperation.timings
        passes.append({"wall_s": time.perf_counter() - t, "solve_s": tm["solve_s"],
                       "pack_s": tm["pack_s"], "rounds": tm["rounds"],
                       "sweeps": d.solve.extra["sweeps"], "objective": d.solve.objective,
                       "ok": bool(d.violations.ok), "digest": assignment_digest(d.assignment)})
    host = HostScheduler(cluster, device=dev)
    x_np = d.assignment.cpu().numpy().astype(np.int64)
    x0_np = cluster.problem.assignment0.cpu().numpy().astype(np.int64)
    dem, _ = host.pack_inputs(x_np, x0_np, np.where(x_np != x0_np)[0], np.empty(0, np.int64))
    dd, cc = torch.as_tensor(dem, device=dev), torch.as_tensor(cluster.host_capacity, device=dev)
    hh = torch.as_tensor(cluster.hosts_per_tier.astype(np.int32), device=dev)
    pack_ms = time_ms(lambda: pack_ffd_tiers_cuda(dd, cc, hh, num_hosts_pad=host._hosts_pad))
    round_ms = probe_round(pp, dev)
    print(json.dumps({"probe": src, "card": card_line(), "sweep_whole_call_ms": sweep_ms,
                      "sweep_totals_given": bool(kw), "sweep_kernel_ms": kernel_ms,
                      "eval_whole_call_ms": eval_ms, "eval_totals_given": bool(kw_e),
                      "eval_kernel_ms": eval_kernel_ms,
                      "pack_ms": pack_ms, "passes": passes, "round_ms": round_ms}), flush=True)
    return 0


# ``--flash-probe``'s cases: the flash kernels at the serving phases' equal
# head dims, (name, (B, S, H, KV, D), dtype, keyword arguments) for the
# prefill and (name, (B, Smax, H, KV, D), dtype, kv_len, keyword arguments)
# for the decode: both bodies of each kernel, a window and a softcap.
FLASH_PROBE_PREFILL = (
    ("qwen", (8, 1019, 16, 2, 128), "bfloat16", {}),
    ("granite", (8, 1019, 16, 8, 64), "bfloat16", {}),
    ("zamba2", (8, 1019, 32, 32, 80), "bfloat16", {}),
    ("gemma2", (2, 1024, 16, 8, 256), "bfloat16", {"window": 512, "softcap": 50.0}),
    ("simt f32", (2, 333, 15, 5, 64), "float32", {}),
    ("simt f32 D=256", (2, 129, 4, 2, 256), "float32", {}),
    ("simt bf16 D=72", (2, 129, 4, 2, 72), "bfloat16", {"window": 37}))
FLASH_PROBE_DECODE = (
    ("qwen", (8, 1064, 16, 2, 128), "bfloat16", 1050, {}),
    ("granite", (8, 1064, 16, 8, 64), "bfloat16", 1050, {}),
    ("zamba2", (8, 1064, 32, 32, 80), "bfloat16", 1050, {}),
    ("gemma2", (8, 8192, 16, 8, 256), "bfloat16", 8000, {"window": 4096, "softcap": 50.0}),
    ("qwen f32", (8, 1064, 16, 2, 128), "float32", 1050, {}))


def flash_probe(src: str) -> int:
    """``--flash-probe SRC``: the flash kernels of the ``repro_torch``
    package under SRC at ``FLASH_PROBE_PREFILL`` and ``FLASH_PROBE_DECODE``
    (inputs drawn from fixed CPU seeds), so that two trees are compared on
    one card in one call.  Prints one JSON line: per case the median ms a
    launch (``time_ms``) and a digest of the output's bytes, equal between
    two trees exactly when their outputs are bit for bit equal."""
    sys.path.insert(0, os.path.abspath(src))
    import hashlib

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke --flash-probe: needs a card", file=sys.stderr)
        return 2
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_decode import flash_decode_cuda

    dev = torch.device("cuda", torch.cuda.current_device())

    def normal(shape, dtype, seed):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g).to(getattr(torch, dtype)).to(dev)

    def entry(fn):
        y = fn()
        digest = hashlib.sha256(y.cpu().contiguous().view(torch.uint8).numpy().tobytes())
        return {"ms": time_ms(fn), "digest": digest.hexdigest()[:16]}

    out = {}
    for i, (name, (B, S, H, KV, D), dtype, kw) in enumerate(FLASH_PROBE_PREFILL):
        q, k, v = (normal(shape, dtype, 10 * i + j)
                   for j, shape in enumerate(((B, S, H, D), (B, S, KV, D), (B, S, KV, D))))
        out[f"prefill {name}"] = entry(lambda: flash_attention_cuda(q, k, v, **kw))
    for i, (name, (B, S, H, KV, D), dtype, n, kw) in enumerate(FLASH_PROBE_DECODE):
        q, k, v = (normal(shape, dtype, 100 + 10 * i + j)
                   for j, shape in enumerate(((B, 1, H, D), (B, S, KV, D), (B, S, KV, D))))
        kv_len = torch.tensor(n, dtype=torch.int32, device=dev)
        out[f"decode {name}"] = entry(lambda: flash_decode_cuda(q, k, v, kv_len, **kw))
    print(json.dumps({"src": src, "card": card_line(), "flash": out}), flush=True)
    return 0


def probe_round(pp, dev) -> dict:
    """``--probe``'s rounding times: the kernel's wrapper on fresh copies of
    x and the loads, at the main path's P and at every kind of
    ``round_case`` at (131,072, 5, 2), with each status; and the host ms a
    step of the ``_optimize`` that made P (after a synchronisation)."""
    import torch
    from repro_torch.core import OptimalSearchConfig
    from repro_torch.core.solver_optimal import _optimize, round_inputs, start_noise
    from repro_torch.kernels.optimal_round import ROUND_KINDS, optimal_round_cuda, round_case

    cfg = OptimalSearchConfig(steps=OPTIMAL_STEPS, seed=0)
    noise = start_noise(pp, cfg.seed)
    torch.cuda.synchronize()
    t = time.perf_counter()
    probs = _optimize(pp, noise, steps=cfg.steps, lr=cfg.lr, penalty=cfg.penalty,
                      entropy=cfg.entropy)
    torch.cuda.synchronize()
    optimize_ms = (time.perf_counter() - t) / cfg.steps * 1e3
    cases = {"main": round_inputs(pp, probs)}
    N, T, R = ROUND_SHAPES[0]
    for kind in ROUND_KINDS:
        cases[kind] = round_case(N, T, R, kind, seed=N + T + R, device=dev)
    out = {}
    for name, args in cases.items():
        pool = [(args[2].clone(), args[3].clone(), args[4].clone()) for _ in range(24)]
        status = optimal_round_cuda(*args[:2], *pool.pop(), *args[5:]).tolist()
        ms = time_ms(lambda: optimal_round_cuda(*args[:2], *pool.pop(), *args[5:]))
        out[name] = {"ms": ms, "status": status}
    out["optimize_ms_a_step"] = optimize_ms
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a card",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core import (CoopConfig, LocalSearchConfig, Sptlb, generate_cluster,
                                  objective, pad_problem, solve_local, validate)
    from repro_torch.core.delta import move_delta_cost
    from repro_torch.core.problem import tier_loads
    from repro_torch.core.hierarchy import HostScheduler
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.pack import pack_edge_cases

    dev = torch.device("cuda", torch.cuda.current_device())
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"card: {card}", flush=True)

    # -- 1. build -------------------------------------------------------------
    build_s = build.build_all()
    print(f"build: {build_s:.2f} s for {sorted(build.SIGNATURES)} (nvcc, sm_90a, in parallel)",
          flush=True)
    for name, log in sorted(build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)

    record = {"move_eval": {"max_abs_err": 0.0},
              "move_eval_best": {"max_abs_err": 0.0, "ties": 0},
              "commit_topk": {"max_abs_err": 0.0},
              "pack_ffd_tiers": {"max_abs_err": 0.0},
              "flash_attention": {"max_abs_err": 0.0},
              "flash_decode": {"max_abs_err": 0.0},
              "ssd_chunk": {"max_abs_err": 0.0},
              "optimal_round": {"max_abs_err": 0.0},
              "move_eval_best_batched": {"max_abs_err": 0.0},
              "commit_topk_batched": {"max_abs_err": 0.0},
              "tier_stats": {"max_abs_err": 0.0},
              "tier_mean": {"max_abs_err": 0.0},
              "compress_int8": {"max_abs_err": 0.0},
              "compress_bf16": {"max_abs_err": 0.0},
              "decompress_int8": {"max_abs_err": 0.0},
              "moe_dispatch": {"max_abs_err": 0.0},
              "moe_combine": {"max_abs_err": 0.0},
              "mlstm_scan": {"max_abs_err": 0.0},
              "slstm_scan": {"max_abs_err": 0.0}}

    # -- 2a. sweep kernels at the stated shapes --------------------------------
    for N, T in ((300, 5), (500, 17), (100_000, 5), (100_000, 128)):
        args, feas = random_sweep(N, T, dev, scale_capacity=N >= 10_000)
        inputs = check_sweep(f"N={N},T={T}", args, feas, (0, 5), record, dev)
        for ml in (0, 5):
            check_commit(f"N={N},T={T},ml={ml}", args, feas, ml, record, dev)
        if N >= 10_000:
            print_sweep_times(f"N={N} T={T}", time_sweep(args, feas, inputs, dev))

    # -- 2b. the main path's own sweep input ------------------------------------
    t = time.perf_counter()
    cluster = generate_cluster(num_apps=100_000, seed=1, device=dev)
    gen_s = time.perf_counter() - t
    p = cluster.problem
    pp = pad_problem(p)
    x = pp.assignment0
    util, tasks = tier_loads(pp, x)
    main_args = (pp.demand, pp.tasks, pp.criticality, x, pp.assignment0, pp.capacity,
                 pp.task_limit, pp.ideal_frac, pp.ideal_task_frac, util, tasks,
                 pp.weights.vector())
    main_feas = pp.feasible_mask().contiguous()
    Nm, Tm = pp.num_apps, pp.num_tiers
    inputs = check_sweep(f"cluster N={Nm},T={Tm}", main_args, main_feas,
                         (int(pp.move_budget),), record, dev)
    main_sweep = time_sweep(main_args, main_feas, inputs, dev)
    main_commit = check_commit(f"cluster N={Nm},T={Tm}", main_args, main_feas,
                               int(pp.move_budget), record, dev)
    print_sweep_times(f"main path N={Nm} T={Tm}", main_sweep)
    differ, total, sums = scalar_division_check(main_args)
    print(f"  the plain version's / T on the card (a reciprocal multiply) against the kernels' "
          f"division: {differ} of {total} quotients differ, {sums} sums mean + d_mean differ",
          flush=True)
    # The whole fused call, as the solver makes it, under the profiler: what
    # it launches on the card (no cat or stack of an [N, .] row).
    from repro_torch.kernels import move_eval as K
    ml_main = torch.tensor(int(pp.move_budget), dtype=torch.int32, device=dev)
    totals_main = K.sweep_totals(pp.tasks, pp.criticality)
    call = device_profile(lambda: K.move_eval_best_cuda(*main_args, main_feas, ml_main,
                                                        totals=totals_main))
    names = {kernel_label(n, 60): c for n, c in call["counts"].items()}
    print(f"  move_eval_best whole call: {sum(call['counts'].values())} kernel launches on the "
          f"card: {names}", flush=True)
    if any("cat" in n.lower() or "stack" in n.lower() for n in call["counts"]):
        raise AssertionError(f"the fused sweep launched a cat or stack: {names}")
    if sum(call["counts"].values()) > SWEEP_CALL_MAX_LAUNCHES:
        raise AssertionError(f"the fused sweep's whole call launched more than "
                             f"{SWEEP_CALL_MAX_LAUNCHES} kernels: {names}")
    # The same for the full sweep, as the sampled solve makes it.
    call = device_profile(lambda: K.move_eval_cuda(*main_args, totals=totals_main))
    names = {kernel_label(n, 60): c for n, c in call["counts"].items()}
    print(f"  move_eval whole call: {sum(call['counts'].values())} kernel launches on the "
          f"card: {names}", flush=True)
    if any("cat" in n.lower() or "stack" in n.lower() for n in call["counts"]):
        raise AssertionError(f"the full sweep launched a cat or stack: {names}")
    if sum(call["counts"].values()) > SWEEP_CALL_MAX_LAUNCHES:
        raise AssertionError(f"the full sweep's whole call launched more than "
                             f"{SWEEP_CALL_MAX_LAUNCHES} kernels: {names}")

    # -- 2c. pack on random demand and at the kernel's edges --------------------
    clock = sm_clock_mhz()
    rng = np.random.default_rng(7)
    for M in (128, 4096):
        T = 5
        dem = rng.lognormal(0.0, 1.0, size=(T, M, 2)).astype(np.float32)
        order = np.argsort(-dem.max(axis=2), axis=1, kind="stable")
        dem = np.take_along_axis(dem, order[:, :, None], axis=1)
        hosts = rng.integers(40, 120, size=T).astype(np.int32)
        capacity = (dem.sum(axis=(0, 1)) / (0.9 * hosts.sum())).astype(np.float32)
        check_pack(f"random M={M}", dem, capacity, hosts, 128, record, dev, clock_mhz=clock)
    for name, (dem, capacity, hosts, pad) in sorted(pack_edge_cases().items()):
        check_pack(name, dem, capacity, hosts, pad, record, dev, clock_mhz=clock, timed=False)

    # -- 3. the slice -----------------------------------------------------------
    obj0 = float(objective(p, p.assignment0))
    sptlb = Sptlb(cluster, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    decision = sptlb.balance("local", timeout_s=30, config=CoopConfig())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.launch_counts)
    peak = torch.cuda.max_memory_allocated()

    xa = decision.assignment
    if tuple(xa.shape) != (p.num_apps,) or xa.dtype != torch.int32 or not xa.is_cuda:
        raise AssertionError(f"bad assignment {tuple(xa.shape)} {xa.dtype} {xa.device}")
    if int(xa.min()) < 0 or int(xa.max()) >= p.num_tiers:
        raise AssertionError("assignment names a tier that does not exist")
    if not decision.violations.ok:
        raise AssertionError(f"violations: {decision.violations}")
    obj = decision.solve.objective
    if not (np.isfinite(obj) and obj <= obj0):
        raise AssertionError(f"objective {obj} is not <= the starting {obj0}")
    for name in ("move_eval_best", "commit_topk", "pack_ffd_tiers", "tier_stats", "tier_mean"):
        if launches[name] <= 0:
            raise AssertionError(f"the balance pass launched {name} no time")
    tm = decision.cooperation.timings
    print(f"slice N={p.num_apps} seed=1 (cluster built in {gen_s:.2f} s): objective {obj0:.6f} -> "
          f"{obj:.6f}, violations ok, rounds {tm['rounds']}, last solve sweeps "
          f"{decision.solve.extra['sweeps']} (committed moves "
          f"{decision.solve.extra['committed_moves']}), sweeps in all {launches['move_eval_best']}, "
          f"moved {decision.violations.num_moved}/{decision.violations.move_budget}, "
          f"region rejections {tm['region_rejections']}, host rejections "
          f"{tm['host_rejections']}, solve_s {tm['solve_s']:.4f}, pack_s {tm['pack_s']:.4f}, "
          f"feedback_s {tm['feedback_s']:.4f}, host_side_frac {tm['host_side_frac']:.4f}, "
          f"balance wall {wall:.4f} s, d2b {decision.difference_to_balance:.6f}, "
          f"mapping digest {assignment_digest(xa)}, "
          f"launches {launches}, peak memory {peak / 2**20:.1f} MiB", flush=True)

    # The same pass again: the port's result must not change from run to run.
    t = time.perf_counter()
    again = Sptlb(cluster, device=dev).balance("local", timeout_s=30, config=CoopConfig())
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t
    same = (torch.equal(again.assignment, xa)
            and again.cooperation.timings["rounds"] == tm["rounds"]
            and again.solve.objective == obj)
    print(f"repeat pass: wall {wall2:.4f} s, rounds {again.cooperation.timings['rounds']}, "
          f"objective {again.solve.objective:.6f}, identical to the first pass {same}",
          flush=True)
    if not same:
        raise AssertionError("a second balance pass of the same cluster gave another result")

    # The pack kernel on the tensor the host level built for the last proposal.
    host = HostScheduler(cluster, device=dev)
    x_np = xa.cpu().numpy().astype(np.int64)
    x0_np = p.assignment0.cpu().numpy().astype(np.int64)
    movers = np.where(x_np != x0_np)[0]
    dem, _ = host.pack_inputs(x_np, x0_np, movers, np.empty(0, np.int64))
    pack_main = check_pack(f"last proposal N={p.num_apps}", dem, cluster.host_capacity,
                           cluster.hosts_per_tier, host._hosts_pad, record, dev, clock_mhz=clock)

    # -- 3b. the unfused LocalSearch sweep: the move_eval kernel's path --------
    # solve_local(move_eval_fn=ops.move_eval) scores the full delta[N, T] and
    # masks it in torch; the counts are zeroed just before and read just after.
    cfg_u = LocalSearchConfig(max_iters=UNFUSED_SWEEPS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res_u = solve_local(pp, cfg_u, move_eval_fn=ops.move_eval, device=dev)
    torch.cuda.synchronize()
    unfused_s = time.perf_counter() - t
    unfused_launches = dict(ops.launch_counts)
    if unfused_launches["move_eval"] <= 0:
        raise AssertionError("the unfused solve launched move_eval no time")
    if not (validate(pp, res_u.assignment).ok and res_u.objective <= obj0):
        raise AssertionError(f"unfused solve: objective {res_u.objective} from {obj0}, "
                             f"violations {validate(pp, res_u.assignment)}")
    res_f = solve_local(pp, cfg_u, device=dev)
    agree_u = float((res_u.assignment == res_f.assignment).float().mean())
    print(f"unfused solve N={pp.num_apps}: {res_u.iterations} sweeps in {unfused_s:.4f} s, "
          f"objective {obj0:.6f} -> {res_u.objective:.6f} (fused path {res_f.objective:.6f}, "
          f"assignment agreement {agree_u:.6f}), launches {unfused_launches}", flush=True)

    # -- 3c. where the time goes: one short solve under torch.profiler ---------
    prof = device_profile(lambda: solve_local(pp, LocalSearchConfig(max_iters=PROFILE_SWEEPS),
                                              device=dev))
    print(solve_profile_line(f"profile: {PROFILE_SWEEPS} sweeps at N={pp.num_apps}", prof),
          flush=True)

    wall_h, phases = host_profile(lambda: solve_local(
        pp, LocalSearchConfig(max_iters=PROFILE_SWEEPS), device=dev))
    print(f"host profile: {PROFILE_SWEEPS} sweeps at N={pp.num_apps} under cProfile, wall "
          f"{wall_h:.4f} s; cumulative: " + ", ".join(
              f"{label.strip()} {sec:.4f} s ({sec / wall_h:.3f})" for label, sec in phases.items()),
          flush=True)

    # -- 3d. the sampled LocalSearch (temperature > 0): move_eval's solver path --
    # One sweep a launch of the full delta[N, T]; the counts are zeroed just
    # before and read just after.
    cfg_s = LocalSearchConfig(temperature=SAMPLED_TAU, seed=0, max_iters=SAMPLED_SWEEPS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res_s = solve_local(pp, cfg_s, device=dev)
    torch.cuda.synchronize()
    sampled_s = time.perf_counter() - t
    sampled_launches = dict(ops.launch_counts)
    valid_s = validate(pp, res_s.assignment)
    print(f"sampled solve N={pp.num_apps}: temperature {SAMPLED_TAU}, seed 0, "
          f"{res_s.iterations} sweeps in {sampled_s:.4f} s "
          f"({sampled_s / max(res_s.iterations, 1) * 1e3:.4f} ms a sweep), committed moves "
          f"{res_s.extra['committed_moves']}, converged {res_s.converged}, objective "
          f"{obj0:.6f} -> {res_s.objective:.6f}, violations ok {valid_s.ok}, digest "
          f"{assignment_digest(res_s.assignment)}, launches {sampled_launches}", flush=True)
    if not (res_s.iterations > 0 and sampled_launches["move_eval"] == res_s.iterations):
        raise AssertionError(f"the sampled solve launched move_eval "
                             f"{sampled_launches['move_eval']} times in {res_s.iterations} "
                             "sweeps")
    if not (valid_s.ok and res_s.objective <= obj0):
        raise AssertionError(f"sampled solve: objective {res_s.objective} from {obj0}, "
                             f"violations {valid_s}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    again_s = solve_local(pp, cfg_s, device=dev)
    torch.cuda.synchronize()
    again_s_s = time.perf_counter() - t
    same_s = assignment_digest(again_s.assignment) == assignment_digest(res_s.assignment)
    # Host-drawn noise, injected: the kernel's solve against the plain
    # move_delta_cost's on the card.
    res_k = solve_local(pp, cfg_s, gumbel_fn=host_gumbel, device=dev)
    res_p = solve_local(pp, cfg_s, move_eval_fn=move_delta_cost, gumbel_fn=host_gumbel,
                        device=dev)
    same_p = (torch.equal(res_k.assignment, res_p.assignment)
              and (res_k.iterations, res_k.extra["committed_moves"], res_k.objective)
              == (res_p.iterations, res_p.extra["committed_moves"], res_p.objective))
    print(f"  repeat with seed 0: {again_s.iterations} sweeps in {again_s_s:.4f} s "
          f"({again_s_s / max(again_s.iterations, 1) * 1e3:.4f} ms a sweep), digest "
          f"{assignment_digest(again_s.assignment)}, the same {same_s}; injected host noise: "
          f"kernel {res_k.iterations} sweeps, objective {res_k.objective:.6f}, plain "
          f"move_delta_cost on the card {res_p.iterations} sweeps, objective "
          f"{res_p.objective:.6f}, the same trajectory {same_p}", flush=True)
    if not same_s:
        raise AssertionError("a repeat of the sampled solve with its seed gave another mapping")
    if not same_p:
        raise AssertionError("the sampled solve through the kernel left the plain path's "
                             "trajectory")
    prof_s = device_profile(lambda: solve_local(
        pp, LocalSearchConfig(temperature=SAMPLED_TAU, seed=0, max_iters=PROFILE_SWEEPS),
        device=dev))
    print(solve_profile_line(f"  profile: {PROFILE_SWEEPS} sampled sweeps", prof_s), flush=True)

    # -- 3e. agreement with the plain path on a small input ----------------------
    small = generate_cluster(num_apps=300, seed=3, device="cpu")
    cfg = CoopConfig(max_rounds=8, timeout_s=1e9)
    d_cpu = Sptlb(small, device="cpu").balance("local", timeout_s=4, config=cfg)
    d_gpu = Sptlb(small, device=dev).balance("local", timeout_s=4, config=cfg)
    agree = float((d_gpu.assignment.cpu() == d_cpu.assignment).float().mean())
    rel = abs(d_gpu.solve.objective - d_cpu.solve.objective) / abs(d_cpu.solve.objective)
    rounds = (d_gpu.cooperation.timings["rounds"], d_cpu.cooperation.timings["rounds"])
    print(f"small N=300 seed=3: card objective {d_gpu.solve.objective:.6f}, plain path "
          f"{d_cpu.solve.objective:.6f}, rel diff {rel:.3e}, rounds {rounds[0]}/{rounds[1]}, "
          f"assignment agreement {agree:.4f}, violations ok "
          f"{d_gpu.violations.ok}/{d_cpu.violations.ok}", flush=True)
    if not (d_gpu.violations.ok and d_cpu.violations.ok and rel <= 1e-4
            and rounds[0] == rounds[1] and agree >= 0.98):
        raise AssertionError("the card's balance disagrees with the plain path at N=300")

    # -- 3f. the optimal engine: its rounding kernel, then the N=100k pass -------
    optimal = optimal_phase(cluster, pp, obj0, record, dev, clock_mhz=clock)

    # -- 3g. the control loop: BalanceController ticks at N=100k ----------------
    control = control_phase(dev)
    control_launches = control["run"]["launches"]

    # -- 3h. the sharded fleet solver at N=1,000,000 ------------------------------
    fleet = fleet_phase(dev, record)
    torch.cuda.empty_cache()

    # -- 3i. the streaming service at N=100k: ServiceLoop ticks --------------------
    service = service_phase(dev, record)
    service_launches = service["run"]["launches"]
    torch.cuda.empty_cache()

    # -- 3j. the fleet simulator at N=100k: scenario trajectories -------------------
    sim = sim_phase(dev, record)
    sim_launches = {k: sim["tier_drain"]["launches"][k] + sim["fleet_scale"]["launches"][k]
                    for k in sim["tier_drain"]["launches"]}
    torch.cuda.empty_cache()

    # -- 3k. the stream router and the fault path at N=100k ------------------------
    stream = stream_phase(dev, record)
    stream_launches = stream["launches"]
    torch.cuda.empty_cache()

    # -- 4. the serving slice: qwen2.5-3b at full width --------------------------
    serving = serving_phase(dev, record)
    fa, fd = serving["times"]["prefill_main"], serving["times"]["decode_main"]

    # -- 5. the hybrid serving slice: zamba2-2.7b at full width -----------------
    hybrid = hybrid_phase(dev, record)
    ssd = hybrid["times"]["ssd_main"]
    # the flash kernels' launches on both serving paths, each counted from 0
    flash_launches = {name: serving["launches"][name] + hybrid["launches"][name]
                      for name in ("flash_attention", "flash_decode")}

    # -- 6. the training feeders: smollm-360m at full width -----------------------
    torch.cuda.empty_cache()
    feeders = feeders_phase(dev, record)

    # -- 7. gemma2-9b at full width: windowed decode, ring caches -----------------
    del feeders["runs"]                    # the compressor states: every model is freed
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before phase 7: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated on the "
          "card", flush=True)
    gemma2 = gemma2_phase(dev, record)
    flash_launches = {name: flash_launches[name] + gemma2["launches"][name]
                      for name in ("flash_attention", "flash_decode")}

    # -- 8. granite-moe-1b-a400m at full width: the MoE kernels --------------------
    gemma2_times, gemma2_launches = gemma2["times"], {k: gemma2[k]["launches"]
                                                      for k in ("full", "ring")}
    del gemma2                             # every gemma2 tensor is freed
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before phase 8: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated on the "
          "card", flush=True)
    moe = moe_phase(dev, record)

    # -- 9. deepseek-v2-lite-16b at full width: MLA, V's own head dim ---------------
    del moe["run"]                         # every granite tensor is freed
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before phase 9: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated on the "
          "card", flush=True)
    mla = mla_phase(dev, record)

    # -- 10. phi-3-vision-4.2b at full width: the image prefix, D = 96 ---------------
    del mla["run"]                         # every deepseek tensor is freed
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before phase 10: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated on the "
          "card", flush=True)
    vlm = vlm_phase(dev, record)

    # -- 11. hubert-xlarge at full width: 32,768 frames bidirectionally ---------------
    del vlm["serve"]                       # every phi-3 tensor is freed
    gc.collect()
    torch.cuda.empty_cache()
    print(f"before phase 11: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated on the "
          "card", flush=True)
    audio = audio_phase(dev, record)
    flash_launches = {name: flash_launches[name] + moe["launches"][name] + mla["launches"][name]
                      + vlm["launches"][name] + audio["launches"][name]
                      for name in ("flash_attention", "flash_decode")}
    flash_by_path = {name: {SERVE_ARCH: serving["launches"][name],
                            HYBRID_ARCH: hybrid["launches"][name],
                            GEMMA2_ARCH: gemma2_launches["full"][name],
                            f"{GEMMA2_ARCH} ring_cache": gemma2_launches["ring"][name],
                            MOE_ARCH: moe["launches"][name],
                            MLA_ARCH: mla["launches"][name],
                            f"{VLM_ARCH} image": vlm["by_path"]["image"][name],
                            f"{VLM_ARCH} text": vlm["by_path"]["text"][name],
                            AUDIO_ARCH: audio["launches"][name]}
                     for name in ("flash_attention", "flash_decode")}

    # -- 12. xlstm-125m at full width: the mLSTM and sLSTM scans -------------------
    gc.collect()                           # audio_phase freed hubert's model
    torch.cuda.empty_cache()
    print(f"before phase 12: {torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated on the "
          "card", flush=True)
    xlstm = xlstm_phase(dev, record, clock_mhz=clock)

    # -- 13. result lines -------------------------------------------------------
    kernels = [
        {"name": "move_eval_best", "route": "cuda", "source": MOVE_EVAL_SRC,
         "replaces": "src/repro/kernels/move_eval.py:275",
         "launches": (launches["move_eval_best"] + control_launches["move_eval_best"]
                      + service_launches["move_eval_best"] + sim_launches["move_eval_best"]
                      + stream_launches["move_eval_best"]),
         "launches_by_path": {"balance": launches["move_eval_best"],
                              "control": control_launches["move_eval_best"],
                              "service": service_launches["move_eval_best"],
                              "sim": sim_launches["move_eval_best"],
                              "stream": stream_launches["move_eval_best"]},
         "max_abs_err": record["move_eval_best"]["max_abs_err"],
         "ms": main_sweep["move_eval_best"]["ms"],
         "plain_ms": main_sweep["move_eval_best"]["plain_ms"],
         "bound_ms": main_sweep["move_eval_best"]["bound_ms"],
         "bound_by": main_sweep["move_eval_best"]["bound_by"], "library_ms": None},
        {"name": "move_eval", "route": "cuda", "source": MOVE_EVAL_SRC,
         "replaces": "src/repro/kernels/move_eval.py:241",
         "launches": sampled_launches["move_eval"] + unfused_launches["move_eval"],
         "launches_by_path": {"sampled": sampled_launches["move_eval"],
                              "unfused": unfused_launches["move_eval"]},
         "max_abs_err": record["move_eval"]["max_abs_err"],
         "ms": main_sweep["move_eval"]["ms"],
         "whole_call_ms": main_sweep["move_eval"]["whole_call_ms"],
         "plain_ms": main_sweep["move_eval"]["plain_ms"],
         "bound_ms": main_sweep["move_eval"]["bound_ms"],
         "bound_by": main_sweep["move_eval"]["bound_by"], "library_ms": None},
        {"name": "commit_topk", "route": "cuda", "source": COMMIT_SRC,
         "replaces": "src/repro/core/solver_local.py:219",
         "launches": (launches["commit_topk"] + control_launches["commit_topk"]
                      + service_launches["commit_topk"] + sim_launches["commit_topk"]
                      + stream_launches["commit_topk"]),
         "launches_by_path": {"balance": launches["commit_topk"],
                              "control": control_launches["commit_topk"],
                              "service": service_launches["commit_topk"],
                              "sim": sim_launches["commit_topk"],
                              "stream": stream_launches["commit_topk"]},
         "max_abs_err": record["commit_topk"]["max_abs_err"],
         "ms": main_commit["ms"], "plain_ms": main_commit["plain_ms"],
         "bound_ms": main_commit["bound_ms"], "bound_by": main_commit["bound_by"],
         "library_ms": None},
        {"name": "pack_ffd_tiers", "route": "cuda", "source": PACK_SRC,
         "replaces": "src/repro/kernels/pack.py:116",
         "launches": (launches["pack_ffd_tiers"] + control_launches["pack_ffd_tiers"]
                      + service_launches["pack_ffd_tiers"] + sim_launches["pack_ffd_tiers"]
                      + stream_launches["pack_ffd_tiers"]),
         "launches_by_path": {"balance": launches["pack_ffd_tiers"],
                              "control": control_launches["pack_ffd_tiers"],
                              "service": service_launches["pack_ffd_tiers"],
                              "sim": sim_launches["pack_ffd_tiers"],
                              "stream": stream_launches["pack_ffd_tiers"]},
         "max_abs_err": record["pack_ffd_tiers"]["max_abs_err"],
         "ms": pack_main["ms"], "plain_ms": pack_main["plain_ms"],
         "bound_ms": pack_main["bound_ms"], "bound_by": pack_main["bound_by"],
         "chain_floor_ms": pack_main["chain_floor_ms"], "library_ms": None},
        {"name": "flash_attention", "route": "cuda", "source": FLASH_ATTENTION_SRC,
         "replaces": "src/repro/kernels/flash_attention.py:144",
         "launches": flash_launches["flash_attention"],
         "launches_by_path": flash_by_path["flash_attention"],
         "max_abs_err": record["flash_attention"]["max_abs_err"],
         "ms": fa["ms"], "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
         "bound_by": fa["bound_by"], "library_ms": fa["library_ms"],
         "gemma2": {k: gemma2_times[k] for k in ("prefill_local", "prefill_global")},
         "granite": moe["times"]["prefill_attention"],
         "deepseek": mla["times"]["prefill_attention"],
         "phi3": vlm["times"]["prefill_attention"],
         "hubert": {f"S={AUDIO_CHECK_LEN}": audio["times"]["attention_check"],
                    f"S={AUDIO_LEN}": audio["times"]["attention_main"]}},
        {"name": "flash_decode", "route": "cuda", "source": FLASH_DECODE_SRC,
         "replaces": "src/repro/kernels/flash_decode.py:108",
         "launches": flash_launches["flash_decode"],
         "launches_by_path": flash_by_path["flash_decode"],
         "max_abs_err": record["flash_decode"]["max_abs_err"],
         "ms": fd["ms"], "plain_ms": fd["plain_ms"], "bound_ms": fd["bound_ms"],
         "bound_by": fd["bound_by"], "library_ms": fd["library_ms"],
         "gemma2": gemma2_times["decode_window"],
         "granite": moe["times"]["decode_attention"],
         "deepseek": mla["times"]["decode_attention"],
         "phi3": vlm["times"]["decode_attention"],
         "phi3_simt_forced": vlm["times"]["decode_attention_simt"]},
        {"name": "ssd_chunk", "route": "cuda", "source": SSD_CHUNK_SRC,
         "replaces": "src/repro/kernels/mamba_scan.py:71",
         "launches": hybrid["launches"]["ssd_chunk"],
         "max_abs_err": record["ssd_chunk"]["max_abs_err"],
         "ms": ssd["ms"], "plain_ms": ssd["plain_ms"], "bound_ms": ssd["bound_ms"],
         "bound_by": ssd["bound_by"], "library_ms": ssd["library_ms"]},
        {"name": "optimal_round", "route": "cuda", "source": OPTIMAL_ROUND_SRC,
         "replaces": "src/repro/core/solver_optimal.py:138",
         "launches": sum(r["launches"]["optimal_round"] for r in optimal["runs"].values()),
         "launches_by_path": {v: r["launches"]["optimal_round"]
                              for v, r in optimal["runs"].items()},
         "max_abs_err": record["optimal_round"]["max_abs_err"],
         "bodies": {b: sum(r["bodies"][b] for r in optimal["runs"].values())
                    for b in ("registers", "shared")},
         "ms": optimal["main"]["ms"], "stage_ms": optimal["main"]["stage_ms"],
         "walk_ms": optimal["main"]["walk_ms"],
         "whole_call_ms": optimal["main"]["whole_call_ms"],
         "before_kernel_ms": optimal["main"]["prep_ms"]["all of round_inputs"],
         "kinds_ms": {k: v["ms"] for k, v in optimal["main"]["kinds"].items()},
         "plain_ms": optimal["main"]["plain_ms"],
         "bound_ms": optimal["main"]["bound_ms"], "bound_by": optimal["main"]["bound_by"],
         "chain_floor_ms": optimal["main"]["chain_floor_ms"], "library_ms": None},
    ]
    for name, part in (("move_eval_best_batched", "sweep"), ("commit_topk_batched", "commit")):
        t = fleet["main"][part]
        kernels.append({
            "name": name, "route": "cuda",
            "source": MOVE_EVAL_SRC if part == "sweep" else COMMIT_SRC,
            "replaces": ("src/repro/kernels/move_eval.py:275" if part == "sweep"
                         else "src/repro/core/solver_local.py:219"),
            "launches": fleet["launches"][name] + service_launches[name] + sim_launches[name],
            "launches_by_path": {"fleet": fleet["launches"][name],
                                 "service": service_launches[name],
                                 "sim": sim_launches[name]},
            "max_abs_err": record[name]["max_abs_err"], "shape": fleet["main"]["shape"],
            "ms": t["ms"], "unbatched_ms": t["unbatched_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
            "wide": {"shape": fleet["wide"]["shape"], **fleet["wide"][part]}})
    tier_paths = {"balance": launches, "unfused": unfused_launches,
                  "sampled": sampled_launches, "control": control_launches,
                  "fleet": fleet["launches"], "service": service_launches,
                  "sim": sim_launches, "stream": stream_launches}
    tier_paths.update({f"optimal {v}": r["launches"] for v, r in optimal["runs"].items()})
    for name, replaces in (("tier_stats", "src/repro/kernels/move_eval.py:169"),
                           ("tier_mean", "src/repro/core/goals.py:55")):
        t = main_sweep[name]
        kernels.append({
            "name": name, "route": "cuda", "source": MOVE_EVAL_SRC, "replaces": replaces,
            "launches": sum(c[name] for c in tier_paths.values()),
            "launches_by_path": {k: c[name] for k, c in tier_paths.items()},
            "max_abs_err": record[name]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")})
    for name, replaces in COMPRESS_REPLACES.items():
        t = feeders["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": COMPRESS_SRC,
            "replaces": replaces,
            "launches": feeders["launches"][name],
            "max_abs_err": record[name]["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    for name, replaces in MOE_REPLACES.items():
        t, d = moe["times"]["granite_prefill"][name], moe["times"]["granite_decode"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": MOE_SRC, "replaces": replaces,
            "launches": moe["launches"][name] + mla["launches"][name],
            "launches_by_path": {MOE_ARCH: moe["launches"][name],
                                 MLA_ARCH: mla["launches"][name]},
            "max_abs_err": record[name]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "decode": {k: d[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}})
    for name, replaces in XLSTM_REPLACES.items():
        t = xlstm["times"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": XLSTM_SRC,
            "replaces": replaces,
            "launches": xlstm["launches"][name], "launches_by_path": xlstm["by_path"][name],
            "max_abs_err": record[name]["max_abs_err"], "shape": t["shape"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "plain_shape": t["plain_shape"],
            "ms_at_plain_steps": t["ms_at_plain_steps"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "chain_floor_ms": t.get("chain_floor_ms"),
            "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--probe":
        sys.exit(probe(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--flash-probe":
        sys.exit(flash_probe(sys.argv[2]))
    sys.exit(main())
