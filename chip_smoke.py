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
     kernel alone), the pack kernel also beside its chain floor; and the
     kernels one whole call of each sweep launches (profiler).
  3. The slice: ``generate_cluster(num_apps=100_000, seed=1)`` and one
     manual_cnst ``Sptlb(cluster).balance("local", timeout_s=30,
     config=CoopConfig())`` with the launch counters zeroed just before and
     read just after (``move_eval_best``, ``commit_topk`` and
     ``pack_ffd_tiers`` must each have launched); then the unfused LocalSearch path
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
  6. A ``{"kernels": [...]}`` line (the flash kernels' launches summed over
     both serving runs, the scheduling kernels' over the balance pass, the
     control loop, the service and the simulator's two pairs, the
     shard-batched ones' over the measured fleet pass, the service and the
     simulator), then the card line again, then
     the final
     ``{"ok": true, "device": {...}}`` line.

``python3 chip_smoke.py --probe SRC`` runs only the balancing slice of the
``repro_torch`` package under SRC, with the rounding kernel on the main
path's P and every ``round_case`` kind at (131,072, 5, 2), and prints one
JSON line (see ``probe``):
run it on this tree's ``src`` and on a ``git archive`` of another commit's,
in turns, to compare the two on one card.

It imports nothing of JAX or of the JAX reference package.
"""
from __future__ import annotations

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


def check_sweep(label, args, feas, moves_left_values, record, dev):
    """Hold both move_eval kernels against core.delta on the card; the best
    kernel also with the caller's totals against the wrapper's own."""
    import torch
    from repro_torch.core.delta import move_best_per_app, move_delta_cost
    from repro_torch.kernels import move_eval as K

    N = args[0].shape[0]
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

    demand, tasks, cap, klim, util, tier_tasks = (args[i] for i in (0, 1, 5, 6, 9, 10))
    T = cap.shape[0]
    src = args[3].long()
    f, g = util / cap, tier_tasks / klim
    pairs = ((demand[:, None, :] / cap[None] - (demand / cap[src])[:, None, :], f.mean(0)),
             (tasks[:, None] / klim[None] - (tasks / klim[src])[:, None], g.mean()))
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
    from repro_torch.kernels import move_eval as K

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


# A Zamba2 decode step adds the Mamba2 layers' one-step forms.
HYBRID_DECODE_PHASES = {
    **DECODE_PHASES,
    "ssd_step": lambda f, n: n == "ssd_step" and f.endswith("mamba2.py"),
    "conv_step": lambda f, n: n == "conv_step" and f.endswith("mamba2.py"),
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


def attention_work(B, Sq, Skv, H, KV, D, itemsize, causal=True, window=None) -> tuple[float, float]:
    """(bytes, operations) flash attention needs: q, k, v read once and the
    output written once; 4 D operations (the q.k and p.v products) for
    every (query, key) pair the masks leave visible."""
    import numpy as np

    i = np.arange(Sq)[:, None]
    j = np.arange(Skv)[None, :]
    visible = np.ones((Sq, Skv), bool)
    if causal:
        visible &= j <= i
    if window is not None:
        visible &= j > i - window
    nbytes = (2 * B * Sq * H * D + 2 * B * Skv * KV * D) * itemsize
    return float(nbytes), float(4 * D * B * H * int(visible.sum()))


def decode_work(B, kv_len, H, KV, D, itemsize) -> tuple[float, float]:
    """(bytes, operations) one decode step's attention needs: the written
    cache rows of k and v, the query and the output, kv_len; 4 D
    operations for every visible cache position of every query head."""
    nbytes = (2 * B * H * D + 2 * B * kv_len * KV * D) * itemsize + 4
    return float(nbytes), float(4 * D * B * H * kv_len)


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


def sdpa_prefill(q, k, v):
    """One PyTorch call that computes the causal, no-window, no-softcap
    case (timed as the yardstick only)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), is_causal=True,
                                          enable_gqa=True).transpose(1, 2)


def sdpa_decode(q, k, v, kv_len: int):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k[:, :kv_len].transpose(1, 2),
                                          v[:, :kv_len].transpose(1, 2),
                                          enable_gqa=True).transpose(1, 2)


def check_flash_attention(label, shape, dtype, dev, gen, record, *, window=None, softcap=None,
                          timed=False) -> dict:
    """Hold the flash_attention kernel against its plain version on the
    card (FLASH_TOL); with ``timed``, time the kernel, the plain version
    and, for the causal no-window no-softcap case, SDPA."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_attention_ref

    B, S, H, KV, D = shape
    q = seeded_normal((B, S, H, D), dtype, dev, gen)
    k = seeded_normal((B, S, KV, D), dtype, dev, gen)
    v = seeded_normal((B, S, KV, D), dtype, dev, gen)
    kw = dict(window=window, softcap=softcap)
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    ok, err = flash_close(got, want)
    if not ok:
        raise AssertionError(f"flash_attention {label}: max abs err {err:.3e} beyond "
                             f"{tol_text(dtype)}")
    record["flash_attention"]["max_abs_err"] = max(record["flash_attention"]["max_abs_err"], err)
    line = f"flash_attention {label:>40}: max abs err {err:.3e} ({tol_text(dtype)})"
    out = {}
    if timed:
        itemsize = torch.finfo(dtype).bits // 8
        b, by = flash_bound_ms(*attention_work(B, S, S, H, KV, D, itemsize, window=window), dtype)
        out = {"ms": time_ms(lambda: flash_attention_cuda(q, k, v, **kw)),
               "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, **kw), reps=5),
               "bound_ms": b, "bound_by": by, "library_ms": None}
        if window is None and softcap is None:
            lib_ok, lib_err = flash_close(sdpa_prefill(q, k, v), want)
            if dtype == torch.bfloat16 and lib_ok:
                raise AssertionError(f"flash_attention {label}: the control (SDPA, bf16 "
                                     f"probabilities, max abs err {lib_err:.3e}) passes "
                                     f"{tol_text(dtype)}, which then cannot tell it from "
                                     "the kernel")
            out["library_ms"] = time_ms(lambda: sdpa_prefill(q, k, v))
            line += f", SDPA err vs plain {lib_err:.3e} (control, outside the bound)"
        nbytes, nops = attention_work(B, S, S, H, KV, D, itemsize, window=window)
        line += (f" | kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, SDPA "
                 f"{out['library_ms']} ms, bound {b:.4f} ms ({by}); kernel "
                 f"{nops / out['ms'] / 1e9:.1f} TFLOP/s of the function's {nops / 1e9:.3f} "
                 f"GFLOP, {nbytes / out['ms'] / 1e6:.1f} GB/s of its {nbytes / 1e6:.1f} MB"
                 + (f", {out['ms'] / out['library_ms']:.3f}x SDPA's time"
                    if out["library_ms"] else ""))
    print(line, flush=True)
    return out


def check_flash_decode(label, shape, dtype, dev, gen, record, kv_lens, *, softcap=None,
                       timed_len=None) -> dict:
    """Hold the flash_decode kernel against its plain version on the card
    at each kv_len (an int32 on the card); with ``timed_len``, time the
    kernel, the plain version and SDPA over the written positions there,
    each launch on another copy of the cache (L2_FLUSH_BYTES in all), so
    that it reads the cache from HBM as the serve path does."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode_cuda
    from repro_torch.kernels.ref import flash_decode_ref

    B, Smax, H, KV, D = shape
    q = seeded_normal((B, 1, H, D), dtype, dev, gen)
    k = seeded_normal((B, Smax, KV, D), dtype, dev, gen)
    v = seeded_normal((B, Smax, KV, D), dtype, dev, gen)
    errs = []
    for n in kv_lens:
        n_dev = torch.tensor(n, dtype=torch.int32, device=dev)
        got = flash_decode_cuda(q, k, v, n_dev, softcap=softcap)
        want = flash_decode_ref(q, k, v, n_dev, softcap=softcap)
        torch.cuda.synchronize()
        ok, err = flash_close(got, want)
        errs.append(err)
        if not ok:
            raise AssertionError(f"flash_decode {label} kv_len={n}: max abs err {err:.3e} "
                                 f"beyond {tol_text(dtype)}")
    record["flash_decode"]["max_abs_err"] = max(record["flash_decode"]["max_abs_err"], *errs)
    line = (f"flash_decode {label:>37}: kv_len {list(kv_lens)} max abs err "
            f"{', '.join(f'{e:.2e}' for e in errs)} ({tol_text(dtype)})")
    out = {}
    if timed_len is not None:
        n_dev = torch.tensor(timed_len, dtype=torch.int32, device=dev)
        itemsize = torch.finfo(dtype).bits // 8
        b, by = flash_bound_ms(*decode_work(B, timed_len, H, KV, D, itemsize), dtype)
        copies = max(1, math.ceil(L2_FLUSH_BYTES / (2 * k.nbytes)))
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
        nbytes, _ = decode_work(B, timed_len, H, KV, D, itemsize)
        line += (f" | at kv_len {timed_len}, over {copies} cache copies (L2 cold): kernel "
                 f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, SDPA "
                 f"{out['library_ms']} ms, bound {b:.6f} ms ({by}); kernel "
                 f"{nbytes / out['ms'] / 1e6:.1f} GB/s of the {nbytes / 1e6:.3f} MB it must read"
                 + (f", {out['ms'] / out['library_ms']:.3f}x SDPA's time"
                    if out["library_ms"] else ""))
    print(line, flush=True)
    return out


def serve_requests(cfg):
    """The slice's requests, drawn from SERVE_SEED: prompt lengths uniform
    in [PROMPT_MIN, PROMPT_MAX], token ids uniform over the vocabulary, SLO
    classes as the reference CLI draws them."""
    import numpy as np
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(SERVE_SEED)
    reqs = []
    for i in range(SERVE_REQUESTS):
        n = int(rng.integers(PROMPT_MIN, PROMPT_MAX + 1))
        reqs.append(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                            slo=int(rng.choice(4, p=[0.2, 0.2, 0.45, 0.15])),
                            max_new_tokens=SERVE_NEW))
    return reqs


def serve_once(model, cfg, dev):
    """One run of the slice through the user's entry points: the requests
    queued, ``ServeEngine`` built, ``serve_all`` drained -> (finished
    requests in serving order, wall seconds, the engine)."""
    import torch
    from repro_torch.launch.serve import RequestQueue, ServeEngine, serve_all

    queue = RequestQueue()
    t0 = time.perf_counter()
    for r in serve_requests(cfg):
        r.arrival_s = t0
        queue.push(r)
    engine = ServeEngine(model, slots=SERVE_SLOTS, max_seq=SERVE_MAX_SEQ, device=dev)
    finished = serve_all(engine, queue)
    torch.cuda.synchronize()
    return finished, time.perf_counter() - t0, engine


def wave_stats(finished, t0: float) -> list[dict]:
    """Per wave (SERVE_SLOTS requests in serving order): its longest prompt,
    decode steps, prefill seconds (first token minus the previous wave's
    end), decode ms per step."""
    waves, start = [], t0
    for w in range(0, len(finished), SERVE_SLOTS):
        reqs = finished[w:w + SERVE_SLOTS]
        first = reqs[0].first_token_s
        done = max(r.done_s for r in reqs)
        steps = max(len(r.tokens) for r in reqs) - 1
        waves.append({"prompt_len": max(len(r.prompt) for r in reqs), "steps": steps,
                      "prefill_s": first - start, "ttft_s": first - t0,
                      "decode_ms_per_step": (done - first) / steps * 1e3})
        start = done
    return waves


def teacher_forced_check(model, reqs, dev) -> dict:
    """The wave's padded prompts through ``prefill`` and one ``decode_step``
    of its first generated tokens, against ``forward_train`` over the
    padded prompts plus those tokens (the reference's own check,
    tests/test_models.py:63); returns the errors."""
    import numpy as np
    import torch

    maxlen = max(len(r.prompt) for r in reqs)
    batch = np.zeros((SERVE_SLOTS, maxlen), np.int32)
    first = np.zeros((SERVE_SLOTS, 1), np.int32)
    for i, r in enumerate(reqs):
        batch[i, maxlen - len(r.prompt):] = r.prompt
        first[i, 0] = r.tokens[0]
    tokens = torch.as_tensor(batch, device=dev)
    tok0 = torch.as_tensor(first, device=dev)
    cache = model.init_cache(SERVE_SLOTS, SERVE_MAX_SEQ)
    pre, cache = model.prefill({"tokens": tokens}, cache)
    dec, cache = model.decode_step(tok0, cache)
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
                                        == first[:n, 0]).sum()),
           "rows": n}
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


def wave_lengths(cfg) -> list[int]:
    """Each wave's longest prompt on the main path (waves follow SLO
    priority)."""
    from repro_torch.launch.serve import RequestQueue

    q = RequestQueue()
    reqs = serve_requests(cfg)
    for r in reqs:
        q.push(r)
    order = [q.pop() for _ in range(len(reqs))]
    return [max(len(r.prompt) for r in order[w:w + SERVE_SLOTS])
            for w in range(0, len(order), SERVE_SLOTS)]


def serve_slice(cfg, dev, expected_launches, phases) -> dict:
    """Full-width ``cfg`` in bf16 with seeded random weights serves the
    slice's requests through ``ServeEngine``, with the launch counters
    zeroed just before and read just after (``expected_launches(waves,
    steps)`` names the counts each kernel must show); then the checks (a
    repeat gives the same tokens, wave 1's first decode logits match a
    teacher-forced ``forward_train``, all logits finite), one profiled
    prefill (device time by kernel name) and one profiled decode step
    (device idle share, one ``flash_decode`` launch a call; host phases
    under cProfile).  Every ``flash_attention`` launch of the serve must
    have taken the tensor-core body."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import body_launches
    from repro_torch.launch.serve import latency_report
    from repro_torch.models import build_model

    arch = cfg.arch_id
    t = time.perf_counter()
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(
        SERVE_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    finished, wall, _ = serve_once(model, cfg, dev)
    launches = dict(ops.launch_counts)
    bodies = dict(body_launches)
    peak = torch.cuda.max_memory_allocated()
    waves = wave_stats(finished, t0)
    steps = sum(w["steps"] for w in waves)
    for name, n in expected_launches(len(waves), steps).items():
        if launches[name] != n:
            raise AssertionError(f"{arch} serve launched {name} {launches[name]} times, "
                                 f"expected {n}")
    if bodies != {"simt": 0, "wgmma": launches["flash_attention"]}:
        raise AssertionError(f"{arch} prefill took the flash_attention bodies {bodies}, not the "
                             f"tensor-core body {launches['flash_attention']} times")
    for r in finished:
        if len(r.tokens) != SERVE_NEW or not all(0 <= x < cfg.vocab_size for x in r.tokens):
            raise AssertionError(f"{arch} request {r.rid}: tokens {r.tokens}")
    if sorted(r.rid for r in finished) != list(range(SERVE_REQUESTS)):
        raise AssertionError(f"{arch}: not every request was served once")
    for i, w in enumerate(waves):
        print(f"serve {arch} wave {i + 1}: B={SERVE_SLOTS} prompt_len {w['prompt_len']} "
              f"(left-padded), prefill {w['prefill_s'] * 1e3:.3f} ms, TTFT from arrival "
              f"{w['ttft_s'] * 1e3:.3f} ms, {w['steps']} decode steps at "
              f"{w['decode_ms_per_step']:.4f} ms per step "
              f"({w['decode_ms_per_step'] / SERVE_SLOTS:.4f} ms per token)", flush=True)
    report = latency_report(finished)
    print(f"serve {arch} full width ({n_params / 1e9:.4f} B params, bf16, init "
          f"{init_s:.3f} s): {len(finished)} requests in {len(waves)} waves, wall {wall:.4f} s, "
          f"{SERVE_REQUESTS * SERVE_NEW / wall:.2f} generated tokens/s, launches {launches} "
          f"(flash_attention bodies {bodies}), "
          f"peak memory {peak / 2**30:.3f} GiB; latency by SLO "
          + json.dumps({f"SLO{k + 1}": v for k, v in report.items()}), flush=True)

    # checks: repeat, teacher forcing, finite logits
    t0 = time.perf_counter()
    again, wall2, engine = serve_once(model, cfg, dev)
    same = {r.rid: r.tokens for r in again} == {r.rid: r.tokens for r in finished}
    print(f"repeat serve {arch}: wall {wall2:.4f} s, tokens identical {same}; per wave "
          + "; ".join(f"prefill {w['prefill_s'] * 1e3:.3f} ms, {w['decode_ms_per_step']:.4f} ms "
                      "per step" for w in wave_stats(again, t0)), flush=True)
    if not same:
        raise AssertionError(f"a second {arch} serve of the same requests gave other tokens")
    tf = teacher_forced_check(model, finished[:SERVE_SLOTS], dev)
    print(f"teacher-forced check {arch} (wave 1, {tf['rows']} rows): decode vs forward_train "
          f"max abs err {tf['max_abs_err']:.4f} of max |logit| {tf['scale']:.4f} (tol "
          f"{TEACHER_TOL:g} x scale), mean abs err {tf['mean_abs_err']:.5f}, argmax agree "
          f"{tf['argmax_agree']}/{tf['rows']}, prefill argmax = served first token "
          f"{tf['prefill_tokens_agree']}/{tf['rows']}, all finite {tf['finite']}", flush=True)
    if not tf["finite"]:
        raise AssertionError(f"non-finite logits at full width ({arch})")
    if not tf["max_abs_err"] <= TEACHER_TOL * tf["scale"]:
        raise AssertionError(f"{arch} decode logits part from the teacher-forced forward")
    if tf["prefill_tokens_agree"] != tf["rows"]:
        raise AssertionError(f"a repeat {arch} prefill picked another first token than the "
                             "served run")

    # one profiled prefill (a fresh wave), then one profiled decode step
    prompts = serve_requests(cfg)[:SERVE_SLOTS]
    plen = max(len(r.prompt) for r in prompts)
    pre = device_profile(lambda: engine.admit_wave(prompts))
    if pre["busy_s"] is None:
        print(f"profile {arch}: one prefill of {SERVE_SLOTS} prompts (longest {plen}), wall "
              f"{pre['wall_s'] * 1e3:.3f} ms; the profiler saw no device activity", flush=True)
    else:
        ktot = sum(us for _, us in pre["kernels"])
        top = "; ".join(f"{kernel_label(name)} {us / 1e3:.3f} ms x{pre['counts'][name]} "
                        f"({us / ktot:.3f})" for name, us in pre["kernels"][:PROFILE_TOP])
        print(f"profile {arch}: one prefill of {SERVE_SLOTS} prompts (longest {plen}), wall "
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
            "wave1": finished[:SERVE_SLOTS], "teacher": tf}


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


def probe_round(pp, dev) -> dict:
    """``--probe``'s rounding times: the kernel's wrapper on fresh copies of
    x and the loads, at the main path's P and at every kind of
    ``round_case`` at (131,072, 5, 2), with each status."""
    from repro_torch.core import OptimalSearchConfig
    from repro_torch.core.solver_optimal import _optimize, round_inputs, start_noise
    from repro_torch.kernels.optimal_round import ROUND_KINDS, optimal_round_cuda, round_case

    cfg = OptimalSearchConfig(steps=OPTIMAL_STEPS, seed=0)
    probs = _optimize(pp, start_noise(pp, cfg.seed), steps=cfg.steps, lr=cfg.lr,
                      penalty=cfg.penalty, entropy=cfg.entropy)
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
              "commit_topk_batched": {"max_abs_err": 0.0}}

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
    # The same for the full sweep, as the sampled solve makes it.
    call = device_profile(lambda: K.move_eval_cuda(*main_args, totals=totals_main))
    names = {kernel_label(n, 60): c for n, c in call["counts"].items()}
    print(f"  move_eval whole call: {sum(call['counts'].values())} kernel launches on the "
          f"card: {names}", flush=True)
    if any("cat" in n.lower() or "stack" in n.lower() for n in call["counts"]):
        raise AssertionError(f"the full sweep launched a cat or stack: {names}")

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
    for name in ("move_eval_best", "commit_topk", "pack_ffd_tiers"):
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

    # -- 4. the serving slice: qwen2.5-3b at full width --------------------------
    serving = serving_phase(dev, record)
    fa, fd = serving["times"]["prefill_main"], serving["times"]["decode_main"]

    # -- 5. the hybrid serving slice: zamba2-2.7b at full width -----------------
    hybrid = hybrid_phase(dev, record)
    ssd = hybrid["times"]["ssd_main"]
    # the flash kernels' launches on both serving paths, each counted from 0
    flash_launches = {name: serving["launches"][name] + hybrid["launches"][name]
                      for name in ("flash_attention", "flash_decode")}

    # -- 6. result lines --------------------------------------------------------
    kernels = [
        {"name": "move_eval_best", "route": "cuda", "source": MOVE_EVAL_SRC,
         "replaces": "src/repro/kernels/move_eval.py:275",
         "launches": (launches["move_eval_best"] + control_launches["move_eval_best"]
                      + service_launches["move_eval_best"] + sim_launches["move_eval_best"]),
         "launches_by_path": {"balance": launches["move_eval_best"],
                              "control": control_launches["move_eval_best"],
                              "service": service_launches["move_eval_best"],
                              "sim": sim_launches["move_eval_best"]},
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
                      + service_launches["commit_topk"] + sim_launches["commit_topk"]),
         "launches_by_path": {"balance": launches["commit_topk"],
                              "control": control_launches["commit_topk"],
                              "service": service_launches["commit_topk"],
                              "sim": sim_launches["commit_topk"]},
         "max_abs_err": record["commit_topk"]["max_abs_err"],
         "ms": main_commit["ms"], "plain_ms": main_commit["plain_ms"],
         "bound_ms": main_commit["bound_ms"], "bound_by": main_commit["bound_by"],
         "library_ms": None},
        {"name": "pack_ffd_tiers", "route": "cuda", "source": PACK_SRC,
         "replaces": "src/repro/kernels/pack.py:116",
         "launches": (launches["pack_ffd_tiers"] + control_launches["pack_ffd_tiers"]
                      + service_launches["pack_ffd_tiers"] + sim_launches["pack_ffd_tiers"]),
         "launches_by_path": {"balance": launches["pack_ffd_tiers"],
                              "control": control_launches["pack_ffd_tiers"],
                              "service": service_launches["pack_ffd_tiers"],
                              "sim": sim_launches["pack_ffd_tiers"]},
         "max_abs_err": record["pack_ffd_tiers"]["max_abs_err"],
         "ms": pack_main["ms"], "plain_ms": pack_main["plain_ms"],
         "bound_ms": pack_main["bound_ms"], "bound_by": pack_main["bound_by"],
         "chain_floor_ms": pack_main["chain_floor_ms"], "library_ms": None},
        {"name": "flash_attention", "route": "cuda", "source": FLASH_ATTENTION_SRC,
         "replaces": "src/repro/kernels/flash_attention.py:144",
         "launches": flash_launches["flash_attention"],
         "max_abs_err": record["flash_attention"]["max_abs_err"],
         "ms": fa["ms"], "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
         "bound_by": fa["bound_by"], "library_ms": fa["library_ms"]},
        {"name": "flash_decode", "route": "cuda", "source": FLASH_DECODE_SRC,
         "replaces": "src/repro/kernels/flash_decode.py:108",
         "launches": flash_launches["flash_decode"],
         "max_abs_err": record["flash_decode"]["max_abs_err"],
         "ms": fd["ms"], "plain_ms": fd["plain_ms"], "bound_ms": fd["bound_ms"],
         "bound_by": fd["bound_by"], "library_ms": fd["library_ms"]},
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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--probe":
        sys.exit(probe(sys.argv[2]))
    sys.exit(main())
