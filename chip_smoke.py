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
     path's own input (the N=100_000 cluster, bucket-padded);
     ``commit_topk`` on the top-16 candidates of the same sweeps; and
     ``pack_ffd_tiers`` on random demand (M in {128, 4096}) and on the
     [T, M_b, R] tensor the host scheduler built for the balance's last
     proposal; median CUDA-event time per launch of each kernel and of its
     plain version.
  3. The slice: ``generate_cluster(num_apps=100_000, seed=1)`` and one
     manual_cnst ``Sptlb(cluster).balance("local", timeout_s=30,
     config=CoopConfig())`` with the launch counters zeroed just before and
     read just after (``move_eval_best``, ``commit_topk`` and
     ``pack_ffd_tiers`` must each have launched); then the unfused LocalSearch path
     (``solve_local(move_eval_fn=ops.move_eval)``, the ``move_eval``
     kernel's path) with its own zeroed counts; one short solve under
     ``torch.profiler`` (device busy share, kernel time by name); and the
     N=300 pass on the card and on the CPU's plain path, which must agree
     (same rounds, objective within rel 1e-4, assignments >= 0.98 equal).
  4. A ``{"kernels": [...]}`` line, then the card line again, then the
     final ``{"ok": true, "device": {...}}`` line.

It imports nothing of JAX or of the JAX reference package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bandwidth and the
# f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
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
# Sweeps of the unfused solve (the move_eval kernel's path) and of the
# profiled solve.
UNFUSED_SWEEPS = 32
PROFILE_SWEEPS = 16
MOVE_EVAL_SRC = "src/repro_torch/kernels/csrc/move_eval.cu"
COMMIT_SRC = "src/repro_torch/kernels/csrc/commit.cu"
PACK_SRC = "src/repro_torch/kernels/csrc/pack.cu"


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
    """Hold both move_eval kernels against core.delta on the card."""
    import torch
    from repro_torch.core.delta import move_best_per_app, move_delta_cost
    from repro_torch.kernels import move_eval as K

    N, R = args[0].shape
    T = args[5].shape[0]
    prepared = K.prepare_launch(*args)
    d_kernel = K.launch_move_eval(prepared)
    d_plain = move_delta_cost(*args)
    torch.cuda.synchronize()
    scale = float(d_plain.abs().max()) + 1e-9
    err = float((d_kernel - d_plain).abs().max())
    if not err / scale <= 1e-5:
        raise AssertionError(f"move_eval {label}: scaled error {err / scale:.3e} > 1e-5")
    record["move_eval"]["max_abs_err"] = max(record["move_eval"]["max_abs_err"], err)
    line = f"move_eval      {label:>16}: scaled err {err / scale:.2e}"
    for ml in moves_left_values:
        moves_left = torch.tensor(ml, dtype=torch.int32, device=dev)
        s_k, t_k = K.launch_move_eval_best(prepared, feas, moves_left)
        s_p, t_p = move_best_per_app(*args, feas, moves_left)
        torch.cuda.synchronize()
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
                 f"scaled err {err_b / scale_b:.2e}, tie-flipped tiers {ties}")
    print(line, flush=True)
    return prepared


def time_sweep(args, feas, prepared, dev) -> dict:
    import torch
    from repro_torch.core.delta import move_best_per_app, move_delta_cost
    from repro_torch.kernels import move_eval as K

    N, R = args[0].shape
    T = args[5].shape[0]
    ml = torch.tensor(5, dtype=torch.int32, device=dev)
    out = {}
    for name, kernel, wrapper, plain, best in (
        ("move_eval", lambda: K.launch_move_eval(prepared),
         lambda: K.move_eval_cuda(*args), lambda: move_delta_cost(*args), False),
        ("move_eval_best", lambda: K.launch_move_eval_best(prepared, feas, ml),
         lambda: K.move_eval_best_cuda(*args, feas, ml),
         lambda: move_best_per_app(*args, feas, ml), True),
    ):
        b, by = bound_ms(sweep_bytes(N, T, R, best), sweep_ops(N, T, R, best))
        out[name] = {"ms": time_ms(kernel), "wrapper_ms": time_ms(wrapper),
                     "plain_ms": time_ms(plain), "bound_ms": b, "bound_by": by}
    return out


def commit_inputs(args, feas, moves_left, dev):
    """The commit scan's inputs for one sweep of ``args``: the top-COMMIT_K
    candidates of the ``move_eval_best`` kernel's scores (launched directly,
    so it adds no count), the tier totals and the budget."""
    import torch
    from repro_torch.kernels import move_eval as K

    demand, tasks, crit = args[0], args[1], args[2]
    ml = torch.tensor(moves_left, dtype=torch.int32, device=dev)
    best_s, best_t = K.launch_move_eval_best(K.prepare_launch(*args), feas, ml)
    cand_n = torch.sort(best_s, stable=True).indices[:COMMIT_K]
    totals = torch.stack([torch.clamp(torch.sum(tasks), min=1.0),
                          torch.clamp(torch.sum(crit), min=1.0)])
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
    same accepted moves and status, tier loads within 1e-6 scaled (the
    kernel adds in the same order, so 0 is expected); then time both."""
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
    scale = max(float(want_state[i].abs().max()) for i in (1, 2)) + 1e-9
    if not err / scale <= 1e-6:
        raise AssertionError(f"commit_topk {label}: tier loads differ, scaled {err / scale:.3e}")
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


def check_pack(label, dem, capacity, hosts, pad, record, dev, plain_reps=3):
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
    ms = time_ms(lambda: pack_ffd_tiers_cuda(d, c, h, num_hosts_pad=pad))
    plain_ms = time_ms(lambda: pack_ffd_tiers_ref(d, c, h, num_hosts_pad=pad),
                       reps=plain_reps, warmup=1)
    nbytes, nops = pack_work(dem, capacity, hosts, pad)
    b, by = bound_ms(nbytes, nops)
    print(f"pack_ffd_tiers {label:>22}: T={dem.shape[0]} M_b={dem.shape[1]} rejected "
          f"{int(got.sum())}, mismatches 0, kernel {ms:.4f} ms, plain {plain_ms:.2f} ms "
          f"(median of {plain_reps}), bound {b:.6f} ms ({by})", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by}


def device_profile(fn) -> dict:
    """Run ``fn`` under ``torch.profiler``: wall seconds, the union of the
    card's kernel / copy / memset intervals in the trace (``busy_s``, None
    when the trace holds no device activity), the trace's span from its
    first to its last event, and kernel microseconds by name."""
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
    spans, by_name, lo, hi = [], {}, float("inf"), float("-inf")
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        lo, hi = min(lo, ts), max(hi, ts + dur)
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            spans.append((ts, ts + dur))
            if e["cat"] == "kernel":
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return {"wall_s": wall, "busy_s": busy / 1e6 if spans else None,
            "span_s": (hi - lo) / 1e6 if spans else None, "launches": len(spans),
            "kernels": sorted(by_name.items(), key=lambda kv: -kv[1])}


def host_profile(fn) -> tuple[float, dict]:
    """Run ``fn`` under ``cProfile``: wall seconds and the cumulative seconds
    of the solver's host phases (cProfile's own cost inflates the Python
    parts, so these are shares of a profiled run)."""
    import cProfile
    import pstats

    import torch

    phases = {
        "commit scan (launch)": lambda f, n: n == "commit_topk" and f.endswith("ops.py"),
        "sweep (precompute + kernel launch)": lambda f, n: (
            n == "move_eval_best" and f.endswith("ops.py")),
        "copies and waits for the card": lambda f, n: any(
            f"'{m}' of 'torch._C" in n for m in ("to", "cpu", "tolist", "item")),
        "candidate sort": lambda f, n: n == "<built-in method torch.sort>",
    }
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a card",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core import (CoopConfig, LocalSearchConfig, Sptlb, generate_cluster,
                                  objective, pad_problem, solve_local, validate)
    from repro_torch.core.problem import tier_loads
    from repro_torch.core.hierarchy import HostScheduler
    from repro_torch.kernels import build, ops

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
              "pack_ffd_tiers": {"max_abs_err": 0.0}}

    # -- 2a. sweep kernels at the stated shapes --------------------------------
    sweep_times = {}
    for N, T in ((300, 5), (500, 17), (100_000, 5), (100_000, 128)):
        args, feas = random_sweep(N, T, dev, scale_capacity=N >= 10_000)
        prepared = check_sweep(f"N={N},T={T}", args, feas, (0, 5), record, dev)
        for ml in (0, 5):
            check_commit(f"N={N},T={T},ml={ml}", args, feas, ml, record, dev)
        if N >= 10_000:
            sweep_times[(N, T)] = time_sweep(args, feas, prepared, dev)
            for name, t in sweep_times[(N, T)].items():
                print(f"  time {name:>14} N={N} T={T}: kernel {t['ms']:.4f} ms, with "
                      f"precompute {t['wrapper_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                      f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)

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
    prepared = check_sweep(f"cluster N={Nm},T={Tm}", main_args, main_feas,
                           (int(pp.move_budget),), record, dev)
    main_sweep = time_sweep(main_args, main_feas, prepared, dev)
    main_commit = check_commit(f"cluster N={Nm},T={Tm}", main_args, main_feas,
                               int(pp.move_budget), record, dev)
    for name, tt in main_sweep.items():
        print(f"  time {name:>14} main path N={Nm} T={Tm}: kernel {tt['ms']:.4f} ms, with "
              f"precompute {tt['wrapper_ms']:.4f} ms, plain {tt['plain_ms']:.4f} ms, "
              f"bound {tt['bound_ms']:.4f} ms ({tt['bound_by']})", flush=True)

    # -- 2c. pack on random demand ------------------------------------------
    rng = np.random.default_rng(7)
    for M in (128, 4096):
        T = 5
        dem = rng.lognormal(0.0, 1.0, size=(T, M, 2)).astype(np.float32)
        order = np.argsort(-dem.max(axis=2), axis=1, kind="stable")
        dem = np.take_along_axis(dem, order[:, :, None], axis=1)
        hosts = rng.integers(40, 120, size=T).astype(np.int32)
        capacity = (dem.sum(axis=(0, 1)) / (0.9 * hosts.sum())).astype(np.float32)
        check_pack(f"random M={M}", dem, capacity, hosts, 128, record, dev)

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
                           cluster.hosts_per_tier, host._hosts_pad, record, dev)

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
    if prof["busy_s"] is None:
        print(f"profile: {PROFILE_SWEEPS} sweeps at N={pp.num_apps}, wall {prof['wall_s']:.4f} s;"
              " the profiler saw no device activity (device busy share not measured)",
              flush=True)
    else:
        top = ", ".join(f"{name[:48]} {us / 1e3:.3f} ms" for name, us in prof["kernels"][:6])
        print(f"profile: {PROFILE_SWEEPS} sweeps at N={pp.num_apps}, wall {prof['wall_s']:.4f} s, "
              f"device busy {prof['busy_s']:.4f} s (idle share "
              f"{1.0 - prof['busy_s'] / prof['span_s']:.4f} of the traced span "
              f"{prof['span_s']:.4f} s), {prof['launches']} device launches; "
              f"kernel time by name: {top}", flush=True)

    wall_h, phases = host_profile(lambda: solve_local(
        pp, LocalSearchConfig(max_iters=PROFILE_SWEEPS), device=dev))
    print(f"host profile: {PROFILE_SWEEPS} sweeps at N={pp.num_apps} under cProfile, wall "
          f"{wall_h:.4f} s; cumulative: " + ", ".join(
              f"{label.strip()} {sec:.4f} s ({sec / wall_h:.3f})" for label, sec in phases.items()),
          flush=True)

    # -- 3d. agreement with the plain path on a small input ----------------------
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

    # -- 4. result lines --------------------------------------------------------
    kernels = [
        {"name": "move_eval_best", "route": "cuda", "source": MOVE_EVAL_SRC,
         "replaces": "src/repro/kernels/move_eval.py:275",
         "launches": launches["move_eval_best"],
         "max_abs_err": record["move_eval_best"]["max_abs_err"],
         "ms": main_sweep["move_eval_best"]["ms"],
         "plain_ms": main_sweep["move_eval_best"]["plain_ms"],
         "bound_ms": main_sweep["move_eval_best"]["bound_ms"],
         "bound_by": main_sweep["move_eval_best"]["bound_by"], "library_ms": None},
        {"name": "move_eval", "route": "cuda", "source": MOVE_EVAL_SRC,
         "replaces": "src/repro/kernels/move_eval.py:241",
         "launches": unfused_launches["move_eval"],
         "max_abs_err": record["move_eval"]["max_abs_err"],
         "ms": main_sweep["move_eval"]["ms"],
         "plain_ms": main_sweep["move_eval"]["plain_ms"],
         "bound_ms": main_sweep["move_eval"]["bound_ms"],
         "bound_by": main_sweep["move_eval"]["bound_by"], "library_ms": None},
        {"name": "commit_topk", "route": "cuda", "source": COMMIT_SRC,
         "replaces": "src/repro/core/solver_local.py:219",
         "launches": launches["commit_topk"],
         "max_abs_err": record["commit_topk"]["max_abs_err"],
         "ms": main_commit["ms"], "plain_ms": main_commit["plain_ms"],
         "bound_ms": main_commit["bound_ms"], "bound_by": main_commit["bound_by"],
         "library_ms": None},
        {"name": "pack_ffd_tiers", "route": "cuda", "source": PACK_SRC,
         "replaces": "src/repro/kernels/pack.py:116",
         "launches": launches["pack_ffd_tiers"],
         "max_abs_err": record["pack_ffd_tiers"]["max_abs_err"],
         "ms": pack_main["ms"], "plain_ms": pack_main["plain_ms"],
         "bound_ms": pack_main["bound_ms"], "bound_by": pack_main["bound_by"],
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
