#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tpu_aerial_transport_torch) on one card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no result):

1. build every CUDA kernel of the port from ``tpu_aerial_transport_torch/csrc``
   (one ``nvcc`` per source, all started together) into ``build/kernels``;
2. drive the port's main path -- the headline C-ADMM forest rollout, 256
   scenarios x 8 agents, ``max_iter=20``, ``inner_iters=20``, forest seed 0 --
   through ``harness.rollout.build``: one warm-up MPC step, then
   ``TIMED_STEPS`` timed steps with every launch counter set to 0 just before
   and read just after; the whole-solve kernel must have launched exactly
   once per consensus iteration run, and the states must stay finite;
3. hold each kernel against its plain PyTorch version on the card, on the
   inputs the main path gives it (captured from the warm-up step): the
   headline shapes with and without the cone shift, a ragged lane count, and
   the unpadded agent QPs; time kernel and plain version with CUDA events
   and compute the kernel's bound from this run's shapes;
4. profile one MPC step (``torch.profiler``) and attribute device and host
   time to the ``tat.*`` phases;
5. run the first MPC step of 8 scenarios on the CPU (plain path) and hold
   the card's lanes against it;
6. drive the adaptive headline -- the same rollout with
   ``effort="adaptive"`` through the whole-solve kernel's early-exit form
   -- for one warm-up and ``TIMED_STEPS`` timed steps: the early-exit
   kernel must have launched exactly once per consensus iteration run, the
   inner iterations must be positive and never above n x inner_iters x
   iterations, the states finite; its first step must meet the fixed
   arm's quality (final consensus residual under 1e-2 N wherever the fixed
   arm's is, applied forces within 1e-2 N); then profile one adaptive step;
7. drive DD at 256 x 8 with adaptive effort for one warm-up and
   ``TIMED_STEPS`` timed steps (one early-exit launch per dual-ascent
   iteration) and hold its first step of 8 scenarios against the CPU plain
   path;
8. hold the early-exit kernel against its plain version on inputs captured
   from the adaptive main path (ungated, half the lanes gated off, a ragged
   lane count, a remainder chunk) and from DD's (d = 56): effective
   iteration counts equal in at least 99% of lanes and never more than one
   chunk apart, outputs within the kernel bar on the lanes whose counts
   agree; time both and compute the bound from this run's data;
9. drive the chunked route (``socp_fused="pallas"``), fixed and adaptive,
   for a few steps each: the chunk kernel must have launched exactly once
   per chunk run (counted from each solve's effective iterations), every
   launch its warp body (``warp_chunk_kernel``); then C-ADMM's full QP at
   n = 8 (d = 72) on the same route, every launch the one-block body
   (``admm_chunk_kernel``); hold both bodies against their plain version on
   captured inputs (the headline's with and without the shift, ragged,
   shorter chunks; DD's d = 56 from phase 7; the full QP's) and time each
   body and x-row layout in turns on the same inputs beside the bound;
10-12. the bf16 headline, bf16 DD and the bf16 kernel forms against their
   plain version;
13. the entry step and the centralized rollout, the shared-memory body's
   early form at their d = 67 and 79; then C-ADMM with the full agent QP at
   n = 8 (``reduced_qp=False``, d = 72) fixed, bf16 fixed and bf16 adaptive:
   the shared-memory body's other three forms on a path, checked and
   timed;
14. C-ADMM at n = 3 (the full QP), with ``tau_incr=1.5`` and with
   ``inner_iters_warm=10``;
15. agent-sharded C-ADMM (n = 8, one agent a shard, 8 shards on the card,
   ``max_iter=20``, inner 20; the JAX bench's ``cadmm_n8_sharded``) at 256
   scenarios with ``consensus_impl="pallas_ring"``: one warm-up and
   ``TIMED_STEPS`` timed steps, one whole-solve launch and two ring-sum
   launches per consensus iteration run, finite states; then the three
   exchange impls in turns, ``CHUNK_STEPS`` steps each;
16. agent-sharded DD (``dd_n16_sharded``: n = 16 over 8 shards, inner 40)
   likewise, five ring-sum launches per dual-ascent iteration; then with
   ``effort="adaptive"`` for ``CHUNK_STEPS`` steps: one early-exit launch
   an iteration, five ring sums an iteration and one a step (the
   inner-iteration total), its first step against the CPU;
17. the exchange A/B at the JAX sweep's shape: C-ADMM and DD at n = 64
   over 8 shards, one scenario, ``max_iter=8``, each impl in turns;
18. the ring-sum kernel against its plain version (bitwise) and the float64
   sum, on the payloads captured from 15-17 and random ones at d in {2, 3,
   4, 8, 16, 32 (the cap)}, ragged; timed at the phase-15 and n = 64
   payloads beside the plain version and one PyTorch sum; one sharded step
   profiled;
19. the first sharded step of 15 and 16 against the CPU (which runs the
   kernel's plain version) on 8 scenarios, and against the single program
   on the card;
20. the centralized controller where the whole-solve kernel cannot hold
   its QP (more than 16 SOC blocks): n = 16 at 1 and 256 scenarios and
   n = 64 at 1 (the JAX bench's ``centralized_n{16,64}_single``), each on
   the route the solver's resolver names, which must be ``"scan"``, with
   no kernel launched, finite states, and n = 16's first step of 8
   scenarios against the CPU.
21. the CUDA-graph substeps: on the headline state after a warm-up step,
   the graph replay bitwise equal to the eager substeps, and the entry
   period's physics likewise; eager and graph substeps timed in turns; the
   fixed headline with the graph on and off in turns, one step of each
   profiled; the entry's periods/s with and without the graph;
22. the logged rollout through ``harness.rollout.jit_rollout``: C-ADMM at
   256 x 8 with the forest reference for ``LOG_STEPS`` high-level steps,
   every log leaf finite, one whole-solve launch per consensus iteration
   run, and the first 8 scenarios' logs against the CPU's eager rollout;
23. the bucketing A/B: ``buckets=0`` and ``buckets=2`` at 256 x 8 in
   turns, per-scenario results equal, both rates and the iterations each
   bucket ran;
24. the padded tier: ``solve_socp_padded`` on the headline set-up's
   unpadded agent QPs on routes "kernel" and "pallas", against
   ``solve_socp`` on the same QPs, the resolved route and the launched
   body by name, both timed;
25. the environment-query A/B (the JAX bench's env cells): 64 scenarios x
   10 query steps through ``collision_cbf_rows`` at T = 200, 4096 and
   65536 trees, dense and bucketed in turns; batched queries/s, the grid's
   occupancy and build time, each arm's peak device memory, and the
   bucketed rows bitwise equal to the dense rows at every step;
26. the city world on the main path: the city example's 16384-tree world
   with its grid, C-ADMM at 256 x 8 through ``jit_rollout`` with
   ``env_query="auto"`` resolved to "bucketed", one whole-solve launch per
   consensus iteration, against the CPU; the first step's bucketed
   per-agent rows bitwise equal to the dense rows; one step profiled
   (``tat.env_query``); DD likewise against the CPU;
27. the sliding-mode SO(3) law: the graph replay of the headline's ten SM
   substeps bitwise equal to the eager substeps, both timed in turns, and
   3 MPC steps with the SM law against the CPU;
28. ``jit_control_step`` of C-ADMM and DD at 256 x 8, 3 steps each:
   outputs bitwise equal to ``control``, the donated state in the storage
   passed in;
29. the resilient headline: C-ADMM at 256 x 8 in the seed-0 forest through
   ``resilience.jit_resilient_rollout``, one fault schedule a scenario (by
   index mod 4: none, agent 0 lost at step 3, 30% consensus dropout held 2
   steps, agent 5 at 0.6 thrust with 0.01 sensor noise; the last scenario
   an infinite thrust scale from step 4), 10 steps after a warm-up call:
   the fault masks bitwise the CPU's, one ``warp_solve_kernel`` launch per
   consensus iteration, the last scenario quarantined and frozen and every
   other scenario bitwise a run whose last scenario is benign, lost agents'
   forces exactly 0, the first 8 scenarios against the CPU, and
   ``faults=None``/``no_faults`` bitwise ``jit_rollout``; each group's
   rungs and carried load, the resilient and plain rates in turns, one
   profiled step's ``tat.faults``/``tat.fallback``;
30. DD (adaptive) with agent 0 lost at step 1 in every scenario, 3 steps
   through ``make_dd_hl_step``: one ``warp_solve_early_kernel`` launch per
   iteration, the first 8 scenarios against the CPU: counts and rungs
   equal, step 0 within DD's 2e-3 N (after the loss DD does not converge,
   in the JAX package as here, and the distance is printed);
31. the run-health telemetry: the headline through ``jit_rollout`` with
   ``TelemetryConfig(track_agents=True)``, 10 steps: the accumulator
   against a host recount from the logs, the P² markers against a host
   replay and its accuracy bound over a long stream on the card; ms a step
   with telemetry on and off in turns;
32. sharded health: phase 29's schedules over 8 shards with
   ``pallas_ring``, 3 steps, against the single program; ring-sum launches
   counted;
33. chunked rollouts and crash recovery at 256 x 8: ``make_chunked_rollout``
   (12 steps in 4 chunks) bitwise ``jit_rollout`` with one substeps capture
   and equal ``warp_solve_kernel`` launches, the two rates in turns and the
   cost of a boundary publish; a child process (this script with
   ``--recovery-child preempt``) runs it through ``run_chunks`` and stops
   at chunk 1's boundary on its own SIGTERM, the parent flips a payload
   byte of that boundary's carry snapshot, and a second child
   (``--recovery-child resume``) resumes past it, bitwise the
   uninterrupted run by per-leaf sha256; the resilient headline with phase
   29's schedules through ``make_chunked_resilient_rollout``, bitwise
   ``jit_resilient_rollout``, preempted and resumed in-process with the
   NaN scenario's quarantine flag in the carry; the journal's events and
   the metrics file checked.

The main path and every bench path replay the ten substeps of a step from
a CUDA graph (``harness.cuda_graph``); phase 2 checks it did.

The whole-solve kernel has two bodies, chosen from the QP's shape alone:
one warp per lane (``warp_solve_*kernel``) for every agent QP (nv and m at
most 32), one block per lane (``fused_solve_*kernel``) for the centralized
QPs and C-ADMM's full QP at n = 8. The chunk kernel has the same two
bodies (``warp_chunk_kernel``, ``admm_chunk_kernel``). Every timed
kernel line carries the kernel's bound, its earlier time from PERF.md
(``EARLIER_MS``), the other body's time on the same inputs in turns where
there is one, registers, spill bytes and resident lanes an SM; each timed
path checks by kernel name which body ran.

The kernel bar is 1e-4 x max(1, |ref|) for every output, or twice the
plain version's own float32 rounding (its distance from the same plain
version run in float64) where that is larger: DD's duals carry 400 times
the rounding of A x (``ROUNDING_FACTOR``).

The children of phase 33 print one ``recovery-child`` record each and
never the result line.

Output: timing lines carry the card's name and power limit; a ``kernels``
JSON line, the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. The full report is written as JSON to
``build/chip_smoke.json``, or to the path in ``TAT_SMOKE_REPORT``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "tpu_aerial_transport_torch"
# The port's kernels by their __global__ names (no name is a substring of
# another), and the phase their device time is attributed to.
OWN_KERNELS = {"fused_solve_kernel": "fused_solve",
               "fused_solve_early_kernel": "fused_solve_early",
               "fused_solve_bf16_kernel": "fused_solve_bf16",
               "fused_solve_early_bf16_kernel": "fused_solve_early_bf16",
               "warp_solve_kernel": "fused_solve",
               "warp_solve_early_kernel": "fused_solve_early",
               "warp_solve_bf16_kernel": "fused_solve_bf16",
               "warp_solve_early_bf16_kernel": "fused_solve_early_bf16",
               "admm_chunk_kernel": "admm_chunk",
               "warp_chunk_kernel": "admm_chunk",
               "ring_sum_kernel": "ring_sum"}
# Each kernel's earlier time at the shapes timed here, from PERF.md's kernel
# table (NVIDIA H100 80GB HBM3, 700.00 W): the whole-solve kernel's
# one-block-a-lane body at the agent QPs, the cluster ring sum and the chunk
# kernel's one-block body at the headline. The shared-memory body's shapes
# (m > 32 or nv > 32) had no timed row.
EARLIER_MS = {"warp_solve_kernel": 0.0623, "warp_solve_early_kernel": 0.0656,
              "warp_solve_bf16_kernel": 0.0705,
              "warp_solve_early_bf16_kernel": 0.1598,
              "ring_sum_kernel": 0.0060, "admm_chunk_kernel": 0.0504}

N_AGENTS, N_SCENARIOS, TIMED_STEPS = 8, 256, 10
# Steps of each chunked-route arm (fixed and adaptive), after a warm-up.
CHUNK_STEPS = 3
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
# Kernel against its plain version: both float32 on the card; the matvec
# sums run in another order (sequential FMA in the kernel, cuBLAS in the
# plain version) and 20 iterations with 1e3-boosted equality penalties
# amplify that rounding. The bar is the JAX package's own for its compiled
# kernel form (atol 1e-4 after 30 iterations), scaled by the output's size.
KERNEL_ATOL = 1e-4
CPU_STATE_ATOL = 1e-4
CPU_FORCE_ATOL = 1e-2  # the consensus tolerance res_tol, in N.
# Adaptive against fixed effort: the JAX package's equal-quality bar
# (ops/socp.py resolve_effort), the consensus tolerance in N.
EFFORT_BAR = 1e-2
# Early-exit kernel against its plain version: the sums run in another
# order, so a lane whose residual sits at tol at a chunk boundary may stop
# one chunk apart (the JAX package allows the same between its two kernel
# bodies, tests/test_effort.py:252-254).
EFF_EQUAL_SHARE = 0.99
# Where the plain version's own float32 rounding is larger than the kernel
# bar -- DD's duals: y moves by rho (Ax_rel - z) with rho = 400 on its nine
# equality rows, so a last-bit difference in Ax_rel shows in y 400 times
# larger -- an output may differ from it by up to this many times its
# distance from the same plain version run in float64.
ROUNDING_FACTOR = 2.0
# Phases 15-19, the agent-sharded paths: d = 8 shards on the card (the
# JAX package's one-agent-a-device mesh for C-ADMM at n = 8), configured
# as the JAX bench's multichip configs (bench.py:2526-2543) at the
# headline's 256 scenarios and its exchange A/B cells at n = 64
# (bench.py:1196-1264).
SHARDS = 8
SHARDED = {"cadmm_n8_sharded": ("cadmm", 8, dict(inner_iters=20)),
           "dd_n16_sharded": ("dd", 16, dict(inner_iters=40))}
EXCHANGE_AB = {"cadmm_n64": ("cadmm", 64, dict(max_iter=8, inner_iters=20)),
               "dd_n64": ("dd", 64, dict(max_iter=8, inner_iters=40))}
# Ring-sum launches per consensus (C-ADMM) or dual-ascent (DD) iteration
# with fixed effort: C-ADMM sums the consensus mean and the solve-success
# count, DD the two price sums, the two violation sums and the count.
RING_SUMS = {"cadmm": 2, "dd": 5}
# The sharded step against the single program on the card: the bar of the
# JAX package's own ring-vs-allreduce parity (tests/test_ring.py:172) on
# the scenarios whose iteration counts agree, which must be this share.
SHARDED_FORCE_BAR = 2e-3
SHARDED_EQUAL_SHARE = 0.99
# The ring sum against the float64 sum: float32 rounding of d <= 8 adds.
RING_SUM_RTOL = 1e-6
# Phases 21-23: MPC steps of each arm of the graph on/off A/B, high-level
# steps of the logged rollout, MPC steps of each arm of the bucketing A/B.
GRAPH_STEPS, LOG_STEPS, BUCKET_STEPS = 5, 3, 3
# Bucketed against unbucketed where a library path's result depends on the
# batch size (a batched inverse or product choosing another algorithm for
# B / 2 lanes): the iteration counts must still be equal and every state
# and controller-state leaf within this.
BUCKET_STATE_ATOL = 1e-6
# Phase 25, the environment-query A/B at the JAX bench's env cells
# (bench.py:1040-1140): world sizes, the city worlds' tree density
# (ENV_CELL_DENSITY there), scenarios, query steps, timed runs of each arm.
ENV_TREES = (200, 4096, 65536)
ENV_CELL_DENSITY = 0.085
ENV_SCENARIOS, ENV_STEPS, ENV_REPEATS = 64, 10, 3
# Phase 26, the city example's default world (examples/city_forest.py), and
# the high-level steps of its rollouts; phase 27's SM-law MPC steps; phase
# 28's jit_control_step steps.
CITY_TREES = 16384
CITY_STEPS, SM_STEPS, JIT_STEPS = 3, 3, 3
# Phases 29-32, the resilience tier: high-level steps of the resilient
# headline and of the telemetry run, of the resilient headline's CPU
# comparison, of DD with a lost agent and of the sharded run with faults;
# the step from which the last scenario's thrust scale is infinite.
RES_STEPS, RES_CPU_STEPS, DD_FAULT_STEPS, SHARDED_FAULT_STEPS = 10, 4, 3, 3
KILL_STEP = 4
# Sensor noise on the card against the CPU: erf^-1's log1p and sqrt may
# round an ulp apart (tests/test_torch_faults.py).
NOISE_ATOL = 2e-6
# DD's force bar (tests/test_torch_dd.py), and the sharded-against-single
# bar of tests/test_torch_parallel.py for C-ADMM.
DD_FORCE_BAR = 2e-3
SHARDED_HEALTH_BAR = 1e-4
# Phase 33, chunked rollouts and crash recovery: high-level steps and chunks
# of every chunked run, the chunk whose boundary the preempted child stops
# at, and the timed boundary publishes.
REC_STEPS, REC_CHUNKS, REC_STOP_CHUNK, REC_PUBLISHES = 12, 4, 1, 3
# P²: the card's markers against a host replay of the estimator (float32
# rounding), and the accuracy bound of tests/test_telemetry.py:97 against
# np.percentile on that test's stream of P2_STREAM observations.
P2_RTOL, P2_BOUND, P2_STREAM = 1e-5, 0.08, 4000


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``: ``reps`` calls captured in
    one CUDA graph, replayed and timed with CUDA events, so the host's
    launch overhead (which on a shared host can exceed a short kernel's
    run time) does not enter the number."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def event_ms(fn, reps: int) -> float:
    """Device-clock milliseconds per call of ``fn`` between two CUDA events
    around ``reps`` host-driven calls, for functions that synchronise with
    the host inside (a graph cannot capture them): the number includes the
    host's pauses between the calls' kernels."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def capturing(module, name: str, store: list, when=lambda kw: True):
    """Record (clones of) the arguments of the first call of
    ``module.<name>`` whose keywords satisfy ``when``."""
    fn = getattr(module, name)

    def wrapper(*args, **kw):
        if not store and when(kw):
            store.append(([None if a is None else a.clone() for a in args],
                          dict(kw)))
        return fn(*args, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def zero_launches() -> None:
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.parallel import ring

    for counts in (admm_kernel.LAUNCHES, ring.LAUNCHES,
                   admm_kernel.KERNEL_LAUNCHES, admm_kernel.CHUNK_LAUNCHES):
        for k in counts:
            counts[k] = 0


def check_body(launches, form, name, what) -> int:
    """In the run just counted (``launches``, every counter zeroed before
    it), every launch of whole-solve form ``form`` went to entry point
    ``name`` and no other whole-solve entry point launched: which body ran,
    by kernel name. Returns the count."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    by_name = {k: v for k, v in admm_kernel.KERNEL_LAUNCHES.items() if v}
    if by_name != {name: launches[form]}:
        fail(f"{what}: {launches[form]} {form} launches ran as {by_name}, "
             f"expected all {name}")
    return launches[form]


def launch_counts() -> dict:
    """Every kernel's launch counter, by kernel."""
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.parallel import ring

    return {**admm_kernel.LAUNCHES, **ring.LAUNCHES}


def applied_forces(css):
    """Each agent's applied force, the diagonal of its copies."""
    import torch

    ids = torch.arange(css.f.shape[-2], device=css.f.device)
    return css.f[:, ids, ids, :]


def bound(bytes_, flops):
    """``(bound_ms, bound_by)``: the larger of moving ``bytes_`` at the
    card's memory rate and doing ``flops`` at its float32 rate."""
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_summary(log: str) -> dict:
    """Per entry function of ``nvcc -Xptxas -v``'s output: registers a
    thread and spill bytes (stores + loads)."""
    import re

    funcs, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            funcs[cur] = {"registers": 0, "spill_bytes": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            funcs[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            funcs[cur]["registers"] = int(m.group(1))
    return funcs


def entry_name(args, kw) -> str:
    """The whole-solve entry point a call with these captured inputs
    takes: the body from d, the form and the storage."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    geo = admm_kernel.fused_solve_geometry(kw["nv"], args[8].shape[-1])
    early = admm_kernel._early(kw.get("check_every", 0), kw.get("tol", 0.0))
    return admm_kernel.KERNEL_NAMES[geo.body, early,
                                    kw.get("precision", "f32")]


def kernel_timing(what, args, kw, bound_ms, card, reps=100) -> dict:
    """The whole-solve kernel on one captured case, timed (CUDA graph)
    beside its bound and its earlier time (EARLIER_MS); at an agent QP in
    turns with the shared-memory body on the same inputs (warp, shared,
    shared, warp); and what the build made of it (registers, spill bytes,
    resident lanes an SM from the occupancy calculator), whose launch
    shape must be the wrapper's."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    nv, m = kw["nv"], args[8].shape[-1]
    early = admm_kernel._early(kw.get("check_every", 0), kw.get("tol", 0.0))
    geo = admm_kernel.fused_solve_geometry(nv, m)
    info = admm_kernel.fused_solve_info(
        nv, m, early=early, precision=kw.get("precision", "f32"))
    if (info["lanes_per_block"], info["threads"],
            info["smem_bytes"]) != tuple(geo[1:]):
        fail(f"{what}: the library launches {info}, the wrapper's geometry "
             f"is {geo}")

    def run(body):
        return cuda_ms(lambda: admm_kernel.fused_solve_lanes(
            *args, **kw, body=body), reps)

    turns = {}
    bodies = (("warp", "shared", "shared", "warp") if geo.body == "warp"
              else ("shared",))
    for body in bodies:
        turns.setdefault(body, []).append(run(body))
    ms = sum(turns[geo.body]) / len(turns[geo.body])
    earlier = EARLIER_MS.get(info["name"])
    other = (f"; in turns with the shared-memory body on the same inputs: "
             f"warp {turns['warp'][0]:.4f} and {turns['warp'][1]:.4f}, "
             f"shared {turns['shared'][0]:.4f} and {turns['shared'][1]:.4f}"
             if geo.body == "warp" else "")
    print(f"{info['name']} ({what}, B={args[0].shape[0]}, d={nv + m}): "
          f"{ms:.4f} ms/launch (CUDA graph){other}; bound {bound_ms:.4f} ms "
          f"({ms / bound_ms:.1f}x); earlier "
          + (f"{earlier:.4f} ms (PERF.md)" if earlier else "not recorded")
          + f" | {info['registers']} registers, {info['local_bytes']} B "
          f"local (spills), {info['lanes_per_sm']} lanes resident an SM "
          f"({info['lanes_per_block']} a block, {info['smem_bytes']} B "
          f"shared a block) | {card}", flush=True)
    return {"ms": ms, "turns_ms": turns, "bound_ms": bound_ms,
            "earlier_ms": earlier, **info}


def solve_row(timing, launches, err, plain_ms, bound_by) -> dict:
    """A whole-solve entry point's row of the kernels line."""
    return {
        "name": timing["name"], "route": "cuda",
        "source": f"{PKG}/csrc/fused_solve.cu",
        "replaces": "tpu_aerial_transport/ops/admm_kernel.py:283",
        "launches": launches, "max_abs_err": err, "ms": timing["ms"],
        "plain_ms": plain_ms, "bound_ms": timing["bound_ms"],
        "bound_by": bound_by, "library_ms": None,
    }


def own_in_trace(prof) -> dict:
    """Launches of each of the port's kernels in a trace, by name."""
    found = {}
    for e in prof.key_averages():
        for name in OWN_KERNELS:
            if name in e.key:
                found[name] = found.get(name, 0) + int(e.count)
    return found


def per_launch_us(prof, kernel: str):
    """Device microseconds per launch of ``kernel`` in a trace, or None."""
    rows = [e for e in prof.key_averages() if kernel in e.key]
    if not rows:
        return None
    tot = getattr(rows[0], "device_time_total", None)
    if tot is None:
        tot = getattr(rows[0], "cuda_time_total", 0.0)
    return float(tot) / max(int(rows[0].count), 1)


def phase_breakdown(prof) -> dict:
    """Device and host microseconds per innermost ``tat.*`` phase."""
    def dev(ev):
        v = getattr(ev, "self_device_time_total", None)
        return v if v is not None else getattr(ev, "self_cuda_time_total", 0)

    device, host = {}, {}

    def walk(ev, phase):
        if ev.name.startswith("tat."):
            phase = ev.name[4:]
        device[phase] = device.get(phase, 0.0) + float(dev(ev))
        host[phase] = host.get(phase, 0.0) + float(ev.self_cpu_time_total)
        for ch in ev.cpu_children:
            walk(ch, phase)

    kernels_us = 0.0
    own_us = {phase: 0.0 for phase in OWN_KERNELS.values()}
    for ev in prof.events():
        kind = str(ev.device_type)
        if ev.cpu_parent is None and kind.endswith("CPU"):
            walk(ev, "other")
        elif kind.endswith("CUDA") and not (
                getattr(ev, "is_user_annotation", False)
                or ev.name.startswith("tat.")):
            kernels_us += float(ev.device_time_total)
            for kname, phase in OWN_KERNELS.items():
                if kname in ev.name:
                    own_us[phase] += float(ev.device_time_total)
    # The port's own kernels launch through their library's statically
    # linked runtime, which the trace does not tie to a host range: they
    # are named here, and only what remains is unattributed.
    for phase, us in own_us.items():
        device[phase] = device.get(phase, 0.0) + us
    device["unattributed"] = max(kernels_us - sum(device.values()), 0.0)
    return {"device_us": device, "host_us": host, "kernels_us": kernels_us}


def first_step_quality(fixed, adaptive):
    """The equal-quality bar of adaptive against fixed effort on the same
    first step: ``fixed``/``adaptive`` are ``(css, states, stats)``."""
    res_f, res_a = fixed[2].solve_res, adaptive[2].solve_res
    good = res_f < EFFORT_BAR
    worse = int((good & ~(res_a < EFFORT_BAR)).sum())
    f_err = float((applied_forces(adaptive[0])
                   - applied_forces(fixed[0])).abs().max())
    return {"fixed_res_max": float(res_f.max()),
            "adaptive_res_max": float(res_a.max()),
            "scenarios_under_bar_fixed": int(good.sum()),
            "lost_the_bar": worse, "force_err": f_err,
            "ok": worse == 0 and f_err <= EFFORT_BAR}


def timed_steps(mpc_step, css, states, n_steps):
    """``n_steps`` MPC steps from ``(css, states)`` with every launch
    counter set to 0 just before and read just after: ``(css, states,
    iters (n_steps, S), inner (n_steps, S) or None, seconds, launches,
    the last step's stats)``."""
    import torch

    iters, inner = [], []
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        css, states, stats = mpc_step(css, states)
        iters.append(stats.iters)
        inner.append(stats.inner_iters)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = launch_counts()
    inner = torch.stack(inner) if inner[0].numel() else None
    return css, states, torch.stack(iters), inner, elapsed, launches, stats


def forces_of(css):
    """The forces a controller state carries: the consensus copies
    (C-ADMM), the own forces (DD) or the previous forces (centralized)."""
    return css.prev_f if hasattr(css, "prev_f") else css.f


def check_states(css, states, what):
    import torch

    for f in ("R", "w", "xl", "vl", "Rl", "wl"):
        if not bool(torch.isfinite(getattr(states, f)).all()):
            fail(f"{what}: non-finite state field {f}")
    if not bool(torch.isfinite(forces_of(css)).all()):
        fail(f"{what}: non-finite forces")


def check_launches(launches, kernel, expected, what):
    """``kernel`` launched exactly ``expected`` (> 0) times in the run and
    no other kernel launched."""
    check_launch_counts(launches, {kernel: expected}, what)


def check_launch_counts(launches, expected: dict, what):
    """Each kernel of ``expected`` launched exactly that many (> 0) times
    in the run, and no other kernel launched."""
    for kernel, n in expected.items():
        if launches[kernel] <= 0:
            fail(f"{what} never launched the {kernel} kernel")
        if launches[kernel] != n:
            fail(f"{what}: {kernel} launches {launches[kernel]} != {n}")
    others = {k: v for k, v in launches.items() if k not in expected and v}
    if others:
        fail(f"{what} launched other kernels too: {others}")


def agreement(names, got, ref, ref64, lanes_ok=None):
    """Per output: the kernel's largest difference from its plain version,
    the plain version's own float32 rounding (its difference from the plain
    version in float64), and whether the kernel is within the bar
    ``max(KERNEL_ATOL x max(1, |ref|), ROUNDING_FACTOR x rounding)``, on
    the lanes ``lanes_ok`` (all when None)."""
    import torch

    errs, noise, ok = {}, {}, True
    for nm, g, r, r64 in zip(names, got, ref, ref64):
        if lanes_ok is not None:
            g, r, r64 = g[lanes_ok], r[lanes_ok], r64[lanes_ok]
        if not g.numel():
            errs[nm] = noise[nm] = 0.0
            continue
        errs[nm] = float((g - r).abs().max())
        noise[nm] = float((r.double() - r64).abs().max())
        bar = max(KERNEL_ATOL * max(1.0, float(r.abs().max())),
                  ROUNDING_FACTOR * noise[nm])
        ok = ok and errs[nm] <= bar and bool(torch.isfinite(g).all())
    return errs, noise, ok


def in_float64(args):
    return [a.double() if a is not None and a.is_floating_point() else a
            for a in args]


def plain64(args, kw):
    """The whole-solve plain version in float64 on the same inputs: bf16
    operators upcast exactly, so it runs the plain math on the rounded
    operators."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    return admm_kernel.fused_solve_lanes_reference(
        *in_float64(args), **dict(kw, precision="f32"))


def check_early_exit(cases, card, chunks_apart=1):
    """The early-exit kernel against its plain version on each case
    ``(name, args, kw)``; returns the per-case report and the largest
    error on the lanes whose effective counts agree. Counts must be equal
    in EFF_EQUAL_SHARE of the lanes and at most ``chunks_apart`` chunks
    apart (None: any)."""
    import torch

    from tpu_aerial_transport_torch.ops import admm_kernel

    names = ("x", "y", "z", "prim_res", "dual_res")
    checks, worst = {}, 0.0
    for case, a, k in cases:
        got = admm_kernel.fused_solve_lanes(*a, **k)
        ref = admm_kernel.fused_solve_lanes_reference(*a, **k)
        ref64 = plain64(a, k)
        torch.cuda.synchronize()
        same = got[5] == ref[5]
        share = float(same.float().mean())
        apart = int((got[5] - ref[5]).abs().max())
        errs, noise, ok = agreement(names, got[:5], ref[:5], ref64[:5],
                                    same & (ref64[5] == ref[5]))
        ok = ok and share >= EFF_EQUAL_SHARE and (
            chunks_apart is None or apart <= chunks_apart * k["check_every"])
        worst = max(worst, max(errs.values()))
        B = a[0].shape[0]
        gated = a[12] is not None and not bool(a[12].all())
        print(f"early-exit check {case}: B={B} d={k['nv'] + a[8].shape[-1]} "
              f"{a[3].dtype} "
              f"iters={k['iters']} check_every={k['check_every']} "
              f"tol={k['tol']} gated_off={int((~a[12]).sum()) if gated else 0}"
              f" eff equal in {share * 100:.2f}% of lanes, at most {apart} "
              f"apart, mean {float(got[5].float().mean()):.2f}; max|err| on "
              f"equal lanes " + " ".join(f"{n}={e:.3e}" for n, e in
                                         errs.items())
              + "; plain float32 vs float64 "
              + " ".join(f"{n}={e:.3e}" for n, e in noise.items())
              + f" (bar max({KERNEL_ATOL} x max(1, |ref|), "
              f"{ROUNDING_FACTOR} x that)) "
              + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
        checks[case] = {"B": B, "eff_equal_share": share, "eff_apart": apart,
                        "max_abs_err": errs, "plain_f32_vs_f64": noise,
                        "ok": ok}
        if not ok:
            fail(f"early-exit kernel disagrees with its plain version on "
                 f"{case}")
    return checks, worst


def early_exit_bound(args, kw, eff):
    """Bytes and operations one early-exit launch must move and do on this
    data: a gated-off lane needs neither K2 nor Minv and iterates 0 times;
    a lane that ran c chunks checked its residuals c + 1 times before the
    exit residuals."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    nv, n_box, soc = kw["nv"], kw["n_box"], tuple(kw["soc_dims"])
    m = args[8].shape[-1]
    gate = args[12]
    on = [True] * len(eff) if gate is None else gate.tolist()
    bytes_ = flops = 0
    for g, e in zip(on, eff.tolist()):
        bytes_ += admm_kernel.fused_solve_bytes_per_lane(
            nv, m, n_box, early=True, gated_off=not g,
            precision=kw.get("precision", "f32"))
        checks = (e // kw["check_every"] + 1) if g else 0
        flops += admm_kernel.fused_solve_flops_per_lane(
            nv, m, e, soc, residual_checks=checks + 1, build=g)
    return bytes_, flops


STATE_FIELDS = ("R", "w", "xl", "vl", "Rl", "wl")


def workload(controller, n, n_scenarios, device="cuda", **kw):
    """``(mpc_step, css0, states0)``: the bench set-up of
    ``rollout.make_mpc_step`` over the headline's seeded scenario batch."""
    from tpu_aerial_transport_torch.harness import rollout

    step, cs0, st0 = rollout.make_mpc_step(controller, n, device=device, **kw)
    return (step, rollout.stack_scenarios(cs0, n_scenarios),
            rollout.scenario_batch(st0, n_scenarios))


def card_vs_cpu(what, controller, n, first, card, n_cpu=8, **kw):
    """The card's first MPC step (``first = (css, states, stats)`` from the
    seeded batch) against the CPU plain path's on its first ``n_cpu``
    scenarios: states within CPU_STATE_ATOL, forces within CPU_FORCE_ATOL
    and equal iteration counts, or the run fails."""
    if controller != "centralized":
        kw = dict(kw, pad_operators=True)  # the card's operator layout.
    step, css, states = workload(controller, n, n_cpu, device="cpu", **kw)
    css_c, st_c, stats_c = step(css, states)
    css_g, st_g, stats_g = first
    cut = lambda t: t[:n_cpu].cpu()  # noqa: E731
    errs = {f: float((getattr(st_c, f) - cut(getattr(st_g, f))).abs().max())
            for f in STATE_FIELDS}
    f_err = float((forces_of(css_c) - cut(forces_of(css_g))).abs().max())
    it_card = cut(stats_g.iters).tolist()
    it_cpu = stats_c.iters.tolist()
    ok = (max(errs.values()) <= CPU_STATE_ATOL and f_err <= CPU_FORCE_ATOL
          and it_card == it_cpu)
    print(f"{what} card vs CPU, first MPC step of {n_cpu} scenarios: "
          f"max|state err| {max(errs.values()):.2e} (atol {CPU_STATE_ATOL}),"
          f" max|force err| {f_err:.2e} N (atol {CPU_FORCE_ATOL}), "
          f"iterations card {it_card} CPU {it_cpu} "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    if not ok:
        fail(f"{what}: the card's first step disagrees with the CPU")
    return {"state_err": errs, "force_err": f_err, "iters_card": it_card,
            "iters_cpu": it_cpu}


def check_fixed_forms(cases, card):
    """The fixed-iteration form (either storage) against its plain version
    on each case ``(name, args, kw)``, at the kernel bar; returns the
    per-case report and the largest error."""
    import torch

    from tpu_aerial_transport_torch.ops import admm_kernel

    names = ("x", "y", "z", "prim_res", "dual_res")
    checks, worst = {}, 0.0
    for case, a, k in cases:
        got = admm_kernel.fused_solve_lanes(*a, **k)
        ref = admm_kernel.fused_solve_lanes_reference(*a, **k)
        ref64 = plain64(a, k)
        torch.cuda.synchronize()
        errs, noise, ok = agreement(names, got, ref, ref64)
        worst = max(worst, max(errs.values()))
        print(f"kernel check {case}: B={a[0].shape[0]} "
              f"d={k['nv'] + a[8].shape[-1]} {a[3].dtype} iters={k['iters']}"
              f" shift={a[11] is not None} max|err| "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + "; plain float32 vs float64 "
              + " ".join(f"{n}={e:.3e}" for n, e in noise.items())
              + " " + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
        checks[case] = {"B": a[0].shape[0], "max_abs_err": errs,
                        "plain_f32_vs_f64": noise, "ok": ok}
        if not ok:
            fail(f"kernel disagrees with its plain version on {case}")
    return checks, worst


def fixed_form(args, kw):
    """An early-exit call's inputs as a fixed-iteration call's."""
    return args[:12], {k: v for k, v in kw.items()
                       if k not in ("check_every", "tol")}


def bf16_phases(card, report, lanes):
    """Phases 10-12: the bf16 headline (C-ADMM), DD with bf16, and the bf16
    kernel forms against their plain version. Returns the two bf16 rows
    of the kernels line."""
    import torch

    from tpu_aerial_transport_torch.ops import admm_kernel

    # 10. The bf16 headline: 256 x 8 C-ADMM, fixed effort, bf16 storage.
    step_b, css0, st0 = workload("cadmm", N_AGENTS, N_SCENARIOS,
                                 socp_precision="bf16")
    step_f, _, _ = workload("cadmm", N_AGENTS, 1, socp_precision="f32")
    b_args = []
    with capturing(admm_kernel, "fused_solve_lanes", b_args):
        first_b = step_b(css0, st0)
    torch.cuda.synchronize()
    css_b, st_b, iters_b, _, secs_b, launches_b, stats_b = timed_steps(
        step_b, css0, st0, TIMED_STEPS)
    runs_b = int(iters_b.max(dim=1).values.sum())
    check_launches(launches_b, "fused_solve_bf16", runs_b, "the bf16 headline")
    if not b_args:
        fail("no bf16 call captured in the bf16 headline's warm-up step")
    check_body(launches_b, "fused_solve_bf16", entry_name(*b_args[0]),
               "the bf16 headline")
    check_states(css_b, st_b, "the bf16 headline")
    # In turns: bf16 (above), f32, bf16, f32.
    *_, secs_f, _, stats_f = timed_steps(step_f, css0, st0, TIMED_STEPS)
    secs_b2 = timed_steps(step_b, css0, st0, TIMED_STEPS)[4]
    secs_f2 = timed_steps(step_f, css0, st0, TIMED_STEPS)[4]
    rate = lambda secs: N_SCENARIOS * TIMED_STEPS / secs  # noqa: E731
    res_b = float(stats_b.solve_res.max())
    res_f = float(stats_f.solve_res.max())
    # The JAX bench's bf16 gate (bench.py:881-907): a finding, not a failure.
    verdict = ("bf16" if res_b < EFFORT_BAR else
               "bf16_refused" if res_f < EFFORT_BAR else
               "res_bar_inconclusive")
    it_b = iters_b.to(torch.float32)
    print(f"bf16 headline: {N_SCENARIOS}x{N_AGENTS} C-ADMM forest, fixed "
          f"effort, socp_precision bf16, {TIMED_STEPS} MPC steps in "
          f"{secs_b:.4f} s = {rate(secs_b):.2f} scenario-MPC-steps/s | "
          f"consensus iters/step mean {float(it_b.mean()):.3f} max "
          f"{int(iters_b.max())} | launches {launches_b} = consensus "
          f"iterations run {runs_b} | {card}", flush=True)
    print(f"bf16 vs f32 in turns (bf16, f32, bf16, f32): "
          f"{rate(secs_b):.2f}, {rate(secs_f):.2f}, {rate(secs_b2):.2f}, "
          f"{rate(secs_f2):.2f} scenario-MPC-steps/s; final step's worst "
          f"consensus residual bf16 {res_b:.4e} N, f32 {res_f:.4e} N (bar "
          f"{EFFORT_BAR}): verdict {verdict} | {card}", flush=True)
    report["bf16_path"] = {
        "rates_in_turns": {"bf16": [rate(secs_b), rate(secs_b2)],
                           "f32": [rate(secs_f), rate(secs_f2)]},
        "iters_mean": float(it_b.mean()), "iters_max": int(iters_b.max()),
        "launches": launches_b, "final_res_bf16": res_b,
        "final_res_f32": res_f, "verdict": verdict,
        "card_vs_cpu": card_vs_cpu("bf16 headline", "cadmm", N_AGENTS,
                                   first_b, card, socp_precision="bf16"),
    }

    # 11. DD at 256 x 8, adaptive effort, bf16 storage.
    step_d, css0_d, st0_d = workload("dd", N_AGENTS, N_SCENARIOS,
                                     socp_precision="bf16", effort="adaptive")
    d_args = []
    with capturing(admm_kernel, "fused_solve_lanes", d_args):
        first_d = step_d(css0_d, st0_d)
    torch.cuda.synchronize()
    css_d, st_d, iters_d, inner_d, secs_d, launches_d, _ = timed_steps(
        step_d, css0_d, st0_d, TIMED_STEPS)
    runs_d = int(iters_d.max(dim=1).values.sum())
    check_launches(launches_d, "fused_solve_early_bf16", runs_d, "bf16 DD")
    if not d_args:
        fail("no bf16 call captured in bf16 DD's warm-up step")
    check_body(launches_d, "fused_solve_early_bf16", entry_name(*d_args[0]),
               "bf16 DD")
    check_states(css_d, st_d, "bf16 DD")
    print(f"bf16 DD: {N_SCENARIOS}x{N_AGENTS} forest, effort adaptive, "
          f"{TIMED_STEPS} MPC steps in {secs_d:.4f} s = {rate(secs_d):.2f} "
          f"scenario-MPC-steps/s | dual-ascent iters/step mean "
          f"{float(iters_d.float().mean()):.3f} max {int(iters_d.max())} | "
          f"launches {launches_d} = iterations run {runs_d} | {card}",
          flush=True)
    report["bf16_dd_path"] = {
        "scenario_mpc_steps_per_s": rate(secs_d), "launches": launches_d,
        "iters_mean": float(iters_d.float().mean()),
        "card_vs_cpu": card_vs_cpu("bf16 DD", "dd", N_AGENTS, first_d, card,
                                   socp_precision="bf16", effort="adaptive"),
    }

    # 12. The bf16 forms against their plain bf16 version, on inputs
    # captured from phases 10 and 11.
    if not b_args or not d_args:
        fail("no bf16 call captured in the warm-up steps")
    a, k = b_args[0]
    if a[3].dtype != torch.bfloat16 or k.get("precision") != "bf16":
        fail("the bf16 headline did not hand the kernel bf16 operators")
    B = a[0].shape[0]
    half = torch.arange(B, device=a[0].device) % 2 == 0
    early_kw = dict(k, check_every=10, tol=5e-3)
    checks, err_b = check_fixed_forms([
        ("bf16_headline", a, k), ("bf16_no_shift", a[:11] + [None], k),
        ("bf16_ragged_B1000", lanes(a, 1000), k),
    ], card)
    e_checks, err_e = check_early_exit([
        ("bf16_d48_ungated", a + [None], early_kw),
        ("bf16_d48_half_gated", a + [half], early_kw),
        ("bf16_dd_d56", *d_args[0]),
    ], card)
    report["bf16_kernel_checks"] = {**checks, **e_checks}
    nv, n_box, soc = k["nv"], k["n_box"], tuple(k["soc_dims"])
    m = a[8].shape[-1]
    b_bytes = B * admm_kernel.fused_solve_bytes_per_lane(
        nv, m, n_box, precision="bf16")
    b_flops = B * admm_kernel.fused_solve_flops_per_lane(nv, m, k["iters"],
                                                         soc)
    b_bound, b_by = bound(b_bytes, b_flops)
    b_timing = kernel_timing("the bf16 headline's first consensus iteration",
                             a, k, b_bound, card)
    b_ms = b_timing["ms"]
    b_plain = cuda_ms(
        lambda: admm_kernel.fused_solve_lanes_reference(*a, **k), 5)
    f32_args = [t.float() if t is not None and t.dtype == torch.bfloat16
                else t for t in a]
    f32_kw = dict(k, precision="f32")
    f_ms = cuda_ms(lambda: admm_kernel.fused_solve_lanes(*f32_args, **f32_kw),
                   100)
    print(f"fused_solve bf16 timing (B={B}, d={nv + m}, iters={k['iters']}):"
          f" kernel {b_ms:.4f} ms/launch (the float32 form on the same "
          f"inputs {f_ms:.4f}), plain PyTorch {b_plain:.4f} ms (both CUDA "
          f"graphs), bound {b_bound:.4f} ms by {b_by} ({b_bytes / 1e6:.2f} "
          f"MB with 2-byte operators, {b_flops / 1e6:.1f} MFLOP) | {card}",
          flush=True)
    ea, ek = d_args[0]
    eff = admm_kernel.fused_solve_lanes(*ea, **ek)[5]
    e_bytes, e_flops = early_exit_bound(ea, ek, eff)
    e_bound, e_by = bound(e_bytes, e_flops)
    e_timing = kernel_timing("bf16 DD's first dual-ascent iteration", ea, ek,
                             e_bound, card)
    e_ms = e_timing["ms"]
    ea32 = [t.float() if t is not None and t.dtype == torch.bfloat16
            else t for t in ea]
    ek32 = dict(ek, precision="f32")
    fe_ms = cuda_ms(lambda: admm_kernel.fused_solve_lanes(*ea32, **ek32), 100)
    e_plain = event_ms(
        lambda: admm_kernel.fused_solve_lanes_reference(*ea, **ek), 5)
    print(f"fused_solve early-exit bf16 timing (bf16 DD's first dual-ascent "
          f"iteration: B={ea[0].shape[0]}, d={ek['nv'] + ea[8].shape[-1]}, "
          f"iters={ek['iters']}, mean eff {float(eff.float().mean()):.2f}): "
          f"kernel {e_ms:.4f} ms/launch (CUDA graph; the float32 form on the "
          f"same inputs {fe_ms:.4f}), plain PyTorch "
          f"{e_plain:.4f} ms (host-driven), bound {e_bound:.4f} ms by {e_by} "
          f"({e_bytes / 1e6:.2f} MB, {e_flops / 1e6:.1f} MFLOP) | {card}",
          flush=True)
    report["fused_solve_bf16"] = {
        "kernel_ms": b_ms, "f32_kernel_ms_same_inputs": f_ms,
        "plain_ms": b_plain, "bound_ms": b_bound, "bound_by": b_by,
        "bytes": b_bytes, "flops": b_flops, "timing": b_timing}
    report["fused_solve_early_bf16"] = {
        "kernel_ms": e_ms, "f32_kernel_ms_same_inputs": fe_ms,
        "plain_ms": e_plain, "bound_ms": e_bound,
        "bound_by": e_by, "bytes": e_bytes, "flops": e_flops,
        "timing": e_timing}
    return [
        solve_row(b_timing, launches_b["fused_solve_bf16"], err_b, b_plain,
                  b_by),
        solve_row(e_timing, launches_d["fused_solve_early_bf16"], err_e,
                  e_plain, e_by),
    ]


def counting_chunks(expected):
    """A stand-in for ``socp.solve_socp`` that adds to ``expected[0]`` the
    chunks each solve ran, from its effective iterations: the batch runs
    the most full chunks any lane ran, then one remainder chunk if any lane
    ran it (one chunk for a fixed-iteration solve)."""
    from tpu_aerial_transport_torch.ops import socp

    solve = socp.solve_socp

    def counted(*a, **kw):
        out = solve(*a, **kw)
        ce, tol = kw.get("check_every", 0), kw.get("tol", 0.0)
        if ce and tol > 0:
            eff = out[1].flatten()
            expected[0] += int((eff // ce).max()) + int(
                bool((eff % ce != 0).any()))
        else:
            expected[0] += 1
        return out

    return solve, counted


def chunk_inputs(args, kw):
    """A whole-solve call's captured inputs as the chunk kernel's: w2 =
    [Minv q; A Minv q] and the shift (zeros for none), as the chunked route
    builds them."""
    import torch

    x, y, z, K2, Minv, A, P, q, rho, lb, ub, shift = args[:12]
    wq = (Minv @ q[..., None])[..., 0]
    w2 = torch.cat([wq, (A @ wq[..., None])[..., 0]], dim=-1)
    shift = torch.zeros_like(y) if shift is None else shift
    return ([x, y, z, K2, w2, rho, lb, ub, shift],
            {k: kw[k] for k in ("nv", "n_box", "soc_dims", "iters", "alpha")})


def check_chunk_body(cases, card, forms=(None,)):
    """The chunk kernel against its plain version on each case ``(name,
    args, kw)``, in each of ``forms`` (``(body, x_rows)``; None: the
    wrapper's own choice), at the kernel bar; returns the report by case
    and form, each with its largest error."""
    import torch

    from tpu_aerial_transport_torch.ops import admm_kernel

    checks = {}
    for case, a, k in cases:
        ref = admm_kernel.admm_chunk_lanes_reference(*a, **k)
        ref64 = admm_kernel.admm_chunk_lanes_reference(*in_float64(a), **k)
        nv, m = k["nv"], a[5].shape[-1]
        for forced in forms:
            body, x_rows = forced or (None, None)
            geo = admm_kernel.admm_chunk_geometry(nv, m, body, x_rows)
            got = admm_kernel.admm_chunk_lanes(*a, **k, body=body,
                                               x_rows=x_rows)
            torch.cuda.synchronize()
            errs, noise, ok = agreement(("x", "y", "z"), got, ref, ref64)
            label = f"{case}[{geo.body}" + (f"/{geo.x_rows}]" if geo.x_rows
                                              else "]")
            print(f"chunk kernel check {label}: B={a[0].shape[0]} "
                  f"d={nv + m} iters={k['iters']} max|err| "
                  + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
                  + "; plain float32 vs float64 "
                  + " ".join(f"{n}={e:.3e}" for n, e in noise.items())
                  + f" (bar max({KERNEL_ATOL} x max(1, |ref|), "
                  f"{ROUNDING_FACTOR} x that)) "
                  + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
            checks[label] = {"B": a[0].shape[0], "body": geo.body,
                             "max_abs_err": errs, "worst": max(errs.values()),
                             "plain_f32_vs_f64": noise, "ok": ok}
            if not ok:
                fail(f"chunk kernel disagrees with its plain version on "
                     f"{label}")
    return checks


def chunk_timing(what, a, k, card, forms, reps=100) -> dict:
    """The chunk kernel on one input set in each of ``forms`` (``(body,
    x_rows)``, the wrapper's own first), timed with CUDA graphs in turns
    (forwards, then backwards), beside the bound from these inputs' bytes
    and operations and what the build made of each form (registers, spill
    bytes, resident lanes an SM). Returns the timings by form and the
    bound."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    nv, m = k["nv"], a[5].shape[-1]
    B = a[0].shape[0]
    bytes_ = B * admm_kernel.admm_chunk_bytes_per_lane(nv, m, k["n_box"])
    flops = B * admm_kernel.admm_chunk_flops_per_lane(
        nv, m, k["iters"], tuple(k["soc_dims"]))
    b_ms, b_by = bound(bytes_, flops)
    turns = {}
    for form in list(forms) + list(reversed(forms)):
        turns.setdefault(form, []).append(cuda_ms(
            lambda: admm_kernel.admm_chunk_lanes(
                *a, **k, body=form[0], x_rows=form[1]), reps))
    out = {}
    for body, x_rows in forms:
        geo = admm_kernel.admm_chunk_geometry(nv, m, body, x_rows)
        info = admm_kernel.admm_chunk_info(nv, m, body=body, x_rows=x_rows)
        if (info["lanes_per_block"], info["threads"],
                info["smem_bytes"]) != tuple(geo[2:]):
            fail(f"{what}: the library launches {info}, the wrapper's "
                 f"geometry is {geo}")
        t = turns[body, x_rows]
        ms = sum(t) / len(t)
        label = f"{info['name']}" + (f"[{x_rows}]" if x_rows else "")
        earlier = EARLIER_MS.get("admm_chunk_kernel") if (nv, m) == (16, 32) \
            else None
        print(f"{label} ({what}, B={B}, d={nv + m}, iters={k['iters']}): "
              f"{ms:.4f} ms/launch (CUDA graph; turns {t[0]:.4f} and "
              f"{t[1]:.4f}); bound {b_ms:.4f} ms by {b_by} "
              f"({bytes_ / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP; "
              f"{ms / b_ms:.1f}x); the one-block body at the headline "
              f"earlier " + (f"{earlier:.4f} ms (PERF.md)" if earlier
                             else "not recorded")
              + f" | {info['registers']} registers, {info['local_bytes']} B "
              f"local, {info['lanes_per_sm']} lanes resident an SM "
              f"({info['lanes_per_block']} a block, {info['smem_bytes']} B "
              f"shared a block) | {card}", flush=True)
        out[label] = {"ms": ms, "turns_ms": t, **info}
    return {"forms": out, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": bytes_, "flops": flops}


def chunk_phases(card, report, css0, states0, dd_args, lanes):
    """Phase 9, the chunk kernel. The chunked route (``socp_fused=
    "pallas"``) on the headline, fixed and adaptive, CHUNK_STEPS steps each
    after a warm-up: one launch a chunk run, every one of the warp body;
    then C-ADMM's full QP at n = 8 (d = 72) on the same route, the block
    body's path: one launch a consensus iteration, all of the block body.
    The warp body against its plain version on the headline's inputs (with
    and without the shift, ragged, shorter chunks), each x-row layout and
    the block body too, and on DD's (d = 56, from phase 7's capture); the
    block body on the full QP's. Each body and layout timed in turns on the
    same inputs beside the bound. Returns the two bodies' rows of the
    kernels line."""
    import torch

    from tpu_aerial_transport_torch.ops import admm_kernel, socp

    chunk_args, chunk_report, chunk_launches = [], {}, 0
    for effort in ("fixed", "adaptive"):
        step_c, _, _ = workload("cadmm", N_AGENTS, N_SCENARIOS, max_iter=20,
                                inner_iters=20, socp_fused="pallas",
                                effort=effort)
        with capturing(admm_kernel, "admm_chunk_lanes", chunk_args):
            step_c(css0, states0)
        expected = [0]
        solve, counted = counting_chunks(expected)
        socp.solve_socp = counted
        try:
            css_c, states_c, iters_c, inner_c, secs_c, launches_c, _ = \
                timed_steps(step_c, css0, states0, CHUNK_STEPS)
        finally:
            socp.solve_socp = solve
        what = f"the chunked route ({effort})"
        check_launches(launches_c, "admm_chunk", expected[0], what)
        if admm_kernel.CHUNK_LAUNCHES != {"admm_chunk_kernel": 0,
                                          "warp_chunk_kernel": expected[0]}:
            fail(f"{what} ran {admm_kernel.CHUNK_LAUNCHES}, expected all "
                 f"warp_chunk_kernel")
        check_states(css_c, states_c, what)
        chunk_launches += launches_c["admm_chunk"]
        runs_c = int(iters_c.max(dim=1).values.sum())
        rate_c = N_SCENARIOS * CHUNK_STEPS / secs_c
        print(f"chunked route (socp_fused='pallas', effort {effort}): "
              f"{CHUNK_STEPS} MPC steps in {secs_c:.4f} s = {rate_c:.2f} "
              f"scenario-MPC-steps/s (one host synchronisation a solve "
              f"counts the chunks) | consensus iterations run {runs_c} | "
              f"chunk launches {launches_c['admm_chunk']} = chunks run "
              f"{expected[0]}, all warp_chunk_kernel | {card}", flush=True)
        chunk_report[effort] = {
            "scenario_mpc_steps_per_s": rate_c, "seconds": secs_c,
            "consensus_iterations": runs_c, "launches": launches_c,
            "chunks_run": expected[0],
        }
    if not chunk_args:
        fail("no admm_chunk call captured")

    # The block body's path: the full agent QP (d = 72) on route "pallas".
    step_f, css_f0, st_f0 = workload(
        "cadmm", N_AGENTS, N_SCENARIOS, reduced_qp=False, pad_operators=True,
        socp_fused="pallas", effort="fixed")
    full_args = []
    with capturing(admm_kernel, "admm_chunk_lanes", full_args):
        step_f(css_f0, st_f0)
    css_f, st_f, iters_f, _, secs_f, launches_f, _ = timed_steps(
        step_f, css_f0, st_f0, CHUNK_STEPS)
    runs_f = int(iters_f.max(dim=1).values.sum())
    what = "full-QP C-ADMM n = 8 on the chunked route"
    check_launches(launches_f, "admm_chunk", runs_f, what)
    if admm_kernel.CHUNK_LAUNCHES != {"admm_chunk_kernel": runs_f,
                                      "warp_chunk_kernel": 0}:
        fail(f"{what} ran {admm_kernel.CHUNK_LAUNCHES}, expected all "
             f"admm_chunk_kernel")
    check_states(css_f, st_f, what)
    f_args, f_kw = full_args[0]
    print(f"{what}: {N_SCENARIOS}x{N_AGENTS}, d = "
          f"{f_kw['nv'] + f_args[5].shape[-1]}, {CHUNK_STEPS} MPC steps in "
          f"{secs_f:.4f} s = {N_SCENARIOS * CHUNK_STEPS / secs_f:.2f} "
          f"scenario-MPC-steps/s | launches {launches_f} = consensus "
          f"iterations run {runs_f}, all admm_chunk_kernel | {card}",
          flush=True)
    chunk_report["full_qp_n8"] = {
        "scenario_mpc_steps_per_s": N_SCENARIOS * CHUNK_STEPS / secs_f,
        "launches": launches_f, "iterations_run": runs_f}

    c_args, c_kw = chunk_args[0]
    d_args, d_kw = chunk_inputs(*dd_args[0])
    zeros = torch.zeros_like(c_args[8])
    headline_forms = (("warp", "split"), ("warp", "shared"), ("block", None))
    checks = {
        **check_chunk_body([("headline_20", c_args, c_kw)], card,
                           headline_forms),
        **check_chunk_body(
            [("headline_no_shift", c_args[:8] + [zeros], c_kw),
             ("ragged_B1000", lanes(c_args, 1000), c_kw),
             ("chunk_10", c_args, dict(c_kw, iters=10)),
             ("remainder_7", c_args, dict(c_kw, iters=7))], card),
        **check_chunk_body([("dd_d56", d_args, d_kw)], card,
                           (("warp", "shared"), ("block", None))),
        **check_chunk_body([("full_qp_d72", f_args, f_kw)], card),
    }
    w_err, b_err = (max(c["worst"] for c in checks.values()
                        if c["body"] == body) for body in ("warp", "block"))
    timing = {
        "headline": chunk_timing("the headline's chunk", c_args, c_kw, card,
                                 headline_forms),
        "dd_d56": chunk_timing("DD's shape", d_args, d_kw, card,
                               (("warp", "shared"), ("block", None))),
        "full_qp_d72": chunk_timing("the full QP at n = 8", f_args, f_kw,
                                    card, ((None, None),)),
    }
    w_ms = timing["headline"]["forms"]["warp_chunk_kernel[split]"]["ms"]
    w_plain = cuda_ms(
        lambda: admm_kernel.admm_chunk_lanes_reference(*c_args, **c_kw), 5)
    b_ms = timing["full_qp_d72"]["forms"]["admm_chunk_kernel"]["ms"]
    b_plain = cuda_ms(
        lambda: admm_kernel.admm_chunk_lanes_reference(*f_args, **f_kw), 5)
    print(f"admm_chunk plain PyTorch (CUDA graphs): headline {w_plain:.4f} "
          f"ms, full QP d = 72 {b_plain:.4f} ms; no single PyTorch call "
          f"computes this function | {card}", flush=True)
    report["chunk_route"] = chunk_report
    report["chunk_checks"] = checks
    report["admm_chunk"] = {"timing": timing, "plain_ms": w_plain,
                            "block_plain_ms": b_plain}
    row = {"route": "cuda", "source": f"{PKG}/csrc/admm_chunk.cu",
           "replaces": "tpu_aerial_transport/ops/admm_kernel.py:128",
           "library_ms": None}
    return [
        {"name": "warp_chunk_kernel", **row, "launches": chunk_launches,
         "max_abs_err": w_err, "ms": w_ms, "plain_ms": w_plain,
         "bound_ms": timing["headline"]["bound_ms"],
         "bound_by": timing["headline"]["bound_by"]},
        {"name": "admm_chunk_kernel", **row, "launches": runs_f,
         "max_abs_err": b_err, "ms": b_ms, "plain_ms": b_plain,
         "bound_ms": timing["full_qp_d72"]["bound_ms"],
         "bound_by": timing["full_qp_d72"]["bound_by"]},
    ]


def centralized_scan_phase(card, report):
    """Phase 20, route "scan": the centralized controller at n = 16 (the JAX
    bench's ``centralized_n16_single``, and 256 scenarios) and n = 64
    (``centralized_n64_single``, d = 799), where the whole-solve kernel
    cannot hold the QP. The resolver must name "scan", no kernel may
    launch, states stay finite; one warm-up and CHUNK_STEPS timed steps
    each; the first step of n = 16 on 8 scenarios against the CPU."""
    from tpu_aerial_transport_torch.control import centralized
    from tpu_aerial_transport_torch.harness import rollout, setup

    report["centralized_scan"] = {}
    for n, S in ((16, 1), (16, N_SCENARIOS), (64, 1)):
        params, col, _ = setup.rqp_setup(n, device="cpu")
        cfg = centralized.make_config(
            params, col.collision_radius, col.max_deceleration,
            solver_iters=rollout.CENTRALIZED_SOLVER_ITERS)
        route = centralized.solve_route(n, cfg)
        n_box, m, soc = centralized.qp_dims(n, cfg.n_env_cbfs)
        what = f"centralized n = {n}, {S} scenario{'s' if S > 1 else ''}"
        if route != "scan":
            fail(f"{what} resolved to route {route!r}, expected 'scan'")
        step, css0, st0 = workload("centralized", n, S)
        zero_launches()
        first = step(css0, st0)
        launches0 = launch_counts()
        css, st, _, _, secs, launches, stats = timed_steps(
            step, css0, st0, CHUNK_STEPS)
        check_launch_counts(launches0, {}, what + " (warm-up)")
        check_launch_counts(launches, {}, what)
        check_states(css, st, what)
        ok_frac = float(stats.ok_frac.mean())
        print(f"{what}: route {route} (d = {9 + 3 * n + m}, {len(soc)} SOC "
              f"blocks), {CHUNK_STEPS} MPC steps in {secs:.4f} s = "
              f"{CHUNK_STEPS / secs:.2f} steps/s = "
              f"{S * CHUNK_STEPS / secs:.2f} scenario-MPC-steps/s | solves "
              f"under solver_tol in the last step {ok_frac:.4f} | kernel "
              f"launches none | {card}", flush=True)
        entry = {"route": route, "d": 9 + 3 * n + m, "steps_per_s":
                 CHUNK_STEPS / secs, "scenario_mpc_steps_per_s":
                 S * CHUNK_STEPS / secs, "ok_frac_last_step": ok_frac}
        if n == 16 and S > 1:
            entry["card_vs_cpu"] = card_vs_cpu(
                "centralized n = 16 (route scan)", "centralized", n, first,
                card)
        report["centralized_scan"][f"n{n}_S{S}"] = entry


def centralized_phases(card, report):
    """Phase 13, the shared-memory body: the entry step (n = 3) and the
    centralized rollout (n = 4), each one early-exit launch a step, against
    the CPU; one entry period profiled; the kernel against its plain version
    at d = 67 and d = 79 (256 lanes each) and timed there; then its other
    three forms on C-ADMM with the full agent QP at n = 8 (d = 72). Returns
    the four shared-memory entry points' rows of the kernels line."""
    import torch

    from tpu_aerial_transport_torch import entry
    from tpu_aerial_transport_torch.ops import admm_kernel

    from torch.profiler import ProfilerActivity, profile

    step_e, (cs0, st0, acc) = entry.entry()
    entry_args = []
    with capturing(admm_kernel, "fused_solve_lanes", entry_args):
        step_e(cs0, st0, acc)  # warm-up.
    cs, st = cs0, st0
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        cs, st, stats = step_e(cs, st, acc)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    check_launches(launches, "fused_solve_early", TIMED_STEPS,
                   "the entry step")
    entry_kernel = entry_name(*entry_args[0])
    check_body(launches, "fused_solve_early", entry_kernel, "the entry step")
    check_states(cs, st, "the entry step")
    print(f"entry step (n = 3, centralized, d = 67): {TIMED_STEPS} MPC "
          f"periods in {secs:.4f} s = {TIMED_STEPS / secs:.2f} periods/s | "
          f"launches {launches} | {card}", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_e(cs0, st0, acc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ph = phase_breakdown(prof)
    print(f"profile of one entry period: wall {wall * 1e3:.2f} ms (profiler "
          f"on), device busy {ph['kernels_us'] / 1e3:.2f} ms | {card}",
          flush=True)
    for name in sorted(ph["host_us"], key=lambda p: -ph["host_us"][p]):
        print(f"  tat.{name}: host {ph['host_us'][name] / 1e3:.3f} ms, "
              f"device {ph['device_us'].get(name, 0.0) / 1e3:.3f} ms")
    early_us = per_launch_us(prof, entry_kernel)
    print(f"  {entry_kernel} in the entry period: "
          + ("not found in the trace" if early_us is None
             else f"{early_us / 1e3:.4f} ms/launch"), flush=True)
    step_c, (cs_c, st_c, acc_c) = entry.entry(device="cpu")
    cs_g, st_g = cs0, st0
    worst, f_worst = 0.0, 0.0
    for _ in range(5):
        cs_g, st_g, _ = step_e(cs_g, st_g, acc)
        cs_c, st_c, _ = step_c(cs_c, st_c, acc_c)
        worst = max(worst, max(float((getattr(st_c, f)
                                      - getattr(st_g, f).cpu()).abs().max())
                               for f in STATE_FIELDS))
        f_worst = max(f_worst, float((cs_c.prev_f
                                      - cs_g.prev_f.cpu()).abs().max()))
    ok = worst <= CPU_STATE_ATOL and f_worst <= CPU_FORCE_ATOL
    print(f"entry step card vs CPU, 5 periods: max|state err| {worst:.2e} "
          f"(atol {CPU_STATE_ATOL}), max|force err| {f_worst:.2e} N (atol "
          f"{CPU_FORCE_ATOL}) " + ("ok" if ok else "FAIL") + f" | {card}",
          flush=True)
    if not ok:
        fail("the entry step on the card disagrees with the CPU")
    report["entry"] = {"periods_per_s": TIMED_STEPS / secs,
                       "launches": launches,
                       "profile": {"wall_ms": wall * 1e3, "phases": ph,
                                   "kernel_us_per_launch": early_us},
                       "card_vs_cpu": {"state_err": worst,
                                       "force_err": f_worst}}

    captured = {}
    for n in (3, 4):
        step_n, css0, st0_n = workload("centralized", n, N_SCENARIOS)
        args = []
        with capturing(admm_kernel, "fused_solve_lanes", args):
            first = step_n(css0, st0_n)
        torch.cuda.synchronize()
        captured[n] = args[0]
        if n == 3:
            continue
        css, st_n, _, _, secs_n, launches_n, stats_n = timed_steps(
            step_n, css0, st0_n, CHUNK_STEPS)
        check_launches(launches_n, "fused_solve_early", CHUNK_STEPS,
                       "the centralized rollout")
        check_body(launches_n, "fused_solve_early", entry_name(*args[0]),
                   "the centralized rollout")
        check_states(css, st_n, "the centralized rollout")
        ok_frac = float(stats_n.ok_frac.mean())
        print(f"centralized rollout: {N_SCENARIOS} scenarios x n = {n} "
              f"(d = 79), {CHUNK_STEPS} MPC steps in {secs_n:.4f} s = "
              f"{N_SCENARIOS * CHUNK_STEPS / secs_n:.2f} scenario-MPC-steps/s"
              f" | solves under solver_tol in the last step {ok_frac:.4f} | "
              f"launches {launches_n} | {card}", flush=True)
        report["centralized_n4"] = {
            "scenario_mpc_steps_per_s": N_SCENARIOS * CHUNK_STEPS / secs_n,
            "launches": launches_n, "ok_frac_last_step": ok_frac,
            "card_vs_cpu": card_vs_cpu("centralized n = 4", "centralized",
                                       n, first, card),
        }
    # The stop decision at the centralized solves' converged point is
    # decided by float32 rounding (the dual residual swings by ~+-3e-4
    # around tol from chunk to chunk), so a flipped decision may stop
    # chunks apart: counts must be equal in EFF_EQUAL_SHARE of the lanes,
    # and the fixed form at the same inputs is held to the kernel bar.
    (a3, k3), (a4, k4) = captured[3], captured[4]
    cases = [("central_d67_B256", a3, k3), ("central_d79_B256", a4, k4)]
    e_checks, err_e = check_early_exit(cases, card, chunks_apart=None)
    f_checks, err_f = check_fixed_forms(
        [(c + "_fixed", *fixed_form(a, k)) for c, a, k in cases], card)
    report["centralized_kernel_checks"] = {**e_checks, **f_checks}
    timings = {}
    for case, a, k in [("the entry's solve", *entry_args[0])] + cases:
        eff = admm_kernel.fused_solve_lanes(*a, **k)[5]
        timings[case] = kernel_timing(
            case, a, k, bound(*early_exit_bound(a, k, eff))[0], card)
    ea, ek = entry_args[0]
    e_eff = admm_kernel.fused_solve_lanes(*ea, **ek)[5]
    e_by = bound(*early_exit_bound(ea, ek, e_eff))[1]
    e_plain = event_ms(
        lambda: admm_kernel.fused_solve_lanes_reference(*ea, **ek), 5)
    report["centralized_timing"] = timings
    rows = [solve_row(timings["the entry's solve"],
                      launches["fused_solve_early"], max(err_e, err_f),
                      e_plain, e_by)]
    return rows + full_qp_phase(card, report)


def full_qp_phase(card, report):
    """Phase 13, the shared-memory body's other forms on a path: C-ADMM at
    256 x 8 with the full agent QP (``reduced_qp=False``: nv = 33 padded to
    40, d = 72 > 64), fixed effort, bf16 fixed and bf16 adaptive: one
    warm-up and CHUNK_STEPS steps each, one launch a consensus iteration,
    all of the shared-memory entry point; the kernel against its plain
    version on the warm-up's inputs (early-exit counts equal in
    EFF_EQUAL_SHARE of the lanes, as at the centralized solves) and timed.
    Returns the three entry points' rows of the kernels line."""
    import torch

    from tpu_aerial_transport_torch.ops import admm_kernel

    rows, report["full_qp_n8"] = [], {}
    for form, kw in (("fused_solve", dict(effort="fixed")),
                     ("fused_solve_bf16", dict(effort="fixed",
                                               socp_precision="bf16")),
                     ("fused_solve_early_bf16", dict(
                         effort="adaptive", socp_precision="bf16"))):
        step, css0, st0 = workload("cadmm", N_AGENTS, N_SCENARIOS,
                                   reduced_qp=False, pad_operators=True,
                                   **kw)
        args = []
        with capturing(admm_kernel, "fused_solve_lanes", args):
            step(css0, st0)
        torch.cuda.synchronize()
        css, st, iters, _, secs, launches, _ = timed_steps(
            step, css0, st0, CHUNK_STEPS)
        runs = int(iters.max(dim=1).values.sum())
        what = f"full-QP C-ADMM n = 8 ({form})"
        check_launches(launches, form, runs, what)
        a, k = args[0]
        name = entry_name(a, k)
        if not name.startswith("fused_solve"):
            fail(f"{what} took {name}, not the shared-memory body")
        check_body(launches, form, name, what)
        check_states(css, st, what)
        print(f"{what}: {N_SCENARIOS}x{N_AGENTS}, d = "
              f"{k['nv'] + a[8].shape[-1]}, {CHUNK_STEPS} MPC steps in "
              f"{secs:.4f} s = {N_SCENARIOS * CHUNK_STEPS / secs:.2f} "
              f"scenario-MPC-steps/s | consensus iters/step mean "
              f"{float(iters.float().mean()):.3f} max {int(iters.max())} | "
              f"launches {launches} = consensus iterations run {runs}, all "
              f"{name} | {card}", flush=True)
        B = a[0].shape[0]
        if admm_kernel._early(k.get("check_every", 0), k.get("tol", 0.0)):
            checks, err = check_early_exit([(form + "_full_qp", a, k)], card,
                                           chunks_apart=None)
            eff = admm_kernel.fused_solve_lanes(*a, **k)[5]
            bytes_, flops = early_exit_bound(a, k, eff)
            plain = event_ms(
                lambda: admm_kernel.fused_solve_lanes_reference(*a, **k), 5)
        else:
            checks, err = check_fixed_forms([(form + "_full_qp", a, k)],
                                            card)
            nv, m = k["nv"], a[8].shape[-1]
            bytes_ = B * admm_kernel.fused_solve_bytes_per_lane(
                nv, m, k["n_box"], precision=k.get("precision", "f32"))
            flops = B * admm_kernel.fused_solve_flops_per_lane(
                nv, m, k["iters"], tuple(k["soc_dims"]))
            plain = cuda_ms(
                lambda: admm_kernel.fused_solve_lanes_reference(*a, **k), 5)
        b_ms, b_by = bound(bytes_, flops)
        timing = kernel_timing(f"{what}'s first consensus iteration", a, k,
                               b_ms, card)
        rows.append(solve_row(timing, launches[form], err, plain, b_by))
        report["full_qp_n8"][form] = {
            "scenario_mpc_steps_per_s": N_SCENARIOS * CHUNK_STEPS / secs,
            "launches": launches, "iterations_run": runs, "checks": checks,
            "plain_ms": plain, "timing": timing}
    return rows


def cadmm_option_phases(card, report):
    """Phase 14: C-ADMM at n = 3 (the full QP, d = 56), with tau_incr = 1.5
    and with inner_iters_warm = 10: launches = consensus iterations, finite
    states, and the card against the CPU. Returns the launches."""
    import torch

    from tpu_aerial_transport_torch.ops import admm_kernel

    total, report["cadmm_options"] = 0, {}
    for name, n, kw in (("n3_full_qp", 3, {}),
                        ("tau_incr_1.5", N_AGENTS, dict(tau_incr=1.5)),
                        ("inner_iters_warm_10", N_AGENTS,
                         dict(inner_iters_warm=10))):
        step, css0, st0 = workload("cadmm", n, N_SCENARIOS, **kw)
        args = []
        with capturing(admm_kernel, "fused_solve_lanes", args):
            first = step(css0, st0)
        torch.cuda.synchronize()
        css, st, iters, _, secs, launches, _ = timed_steps(
            step, css0, st0, CHUNK_STEPS)
        runs = int(iters.max(dim=1).values.sum())
        check_launches(launches, "fused_solve", runs, f"C-ADMM {name}")
        check_body(launches, "fused_solve", entry_name(*args[0]),
                   f"C-ADMM {name}")
        check_states(css, st, f"C-ADMM {name}")
        total += launches["fused_solve"]
        a, k = args[0]
        print(f"C-ADMM {name}: {N_SCENARIOS}x{n}, d = "
              f"{k['nv'] + a[8].shape[-1]}, {CHUNK_STEPS} MPC steps in "
              f"{secs:.4f} s = {N_SCENARIOS * CHUNK_STEPS / secs:.2f} "
              f"scenario-MPC-steps/s | consensus iters/step mean "
              f"{float(iters.float().mean()):.3f} max {int(iters.max())} | "
              f"launches {launches} = consensus iterations run {runs} | "
              f"{card}", flush=True)
        report["cadmm_options"][name] = {
            "scenario_mpc_steps_per_s": N_SCENARIOS * CHUNK_STEPS / secs,
            "launches": launches,
            "card_vs_cpu": card_vs_cpu(f"C-ADMM {name}", "cadmm", n, first,
                                       card, **kw),
        }
    return total


@contextlib.contextmanager
def capturing_shapes(module, name: str, store: dict):
    """Record a clone of the first argument of ``module.<name>`` for each
    distinct shape it is called with."""
    fn = getattr(module, name)

    def wrapper(x, *args, **kw):
        store.setdefault(tuple(x.shape), x.clone())
        return fn(x, *args, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def impl_turns(what, controller, n, n_scenarios, kw, card):
    """The three exchange impls in turns (allreduce, ring, pallas_ring,
    then back), ``CHUNK_STEPS`` MPC steps each from the seeded batch:
    ``{impl: [rate, rate]}`` in scenario-MPC-steps/s."""
    from tpu_aerial_transport_torch.parallel import ring

    runs = {impl: workload(controller, n, n_scenarios, shards=SHARDS,
                           consensus_impl=impl, effort="fixed", **kw)
            for impl in ring.IMPLS}
    rates = {impl: [] for impl in ring.IMPLS}
    for impl in ring.IMPLS + ring.IMPLS[::-1]:
        step, css0, st0 = runs[impl]
        step(css0, st0)  # warm-up.
        secs = timed_steps(step, css0, st0, CHUNK_STEPS)[4]
        rates[impl].append(n_scenarios * CHUNK_STEPS / secs)
    print(f"{what}: the exchange impls in turns (allreduce, ring, "
          f"pallas_ring, pallas_ring, ring, allreduce), {CHUNK_STEPS} MPC "
          f"steps each, in {'scenario-' if n_scenarios > 1 else ''}"
          f"MPC-steps/s: " + "; ".join(
              f"{impl} {r[0]:.2f} and {r[1]:.2f}" for impl, r in rates.items())
          + f" | {card}", flush=True)
    return rates


def sharded_vs_single(what, controller, n, first, kw, card):
    """The first sharded pallas_ring step on the card against the single
    program's on the same seeded batch: forces within SHARDED_FORCE_BAR on
    the scenarios whose iteration counts agree, counts equal on at least
    SHARDED_EQUAL_SHARE of the scenarios."""
    step, css0, st0 = workload(controller, n, first[1].xl.shape[0],
                               effort="fixed", **kw)
    single = step(css0, st0)
    same = first[2].iters == single[2].iters
    share = float(same.float().mean())
    diff = (forces_of(first[0]) - forces_of(single[0])).abs().flatten(1)
    f_err = float(diff[same].max()) if bool(same.any()) else float("nan")
    ok = share >= SHARDED_EQUAL_SHARE and f_err <= SHARDED_FORCE_BAR
    print(f"{what} sharded (pallas_ring) vs single program on the card, "
          f"first MPC step of {same.numel()} scenarios: iteration counts "
          f"equal in {share * 100:.2f}% (bar {SHARDED_EQUAL_SHARE * 100:.0f}"
          f"%), max|force err| on those {f_err:.3e} N (bar "
          f"{SHARDED_FORCE_BAR}) " + ("ok" if ok else "FAIL") + f" | {card}",
          flush=True)
    if not ok:
        fail(f"{what}: the sharded step disagrees with the single program")
    return {"iters_equal_share": share, "force_err": f_err}


def sharded_phases(card, report):
    """Phases 15-19: the agent-sharded C-ADMM and DD paths through the
    ring-sum kernel, the exchange A/B at n = 64, the kernel against its
    plain version, and the card against the CPU. Returns the kernel's row
    of the kernels line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.parallel import ring

    ring_inputs, paths, runs_of = {}, {}, {}
    # 15-16. Sharded C-ADMM (n = 8) and DD (n = 16) at 256 scenarios with
    # the kernel ring, then the three impls in turns.
    for key, (ctrl, n, kw) in SHARDED.items():
        kw = dict(kw, max_iter=20)
        step, css0, st0 = workload(ctrl, n, N_SCENARIOS, shards=SHARDS,
                                   consensus_impl="pallas_ring",
                                   effort="fixed", **kw)
        solve_args = []
        with capturing_shapes(ring, "ring_sum_shards", ring_inputs), \
                capturing(admm_kernel, "fused_solve_lanes", solve_args):
            first = step(css0, st0)
        torch.cuda.synchronize()
        runs_of[key] = (step, css0, st0)
        css, st, iters, _, secs, launches, _ = timed_steps(
            step, css0, st0, TIMED_STEPS)
        runs = int(iters.max(dim=1).values.sum())
        check_launch_counts(launches, {"fused_solve": runs,
                                       "ring_sum": RING_SUMS[ctrl] * runs},
                            key)
        check_body(launches, "fused_solve", entry_name(*solve_args[0]), key)
        check_states(css, st, key)
        rate = N_SCENARIOS * TIMED_STEPS / secs
        print(f"{key}: {N_SCENARIOS} scenarios x n = {n}, {SHARDS} shards "
              f"on the card, pallas_ring, {TIMED_STEPS} MPC steps in "
              f"{secs:.4f} s = {rate:.2f} scenario-MPC-steps/s | iterations"
              f"/step mean {float(iters.float().mean()):.3f} max "
              f"{int(iters.max())} | launches {launches} = iterations run "
              f"{runs}, ring sums {RING_SUMS[ctrl]} an iteration | {card}",
              flush=True)
        paths[key] = {
            "scenario_mpc_steps_per_s": rate, "seconds": secs,
            "iters_mean": float(iters.float().mean()),
            "iterations_run": runs, "launches": launches,
            "rates_in_turns": impl_turns(key, ctrl, n, N_SCENARIOS, kw,
                                         card),
            "first": first, "kw": kw,
        }
    # 16, adaptive: sharded DD with effort="adaptive" (the early-exit kernel
    # under sharding, and the inner-iteration total exchanged once a step).
    key, (ctrl, n, kw) = "dd_n16_sharded_adaptive", SHARDED["dd_n16_sharded"]
    kw = dict(kw, max_iter=20, effort="adaptive")
    step, css0, st0 = workload(ctrl, n, N_SCENARIOS, shards=SHARDS,
                               consensus_impl="pallas_ring", **kw)
    solve_args = []
    with capturing(admm_kernel, "fused_solve_lanes", solve_args):
        first = step(css0, st0)
    torch.cuda.synchronize()
    css, st, iters, inner, secs, launches, _ = timed_steps(
        step, css0, st0, CHUNK_STEPS)
    runs = int(iters.max(dim=1).values.sum())
    check_launch_counts(launches, {
        "fused_solve_early": runs,
        "ring_sum": RING_SUMS[ctrl] * runs + CHUNK_STEPS}, key)
    check_body(launches, "fused_solve_early", entry_name(*solve_args[0]), key)
    check_states(css, st, key)
    if inner is None or not bool((inner > 0).all()):
        fail(f"{key} reported no inner iterations")
    print(f"{key}: {N_SCENARIOS} scenarios x n = {n}, {SHARDS} shards, "
          f"pallas_ring, effort adaptive, {CHUNK_STEPS} MPC steps in "
          f"{secs:.4f} s = {N_SCENARIOS * CHUNK_STEPS / secs:.2f} "
          f"scenario-MPC-steps/s | launches {launches} = iterations run "
          f"{runs}, ring sums {RING_SUMS[ctrl]} an iteration + 1 a step | "
          f"{card}", flush=True)
    paths[key] = {
        "scenario_mpc_steps_per_s": N_SCENARIOS * CHUNK_STEPS / secs,
        "iterations_run": runs, "launches": launches,
        "card_vs_cpu": card_vs_cpu(f"{key} (pallas_ring)", ctrl, n, first,
                                   card, shards=SHARDS,
                                   consensus_impl="pallas_ring", **kw),
    }
    # 17. The exchange A/B at the JAX sweep's shape: n = 64 over 8 shards,
    # one scenario; the kernel ring's launches are checked too.
    ab = {}
    for key, (ctrl, n, kw) in EXCHANGE_AB.items():
        step, css0, st0 = workload(ctrl, n, 1, shards=SHARDS,
                                   consensus_impl="pallas_ring",
                                   effort="fixed", **kw)
        with capturing_shapes(ring, "ring_sum_shards", ring_inputs):
            step(css0, st0)
        _, _, iters, _, _, launches, _ = timed_steps(step, css0, st0,
                                                     CHUNK_STEPS)
        runs = int(iters.sum())
        check_launch_counts(launches, {"fused_solve": runs,
                                       "ring_sum": RING_SUMS[ctrl] * runs},
                            key)
        ab[key] = {"launches": launches, "iterations_run": runs,
                   "mpc_steps_per_s": impl_turns(key, ctrl, n, 1, kw, card)}

    # 18. The kernel against its plain version: the payloads captured from
    # phases 15-17, d in {2, 3, 4, 8, 16, 32 (the cap)} and ragged payloads.
    gen = torch.Generator().manual_seed(0)
    cases = {f"captured_{d}x{P}": x for (d, P), x in sorted(
        ring_inputs.items())}
    for d, P in ((2, 1025), (3, 1025), (4, 1025), (8, 1025), (8, 6147),
                 (16, 1025), (16, 6144), (ring.MAX_SHARDS, 1025),
                 (ring.MAX_SHARDS, 6147)):
        cases[f"random_{d}x{P}"] = (10.0 * torch.randn(
            d, P, generator=gen)).cuda()
    checks, worst = {}, 0.0
    for case, x in cases.items():
        got = ring.ring_sum_shards(x)
        ref = ring.ring_sum_shards_reference(x)
        exact = x.double().sum(dim=0, keepdim=True)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        f64 = float((got.double() - exact).abs().max())
        scale = max(1.0, float(exact.abs().max()))
        ok = (torch.equal(got, ref) and f64 <= RING_SUM_RTOL * scale
              and bool(torch.isfinite(got).all()))
        worst = max(worst, err)
        print(f"ring kernel check {case}: bitwise equal to the plain version"
              f" {torch.equal(got, ref)} (max|err| {err:.3e}), max|err| vs "
              f"float64 {f64:.3e} (bar {RING_SUM_RTOL} x {scale:.3g}) "
              + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
        checks[case] = {"max_abs_err": err, "vs_float64": f64, "ok": ok}
        if not ok:
            fail(f"the ring kernel disagrees with its plain version on {case}")
    timing = {}
    for d, P in ((SHARDS, N_SCENARIOS * 8 * 3), (SHARDS, 64 * 3)):
        x = ring_inputs.get((d, P))
        if x is None:
            fail(f"no ({d}, {P}) ring payload captured from the paths")
        b_bytes = ring.ring_sum_bytes(d, P)
        b_flops = ring.ring_sum_flops(d, P)
        b_ms, b_by = bound(b_bytes, b_flops)
        k_ms = cuda_ms(lambda: ring.ring_sum_shards(x), 200)
        p_ms = cuda_ms(lambda: ring.ring_sum_shards_reference(x), 50)
        l_ms = cuda_ms(lambda: x.sum(0, keepdim=True).expand_as(x), 200)
        info = ring.ring_sum_info(d, P)
        print(f"ring_sum timing ({d}, {P}) float32: kernel {k_ms:.4f} "
              f"ms/launch (earlier {EARLIER_MS['ring_sum_kernel']:.4f}, "
              f"PERF.md), plain PyTorch {p_ms:.4f} ms, library call "
              f"x.sum(0).expand_as(x) {l_ms:.4f} ms (all CUDA graphs; kernel"
              f" / library {k_ms / l_ms:.2f}), bound {b_ms:.6f} ms by {b_by} "
              f"({b_bytes} B, {b_flops} adds) | {info['registers']} "
              f"registers, {info['local_bytes']} B local (spills), 16-byte "
              f"form {info['vec16']} | {card}", flush=True)
        timing[f"{d}x{P}"] = {"kernel_ms": k_ms, "plain_ms": p_ms,
                              "library_ms": l_ms, "bound_ms": b_ms,
                              "bound_by": b_by, "bytes": b_bytes,
                              "flops": b_flops,
                              "earlier_ms": EARLIER_MS["ring_sum_kernel"],
                              **info}
    # One sharded C-ADMM step profiled.
    step, css0, st0 = runs_of["cadmm_n8_sharded"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(css0, st0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ph = phase_breakdown(prof)
    ring_us = per_launch_us(prof, "ring_sum_kernel")
    print(f"profile of one sharded C-ADMM step (pallas_ring): wall "
          f"{wall * 1e3:.2f} ms (profiler on), device busy "
          f"{ph['kernels_us'] / 1e3:.2f} ms = "
          f"{100 * ph['kernels_us'] / 1e3 / (wall * 1e3):.1f}% | {card}",
          flush=True)
    for name in sorted(ph["host_us"], key=lambda p: -ph["host_us"][p]):
        print(f"  tat.{name}: host {ph['host_us'][name] / 1e3:.3f} ms, "
              f"device {ph['device_us'].get(name, 0.0) / 1e3:.3f} ms")
    ring_dev_ms = ph["device_us"].get("ring_sum", 0.0) / 1e3
    print(f"  ring_sum_kernel device {ring_dev_ms:.3f} ms in the step, "
          + ("not found in the trace" if ring_us is None
             else f"{ring_us / 1e3:.4f} ms/launch"), flush=True)

    # 19. The card against the CPU (which runs the kernel's plain version)
    # and against the single program, for both sharded paths.
    for key, (ctrl, n, _) in SHARDED.items():
        path = paths[key]
        first, kw = path.pop("first"), path.pop("kw")
        path["card_vs_cpu"] = card_vs_cpu(
            f"{key} (pallas_ring)", ctrl, n, first, card, shards=SHARDS,
            consensus_impl="pallas_ring", effort="fixed", **kw)
        path["vs_single_program"] = sharded_vs_single(key, ctrl, n, first,
                                                      kw, card)
    report["sharded"] = {
        "paths": paths, "exchange_ab_n64": ab, "ring_checks": checks,
        "ring_timing": timing,
        "profile": {"wall_ms": wall * 1e3, "phases": ph,
                    "ring_sum_kernel_us_per_launch": ring_us},
    }
    main_t = timing[f"{SHARDS}x{N_SCENARIOS * 8 * 3}"]
    return {
        "name": "ring_sum_kernel", "route": "cuda",
        "source": f"{PKG}/csrc/ring_sum.cu",
        "replaces": "tpu_aerial_transport/parallel/ring.py:273",
        "launches": paths["cadmm_n8_sharded"]["launches"]["ring_sum"],
        "max_abs_err": worst, "ms": main_t["kernel_ms"],
        "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"], "library_ms": main_t["library_ms"],
    }


def tree_equal(a, b) -> bool:
    """Every leaf of two state trees bitwise equal."""
    import torch

    from tpu_aerial_transport_torch.tree import leaves

    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def profile_step(fn):
    """``(wall ms with the profiler on, phase_breakdown)`` of one call of
    ``fn``, ending in a synchronise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall * 1e3, phase_breakdown(prof)


def print_profile(what, wall_ms, ph, card):
    dev = ph["kernels_us"] / 1e3
    print(f"profile of {what}: wall {wall_ms:.2f} ms (profiler on), device "
          f"busy {dev:.2f} ms = {100 * dev / wall_ms:.1f}% | {card}",
          flush=True)
    for name in sorted(ph["host_us"], key=lambda p: -ph["host_us"][p]):
        print(f"  tat.{name}: host {ph['host_us'][name] / 1e3:.3f} ms, "
              f"device {ph['device_us'].get(name, 0.0) / 1e3:.3f} ms")
    print(f"  device time no host range holds (a replayed graph's kernels "
          f"among it): {ph['device_us']['unattributed'] / 1e3:.3f} ms",
          flush=True)


def graph_phase(card, report, run, css0, states0):
    """Phase 21, the CUDA-graph substeps: on the headline state after one
    warm-up step, the graph replay bitwise equal to the eager substeps, and
    the entry period's physics likewise; eager and graph substeps timed in
    turns (CUDA events around host-driven calls); the fixed headline with
    the graph on and off in turns; one step of each profiled; the entry's
    periods/s with and without the graph in turns."""
    import torch

    from tpu_aerial_transport_torch import entry
    from tpu_aerial_transport_torch.harness import rollout

    css1, states1, _ = run(css0, states0, 1)
    ctl = rollout.make_controller("cadmm", N_AGENTS, max_iter=20,
                                  inner_iters=20, device="cuda")
    acc = (torch.tensor([0.3, 0.0, 0.0], device=states1.xl.device),
           torch.zeros(3, device=states1.xl.device))
    f_des = ctl.control(css1, states1, acc)[0]
    eager = rollout.make_substeps(ctl.params, ctl.ll.control,
                                  cuda_graph=False)
    graphed = rollout.make_substeps(ctl.params, ctl.ll.control)
    ref = eager(states1, f_des)
    first = graphed(states1, f_des)  # captures, then replays.
    again = graphed(states1, f_des)
    torch.cuda.synchronize()
    g = graphed.graph
    equal = tree_equal(ref, first) and tree_equal(ref, again)
    print(f"graph substeps (headline, {N_SCENARIOS} x {N_AGENTS}, after one "
          f"warm-up step): replay bitwise equal to the eager substeps on "
          f"every state leaf: {equal} ({g.captures} capture, {g.replays} "
          f"replays) | {card}", flush=True)
    if not equal or (g.captures, g.replays) != (1, 2):
        fail("the graph substeps are not bitwise equal to the eager ones")
    turns = {"eager": [], "graph": []}
    for arm in ("eager", "graph", "graph", "eager"):
        fn = eager if arm == "eager" else graphed
        turns[arm].append(event_ms(lambda: fn(states1, f_des), 20))
    print(f"substeps (ten 1 kHz steps at {N_SCENARIOS} x {N_AGENTS}) in "
          f"turns, CUDA events around 20 host-driven calls: eager "
          f"{turns['eager'][0]:.4f} and {turns['eager'][1]:.4f} ms, graph "
          f"{turns['graph'][0]:.4f} and {turns['graph'][1]:.4f} ms a call | "
          f"{card}", flush=True)

    run_off, _, _ = rollout.build(n=N_AGENTS, n_scenarios=N_SCENARIOS,
                                  max_iter=20, inner_iters=20,
                                  cuda_graph=False)
    run_off(css0, states0, 1)  # warm-up.
    rates = {"on": [], "off": []}
    for arm in ("on", "off", "off", "on"):
        fn = run if arm == "on" else run_off
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(css0, states0, GRAPH_STEPS)
        torch.cuda.synchronize()
        rates[arm].append(N_SCENARIOS * GRAPH_STEPS
                          / (time.perf_counter() - t0))
    print(f"fixed headline with the graph on and off in turns ({GRAPH_STEPS} "
          f"MPC steps each): on {rates['on'][0]:.2f} and {rates['on'][1]:.2f}"
          f", off {rates['off'][0]:.2f} and {rates['off'][1]:.2f} "
          f"scenario-MPC-steps/s | {card}", flush=True)
    profiles = {}
    for arm, fn in (("on", run), ("off", run_off)):
        wall, ph = profile_step(lambda: fn(css0, states0, 1))
        print_profile(f"one fixed-headline step, graph {arm}", wall, ph, card)
        profiles[arm] = {"wall_ms": wall, "phases": ph}

    step_g, (cs_e, st_e, acc_e) = entry.entry()
    step_x, _ = entry.entry(cuda_graph=False)
    out_g = step_g(cs_e, st_e, acc_e)
    out_x = step_x(cs_e, st_e, acc_e)
    torch.cuda.synchronize()
    e_equal = tree_equal(out_x[1], out_g[1])
    pg = step_g.physics
    print(f"graph entry physics (law once, ten integrations, B = 1): state "
          f"after one period bitwise equal to the eager period's: {e_equal} "
          f"({pg.captures} capture, {pg.replays} replays) | {card}",
          flush=True)
    if not e_equal or pg.captures != 1:
        fail("the entry's graph physics is not bitwise equal to the eager")
    periods = {"on": [], "off": []}
    for arm in ("on", "off", "off", "on"):
        fn = step_g if arm == "on" else step_x
        cs, st = cs_e, st_e
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            cs, st, _ = fn(cs, st, acc_e)
        torch.cuda.synchronize()
        periods[arm].append(TIMED_STEPS / (time.perf_counter() - t0))
    print(f"entry periods/s with the graph on and off in turns ({TIMED_STEPS}"
          f" periods each): on {periods['on'][0]:.2f} and "
          f"{periods['on'][1]:.2f}, off {periods['off'][0]:.2f} and "
          f"{periods['off'][1]:.2f} | {card}", flush=True)
    wall, ph = profile_step(lambda: step_g(cs_e, st_e, acc_e))
    print_profile("one entry period, graph on", wall, ph, card)
    report["graph"] = {
        "substeps_bitwise_equal": equal, "entry_bitwise_equal": e_equal,
        "substeps_ms_in_turns": turns, "headline_rates_in_turns": rates,
        "headline_profiles": profiles, "entry_periods_per_s_in_turns":
        periods, "entry_profile": {"wall_ms": wall, "phases": ph},
    }


def logged_rollout_phase(card, report):
    """Phase 22, the logged rollout through ``jit_rollout``: C-ADMM at 256 x
    8 with the forest reference for LOG_STEPS high-level steps, the
    substeps from the graph; every log leaf finite; the whole-solve kernel
    launched once per consensus iteration run; the first 8 scenarios'
    logs against the CPU's eager rollout (states 1e-4, forces 1e-2 N,
    iteration counts equal)."""
    import torch

    from tpu_aerial_transport_torch.harness import rollout
    from tpu_aerial_transport_torch.tree import leaves

    def logged(device, S, **kw):
        ctl = rollout.make_controller("cadmm", N_AGENTS, max_iter=20,
                                      inner_iters=20, device=device, **kw)
        run = rollout.jit_rollout(
            ctl.control, ctl.ll.control, ctl.params, n_hl_steps=LOG_STEPS,
            acc_des_fn=rollout.make_forest_acc_des(ctl.forest))
        return (run, rollout.scenario_batch(ctl.state0, S),
                rollout.stack_scenarios(ctl.cs0, S))

    run, states, css = logged("cuda", N_SCENARIOS)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, logs = run(states, css)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    runs = int(logs.iters.max(dim=1).values.sum())
    check_launches(launches, "fused_solve", runs, "the logged rollout")
    for name, t in vars(logs).items():
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            fail(f"the logged rollout's {name} log is not finite")
    g = run.substeps.graph
    if (g.captures, g.replays) != (1, LOG_STEPS):
        fail(f"the logged rollout's substeps: {g.captures} captures and "
             f"{g.replays} replays, expected 1 and {LOG_STEPS}")
    # The first call captured the graph; a second runs as a chained
    # receding-horizon caller's calls do.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(states, css)
    torch.cuda.synchronize()
    secs2 = time.perf_counter() - t0
    n_cpu = 8
    run_c, states_c, css_c = logged("cpu", n_cpu, pad_operators=True)
    _, _, logs_c = run_c(states_c, css_c)
    cut = lambda t: t[:, :n_cpu].cpu()  # noqa: E731
    errs = {f: float((getattr(logs_c, f) - cut(getattr(logs, f))).abs()
                     .max()) for f in STATE_FIELDS + ("x_err", "v_err")}
    f_err = float((logs_c.f_des - cut(logs.f_des)).abs().max())
    it_card, it_cpu = cut(logs.iters).tolist(), logs_c.iters.tolist()
    ok = (max(errs.values()) <= CPU_STATE_ATOL and f_err <= CPU_FORCE_ATOL
          and it_card == it_cpu)
    print(f"logged rollout (jit_rollout, C-ADMM {N_SCENARIOS} x {N_AGENTS}, "
          f"forest reference, {LOG_STEPS} HL steps, graph substeps): "
          f"{secs:.4f} s = {N_SCENARIOS * LOG_STEPS / secs:.2f} "
          f"scenario-MPC-steps/s with the capture, {secs2:.4f} s = "
          f"{N_SCENARIOS * LOG_STEPS / secs2:.2f} in a second call | "
          f"{len(leaves(logs))} log leaves finite | "
          f"launches {launches} = consensus iterations run {runs} | first "
          f"{n_cpu} scenarios against the CPU's eager rollout: max|state or "
          f"error err| {max(errs.values()):.2e} (atol {CPU_STATE_ATOL}), "
          f"max|f_des err| {f_err:.2e} N (atol {CPU_FORCE_ATOL}), "
          f"iterations card {it_card} CPU {it_cpu} "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    if not ok:
        fail("the logged rollout on the card disagrees with the CPU")
    report["logged_rollout"] = {
        "seconds": secs, "seconds_second_call": secs2,
        "scenario_mpc_steps_per_s": N_SCENARIOS * LOG_STEPS / secs2,
        "launches": launches,
        "card_vs_cpu": {"err": errs, "f_des_err": f_err,
                        "iters_card": it_card, "iters_cpu": it_cpu}}


def bucketing_phase(card, report, run, css0, states0):
    """Phase 23, the bucketing A/B: ``buckets=0`` (the main path's ``run``)
    and ``buckets=2`` at 256 x 8 in turns, BUCKET_STEPS steps each from the
    seeded batch; per scenario the states, controller state and iteration
    counts of the two must be equal, exactly, or (where a library path's
    result depends on the batch size) with iteration counts equal and
    states within 1e-6, the difference reported; the iterations each
    bucket ran, step by step."""
    import torch

    from tpu_aerial_transport_torch.envs import forest as forest_mod
    from tpu_aerial_transport_torch.harness import bucketing, rollout, setup
    from tpu_aerial_transport_torch.tree import leaves

    run2, _, _ = rollout.build(n=N_AGENTS, n_scenarios=N_SCENARIOS,
                               max_iter=20, inner_iters=20, buckets=2)
    run2(css0, states0, 1)  # warm-up: captures the B / 2 graph.
    rates, outs = {0: [], 2: []}, {}
    for arm in (0, 2, 2, 0):
        fn = run if arm == 0 else run2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs[arm] = fn(css0, states0, BUCKET_STEPS)
        torch.cuda.synchronize()
        rates[arm].append(N_SCENARIOS * BUCKET_STEPS
                          / (time.perf_counter() - t0))
    (css_a, st_a, it_a), (css_b, st_b, it_b) = outs[0], outs[2]
    exact = torch.equal(it_a, it_b) and all(
        torch.equal(x, y) for x, y in zip(leaves((css_a, st_a)),
                                          leaves((css_b, st_b))))
    diff = max(float((x - y).abs().max()) for x, y in
               zip(leaves((css_a, st_a)), leaves((css_b, st_b)))
               if x.is_floating_point())
    ok = exact or (torch.equal(it_a, it_b) and diff <= BUCKET_STATE_ATOL)
    # The iterations each bucket ran, step by step (the buckets' worst
    # lanes), from the bucketed step run again.
    _, col, _ = setup.rqp_setup(N_AGENTS, device="cpu")
    metric = bucketing.env_congestion_metric(
        forest_mod.make_forest(seed=0, device="cuda"),
        col.collision_radius + rollout.BUCKET_METRIC_MARGIN)
    per_bucket, css, st = [], css0, states0
    half = N_SCENARIOS // 2
    for _ in range(BUCKET_STEPS):
        order = torch.argsort(metric(st), stable=True)
        css, st, stats = run2.mpc_step(css, st)
        # Each bucket's worst count and how many of its scenarios ran it.
        per_bucket.append([])
        for idx in (order[:half], order[half:]):
            it = stats.iters[idx]
            per_bucket[-1].append((int(it.max()),
                                   int((it == it.max()).sum())))
    unbucketed = it_a.max(dim=1).values.tolist()
    print(f"bucketing A/B (buckets=0 and 2, {N_SCENARIOS} x {N_AGENTS}, "
          f"{BUCKET_STEPS} MPC steps each, in turns 0, 2, 2, 0): buckets=0 "
          f"{rates[0][0]:.2f} and {rates[0][1]:.2f}, buckets=2 "
          f"{rates[2][0]:.2f} and {rates[2][1]:.2f} scenario-MPC-steps/s | "
          f"consensus iterations a step: one batch {unbucketed}, the two "
          f"buckets' (worst, scenarios at it) {per_bucket} | per-scenario "
          f"results "
          + ("exactly equal" if exact else
             f"not bitwise equal: iterations equal {torch.equal(it_a, it_b)},"
             f" max|state or controller-state diff| {diff:.3e} (atol "
             f"{BUCKET_STATE_ATOL})") + (" ok" if ok else " FAIL")
          + f" | {card}", flush=True)
    if not ok:
        fail("the bucketed step's per-scenario results differ from the "
             "unbucketed step's")
    report["bucketing"] = {
        "rates_in_turns": {str(k): v for k, v in rates.items()},
        "exact": exact, "max_abs_diff": diff,
        "iters_per_step_unbucketed": unbucketed,
        "iters_per_step_buckets": per_bucket,
    }


def padded_phase(card, report, args, kw):
    """Phase 24, the padded tier on the card: ``solve_socp_padded`` on the
    unpadded agent QPs captured from the headline set-up (nv = 12, m = 25,
    padded to 16 and 32) on routes "kernel" and "pallas", against
    ``solve_socp`` on the same unpadded QPs and route, within the kernel
    bar (against the unpadded solve's own float32 rounding, its distance
    from route "scan" in float64); the route the resolver takes, the
    launched body by kernel name (the warp body on both routes, or the
    phase fails), and both solves timed (CUDA graph)."""
    import torch

    from tpu_aerial_transport_torch.ops import admm_kernel, socp

    x, y, z, _, _, A, P, q, _, lb, ub, shift = args
    nv, n_box, soc = kw["nv"], kw["n_box"], tuple(kw["soc_dims"])
    B, m = x.shape[0], y.shape[-1]
    nv_p, n_box_p = socp.padded_dims(nv, n_box, soc)
    zeros = torch.zeros(B, device=x.device)
    warm = socp.SOCPSolution(x, y, z, zeros, zeros)
    solve_kw = dict(n_box=n_box, soc_dims=soc, iters=kw["iters"],
                    alpha=kw["alpha"], shift=shift, warm=warm)
    pqp = socp.padded_kkt_operator(P, A, lb, ub, shift, n_box=n_box,
                                   soc_dims=soc)
    op = socp.kkt_operator(P, A, socp.make_rho_vec(m, n_box, lb, ub, 0.4))
    ref64 = socp.solve_socp(
        *in_float64([P, q, A, lb, ub]), fused="scan",
        **dict(solve_kw, shift=shift.double(), warm=socp.SOCPSolution(
            *in_float64(warm))))
    names = ("x", "y", "z", "prim_res", "dual_res")
    out = {}
    for route in ("kernel", "pallas"):
        resolved = socp.runtime_fused_mode(route, nv_p, n_box_p + sum(soc),
                                           n_box_p, soc)
        zero_launches()
        got = socp.solve_socp_padded(P, q, A, lb, ub, pqp=pqp, fused=route,
                                     **solve_kw)
        torch.cuda.synchronize()
        launches = launch_counts()
        bodies = {k: v for k, v in {**admm_kernel.KERNEL_LAUNCHES,
                                    **admm_kernel.CHUNK_LAUNCHES}.items()
                  if v}
        form = "fused_solve" if route == "kernel" else "admm_chunk"
        what = f"the padded solve ({route})"
        check_launches(launches, form, 1, what)
        # A padded agent QP must reach the warp body, as an unpadded one
        # does: a fall back to the shared-memory or block body fails.
        if route == "kernel":
            check_body(launches, form, "warp_solve_kernel", what)
        elif admm_kernel.CHUNK_LAUNCHES != {"admm_chunk_kernel": 0,
                                            "warp_chunk_kernel": 1}:
            fail(f"{what} ran {admm_kernel.CHUNK_LAUNCHES}, expected "
                 f"warp_chunk_kernel once")
        ref = socp.solve_socp(P, q, A, lb, ub, op=op, fused=route, **solve_kw)
        errs, noise, ok = agreement(names, got, ref, ref64)
        padded_ms = cuda_ms(lambda: socp.solve_socp_padded(
            P, q, A, lb, ub, pqp=pqp, fused=route, **solve_kw), 20)
        flat_ms = cuda_ms(lambda: socp.solve_socp(
            P, q, A, lb, ub, op=op, fused=route, **solve_kw), 20)
        print(f"padded tier, route {route!r} (resolved {resolved!r}, "
              f"launched {bodies}): B={B}, d = {nv + m} padded to "
              f"{nv_p + n_box_p + sum(soc)}, {kw['iters']} iterations; "
              f"against the unpadded solve max|err| "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + "; unpadded float32 vs float64 "
              + " ".join(f"{n}={e:.3e}" for n, e in noise.items())
              + f" {'ok' if ok else 'FAIL'} | padded solve {padded_ms:.4f} "
              f"ms, unpadded {flat_ms:.4f} ms (CUDA graph, pad and unpad "
              f"included) | {card}", flush=True)
        if not ok or resolved != route:
            fail(f"the padded solve on route {route!r} disagrees with the "
                 f"unpadded one (resolved {resolved!r})")
        out[route] = {"resolved": resolved, "launched": bodies,
                      "max_abs_err": errs, "plain_f32_vs_f64": noise,
                      "padded_ms": padded_ms, "unpadded_ms": flat_ms}
    report["padded"] = out


def env_world(n_trees, device="cuda"):
    """``(forest, half_extent)``: the seed-0 mountain world at T = 200 (the
    paper's size), a jittered grid at ENV_CELL_DENSITY above it with
    ``world_size = (n_side + 0.5) * pitch`` (the JAX bench's ``_env_world``,
    bench.py:1051-1071)."""
    from tpu_aerial_transport_torch.envs import forest as forest_mod

    if n_trees <= forest_mod.MAX_TREES:
        return forest_mod.make_forest(seed=0, max_trees=n_trees,
                                      device=device), 28.0
    n_side = math.isqrt(n_trees)
    world_size = (n_side + 0.5) / math.sqrt(ENV_CELL_DENSITY)
    f = forest_mod.make_forest(seed=0, max_trees=n_trees, device=device,
                               world_size=world_size,
                               density=ENV_CELL_DENSITY)
    return f, world_size / 2.0 * 0.9


def env_query_phase(card, report):
    """Phase 25, the environment-query A/B (the JAX bench's
    ``_env_query_cell``, bench.py:1074-1140): at T = 200, 4096 and 65536
    trees, 64 scenarios drawn from ``default_rng(0)`` as that cell draws
    them, ENV_STEPS query steps through ``collision_cbf_rows`` (the batch
    drifting by +0.05 m a step), dense and bucketed in turns (one warm-up
    and ENV_REPEATS timed runs of each); batched queries/s, the grid's
    occupancy and build time, the resolved tier, each arm's peak device
    memory; the bucketed rows bitwise equal to the dense rows at every step
    and every T, or the phase fails."""
    import numpy as np
    import torch

    from tpu_aerial_transport_torch.envs import forest as forest_mod
    from tpu_aerial_transport_torch.envs import spatial
    from tpu_aerial_transport_torch.harness import setup

    _, col, _ = setup.rqp_setup(4, device="cpu")
    vision = col.collision_radius + 5.0
    out = {}
    for T in ENV_TREES:
        t0 = time.perf_counter()
        dense_f, half = env_world(T)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        buck_f = spatial.with_grid(dense_f, vision + dense_f.bark_radius)
        grid_s = time.perf_counter() - t0
        stats = spatial.grid_stats(buck_f.grid)
        rng = np.random.default_rng(0)
        xs = torch.tensor(np.concatenate(
            [rng.uniform(-half, half, (ENV_SCENARIOS, 2))
             + forest_mod.MOUNTAIN_CENTER,
             np.full((ENV_SCENARIOS, 1), 2.0)], axis=1),
            dtype=torch.float32, device="cuda")
        vs = torch.tensor(rng.normal(size=(ENV_SCENARIOS, 3)) * 0.5,
                          dtype=torch.float32, device="cuda")
        arms = {"dense": dense_f, "bucketed": buck_f}
        labels = {impl: spatial.runtime_env_query(impl, f)
                  for impl, f in arms.items()}

        def roll(impl):
            x, rows = xs, []
            for _ in range(ENV_STEPS):
                cbf = forest_mod.collision_cbf_rows(
                    arms[impl], x, vs, col.collision_radius,
                    col.max_deceleration, vision, 0.1, 1.5, 10,
                    env_query=impl)
                rows.append(cbf)
                x = x + 0.05
            return rows

        warm, peak = {}, {}
        for impl in arms:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            warm[impl] = roll(impl)
            torch.cuda.synchronize()
            peak[impl] = torch.cuda.max_memory_allocated() - base
        equal = all(
            torch.equal(getattr(a, k), getattr(b, k))
            for a, b in zip(warm["dense"], warm["bucketed"])
            for k in ("lhs", "rhs", "collision", "min_dist"))
        active = int(sum(int((r.lhs.abs().amax(-1) > 0).sum())
                         for r in warm["dense"]))
        del warm
        secs = {"dense": [], "bucketed": []}
        for impl in ("dense", "bucketed") * ENV_REPEATS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            roll(impl)
            torch.cuda.synchronize()
            secs[impl].append(time.perf_counter() - t0)
        rate = {impl: ENV_SCENARIOS * ENV_STEPS / float(np.median(s))
                for impl, s in secs.items()}
        print(f"env query T={T} ({int(dense_f.num_trees)} trees, world "
              f"generated in {gen_s:.2f} s, grid built in {grid_s:.2f} s: "
              f"{stats}): {ENV_SCENARIOS} scenarios x {ENV_STEPS} steps, "
              f"dense (resolved {labels['dense']!r}) "
              f"{rate['dense']:.1f} and bucketed (resolved "
              f"{labels['bucketed']!r}) {rate['bucketed']:.1f} batched "
              f"queries/s (median of {ENV_REPEATS} in turns; seconds "
              f"{ {k: [round(v, 5) for v in s] for k, s in secs.items()} }), "
              f"bucketed/dense {rate['bucketed'] / rate['dense']:.3f}x | "
              f"peak device memory above the run's start: dense "
              f"{peak['dense'] / 2**20:.1f} MiB, bucketed "
              f"{peak['bucketed'] / 2**20:.1f} MiB | {active} active rows, "
              f"bucketed rows bitwise equal to dense at every step: {equal}"
              f" | {card}", flush=True)
        if not equal or labels != {"dense": "dense", "bucketed": "bucketed"}:
            fail(f"env query T={T}: the bucketed rows differ from the dense "
                 f"rows (or the tiers resolved {labels})")
        out[str(T)] = {
            "queries_per_s": rate, "seconds_in_turns": secs,
            "peak_bytes": peak, "grid": stats, "grid_build_s": grid_s,
            "world_gen_s": gen_s, "resolved": labels, "active_rows": active,
            "bitwise_equal": equal}
        del dense_f, buck_f, arms
        torch.cuda.empty_cache()
    report["env_query"] = out


def city_forest(device="cuda"):
    """The JAX package's ``examples/city_forest.py`` default world (16384
    trees at 0.085 trees/m^2, seed 0) with its grid at the C-ADMM and DD
    configs' vision radius + bark radius (n = 8): ``(forest, grid build s,
    grid_stats)``."""
    from tpu_aerial_transport_torch.envs import spatial
    from tpu_aerial_transport_torch.harness import setup

    forest, _ = env_world(CITY_TREES, device)
    _, col, _ = setup.rqp_setup(N_AGENTS, device="cpu")
    t0 = time.perf_counter()
    forest = spatial.with_grid(forest, col.collision_radius + 5.0
                               + forest.bark_radius)
    return forest, time.perf_counter() - t0, spatial.grid_stats(forest.grid)


def city_batch(state0, n_scenarios):
    """The city example's start over the headline's batch: the xy offsets
    of ``rollout.scenario_batch``'s draw (``default_rng(0)``, N(0, 2^2))
    around (0, 0), z at BARK_HEIGHT + 1 m above the canopy, v = (0.5, 0,
    0) m/s."""
    import numpy as np
    import torch

    from tpu_aerial_transport_torch.envs import forest as forest_mod
    from tpu_aerial_transport_torch.harness import rollout

    xs = np.random.default_rng(0).normal(size=(n_scenarios, 3)) * 2.0
    xs[:, 2] = forest_mod.BARK_HEIGHT + 1.0
    states = rollout.scenario_batch(state0, n_scenarios)
    return states.replace(xl=torch.as_tensor(xs, dtype=torch.float32,
                                             device=state0.xl.device))


def rollout_vs_cpu(what, controller, card, n_hl_steps, forest, ll_type="pd",
                   n_cpu=8, batch=None, **kw):
    """``n_hl_steps`` high-level steps of ``controller`` at 256 x 8 through
    ``rollout.jit_rollout`` (the substeps from the graph) on the card, run
    twice (the first call captures the graph) with every launch counter
    zeroed before the second and read after it: one whole-solve launch
    (the warp body) per consensus iteration run, every log leaf finite;
    then the first ``n_cpu`` scenarios against the CPU's eager rollout of
    the same set-up (states 1e-4, forces 1e-2 N, iteration counts equal).
    ``batch(state0, S)`` makes the start (default: the headline's);
    ``ll_type`` names the SO(3) law. Returns ``(report dict, ctl, run,
    states, css)``."""
    import torch

    from tpu_aerial_transport_torch.control import lowlevel
    from tpu_aerial_transport_torch.harness import rollout
    from tpu_aerial_transport_torch.tree import tree_map

    batch = batch or rollout.scenario_batch

    def logged(device, S, f, **extra):
        ctl = rollout.make_controller(controller, N_AGENTS, max_iter=20,
                                      forest=f, device=device, **kw, **extra)
        ll = lowlevel.make_lowlevel_controller(ll_type, ctl.params)
        run = rollout.jit_rollout(
            ctl.control, ll.control, ctl.params, n_hl_steps=n_hl_steps,
            acc_des_fn=rollout.make_forest_acc_des(ctl.forest))
        return (ctl, run, batch(ctl.state0, S),
                rollout.stack_scenarios(ctl.cs0, S))

    ctl, run, states, css = logged("cuda", N_SCENARIOS, forest)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(states, css)
    torch.cuda.synchronize()
    secs1 = time.perf_counter() - t0
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, logs = run(states, css)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = launch_counts()
    runs = int(logs.iters.max(dim=1).values.sum())
    check_launches(launches, "fused_solve", runs, what)
    check_body(launches, "fused_solve", "warp_solve_kernel", what)
    for name, t in vars(logs).items():
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            fail(f"{what}: the {name} log is not finite")
    g = run.substeps.graph
    if (g.captures, g.replays) != (1, 2 * n_hl_steps):
        fail(f"{what}: {g.captures} captures and {g.replays} replays, "
             f"expected 1 and {2 * n_hl_steps}")
    forest_c = None if forest is None else tree_map(lambda t: t.cpu(),
                                                    forest)
    _, run_c, states_c, css_c = logged("cpu", n_cpu, forest_c,
                                       pad_operators=True)
    _, _, logs_c = run_c(states_c, css_c)
    cut = lambda t: t[:, :n_cpu].cpu()  # noqa: E731
    errs = {f: float((getattr(logs_c, f) - cut(getattr(logs, f))).abs()
                     .max()) for f in STATE_FIELDS + ("x_err", "v_err")}
    f_err = float((logs_c.f_des - cut(logs.f_des)).abs().max())
    it_card, it_cpu = cut(logs.iters).tolist(), logs_c.iters.tolist()
    ok = (max(errs.values()) <= CPU_STATE_ATOL and f_err <= CPU_FORCE_ATOL
          and it_card == it_cpu)
    rate = N_SCENARIOS * n_hl_steps / secs
    print(f"{what} (jit_rollout, {controller} {N_SCENARIOS} x {N_AGENTS}, "
          f"{ll_type} law, {n_hl_steps} HL steps): first call (captures) "
          f"{secs1:.4f} s, second {secs:.4f} s = {rate:.2f} "
          f"scenario-MPC-steps/s | launches {launches} = consensus "
          f"iterations run {runs}, all warp_solve_kernel | first {n_cpu} "
          f"scenarios against the CPU's eager rollout: max|state or error "
          f"err| {max(errs.values()):.2e} (atol {CPU_STATE_ATOL}), "
          f"max|f_des err| {f_err:.2e} N (atol {CPU_FORCE_ATOL}), iterations"
          f" card {it_card} CPU {it_cpu} " + ("ok" if ok else "FAIL")
          + f" | {card}", flush=True)
    if not ok:
        fail(f"{what}: the card disagrees with the CPU")
    return ({"seconds_first_call": secs1, "seconds": secs,
             "scenario_mpc_steps_per_s": rate, "launches": launches,
             "card_vs_cpu": {"err": errs, "f_des_err": f_err,
                             "iters_card": it_card, "iters_cpu": it_cpu}},
            ctl, run, states, css)


def city_phase(card, report):
    """Phase 26, the city world on the main path: the city example's world
    with its grid; C-ADMM at 256 x 8 through ``jit_rollout`` with the
    forest reference and ``env_query="auto"`` (which must resolve to
    "bucketed"), CITY_STEPS high-level steps, twice, against the CPU; on
    the first step's inputs the bucketed per-agent rows bitwise equal to
    the dense rows on the card; one profiled step's ``tat.env_query``; then
    DD likewise."""
    import dataclasses

    import torch

    from tpu_aerial_transport_torch.control import cadmm
    from tpu_aerial_transport_torch.envs import spatial
    from tpu_aerial_transport_torch.harness import rollout

    t0 = time.perf_counter()
    forest, grid_s, stats = city_forest()
    print(f"city world: {int(forest.num_trees)} trees, built with its grid "
          f"in {time.perf_counter() - t0:.2f} s (grid {grid_s:.2f} s): "
          f"{stats} | {card}", flush=True)
    out = {"grid": stats, "grid_build_s": grid_s}
    out["cadmm"], ctl, run, states, css = rollout_vs_cpu(
        "city C-ADMM", "cadmm", card, CITY_STEPS, forest, batch=city_batch,
        inner_iters=20)
    label = spatial.runtime_env_query(ctl.cfg.env_query, forest)
    print(f"city C-ADMM: env_query {ctl.cfg.env_query!r} resolved "
          f"{label!r} on {forest.tree_pos.shape[0]} tree slots | {card}",
          flush=True)
    if label != "bucketed":
        fail(f"the city world resolved env_query {label!r}, not 'bucketed'")
    rows, peak = {}, {}
    for mode in ("dense", "bucketed"):
        cfg = dataclasses.replace(ctl.cfg, env_query=mode)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rows[mode] = cadmm.agent_env_cbfs(ctl.params, cfg, forest, states)
        torch.cuda.synchronize()
        peak[mode] = torch.cuda.max_memory_allocated() - base
    equal = all(torch.equal(getattr(rows["dense"], k),
                            getattr(rows["bucketed"], k))
                for k in ("lhs", "rhs", "collision", "min_dist"))
    active = int((rows["dense"].lhs.abs().amax(-1) > 0).sum())
    print(f"city C-ADMM first-step per-agent rows ({N_SCENARIOS} x "
          f"{N_AGENTS} x {ctl.cfg.n_env_cbfs}, {active} active): bucketed "
          f"bitwise equal to dense on the card: {equal} | peak device "
          f"memory dense {peak['dense'] / 2**20:.1f} MiB, bucketed "
          f"{peak['bucketed'] / 2**20:.1f} MiB | {card}", flush=True)
    if not equal:
        fail("the city world's bucketed rows differ from the dense rows")
    acc_fn = rollout.make_forest_acc_des(ctl.forest)

    def one_step():
        acc, _, _ = acc_fn(states, 0.0)
        f_des, _, _ = ctl.control(css, states, acc)
        run.substeps(states, f_des)

    wall, ph = profile_step(one_step)
    print_profile("one city C-ADMM step (bucketed query, graph substeps; "
                  "the mountain headline step's tat.env_query: 24.18 ms of "
                  "host time, PERF.md section 5)", wall, ph, card)
    out["cadmm"].update(
        resolved=label, rows_bitwise_equal=equal, active_rows=active,
        rows_peak_bytes=peak, profile={"wall_ms": wall, "phases": ph})
    out["dd"] = rollout_vs_cpu("city DD", "dd", card, CITY_STEPS, forest,
                               batch=city_batch)[0]
    report["city"] = out


def sm_phase(card, report, run, css0, states0):
    """Phase 27, the sliding-mode law: the headline's ten substeps with
    ``make_lowlevel_controller("sm")`` after one warm-up MPC step, the graph
    replay bitwise equal to the eager substeps; eager and graph timed in
    turns; then SM_STEPS MPC steps (C-ADMM 256 x 8, the SM law) through
    ``jit_rollout`` against the CPU."""
    import torch

    from tpu_aerial_transport_torch.control import lowlevel
    from tpu_aerial_transport_torch.harness import rollout

    css1, states1, _ = run(css0, states0, 1)
    ctl = rollout.make_controller("cadmm", N_AGENTS, max_iter=20,
                                  inner_iters=20, device="cuda")
    sm = lowlevel.make_lowlevel_controller("sm", ctl.params)
    acc = (torch.tensor([0.3, 0.0, 0.0], device="cuda"),
           torch.zeros(3, device="cuda"))
    f_des = ctl.control(css1, states1, acc)[0]
    eager = rollout.make_substeps(ctl.params, sm.control, cuda_graph=False)
    graphed = rollout.make_substeps(ctl.params, sm.control)
    ref = eager(states1, f_des)
    first = graphed(states1, f_des)
    again = graphed(states1, f_des)
    torch.cuda.synchronize()
    g = graphed.graph
    equal = tree_equal(ref, first) and tree_equal(ref, again)
    finite = all(bool(torch.isfinite(getattr(ref, f)).all())
                 for f in STATE_FIELDS)
    counts = (g.captures, g.replays)
    turns = {"eager": [], "graph": []}
    for arm in ("eager", "graph", "graph", "eager"):
        fn = eager if arm == "eager" else graphed
        turns[arm].append(event_ms(lambda: fn(states1, f_des), 20))
    print(f"SM substeps (ten 1 kHz steps, {N_SCENARIOS} x {N_AGENTS}, after "
          f"one warm-up step): replay bitwise equal to the eager substeps "
          f"on every state leaf: {equal} ({counts[0]} capture, {counts[1]} "
          f"replays), finite {finite} | in turns, CUDA events around 20 "
          f"host-driven calls: eager {turns['eager'][0]:.4f} and "
          f"{turns['eager'][1]:.4f} ms, graph {turns['graph'][0]:.4f} and "
          f"{turns['graph'][1]:.4f} ms a call | {card}", flush=True)
    if not (equal and finite) or counts != (1, 2):
        fail("the SM substeps' graph replay is not bitwise equal to the "
             "eager substeps")
    steps = rollout_vs_cpu("SM law rollout", "cadmm", card, SM_STEPS, None,
                           ll_type="sm", inner_iters=20)[0]
    report["sm"] = {"substeps_bitwise_equal": equal,
                    "substeps_ms_in_turns": turns, "rollout": steps}


def control_step_phase(card, report):
    """Phase 28, ``jit_control_step``: C-ADMM and DD at 256 x 8 for
    JIT_STEPS steps each from the headline's batch (physics advanced by the
    graph substeps): ``donate=True`` and ``donate=False`` outputs bitwise
    equal to ``control`` on the same inputs, the donated state handed back
    in the storage of the state passed in at every step, the undonated
    input untouched; one whole-solve launch per iteration in the donated
    chain."""
    import torch

    from tpu_aerial_transport_torch.control import cadmm, centralized, dd
    from tpu_aerial_transport_torch.harness import rollout
    from tpu_aerial_transport_torch.tree import leaves, tree_map

    out = {}
    for controller, mod in (("cadmm", cadmm), ("dd", dd)):
        ctl = rollout.make_controller(controller, N_AGENTS, max_iter=20,
                                      device="cuda")
        f_eq = centralized.equilibrium_forces(ctl.params)
        states = rollout.scenario_batch(ctl.state0, N_SCENARIOS)
        css = rollout.stack_scenarios(ctl.cs0, N_SCENARIOS)
        acc = (torch.tensor([0.3, 0.0, 0.0], device="cuda"),
               torch.zeros(3, device="cuda"))
        substeps = rollout.make_substeps(ctl.params, ctl.ll.control)
        ref, seq, cs = [], [states], css
        for _ in range(JIT_STEPS):
            o = ctl.control(cs, seq[-1], acc)
            ref.append(o)
            cs = o[1]
            seq.append(substeps(seq[-1], o[0]))
        keep = mod.jit_control_step(ctl.params, ctl.cfg, f_eq, ctl.forest,
                                    donate=False)
        donate = mod.jit_control_step(ctl.params, ctl.cfg, f_eq, ctl.forest)
        carry = tree_map(torch.clone, css)
        ptrs = [t.data_ptr() for t in leaves(carry)]
        cs_keep, equal, shared, untouched = css, True, True, True
        zero_launches()
        runs = 0
        for k in range(JIT_STEPS):
            before = tree_map(torch.clone, cs_keep)
            o_keep = keep(cs_keep, seq[k], acc)
            untouched &= tree_equal(before, cs_keep)
            o_don = donate(carry, seq[k], acc)
            runs += 2 * int(o_don[2].iters.max())
            shared &= (o_don[1] is carry and [
                t.data_ptr() for t in leaves(o_don[1])] == ptrs)
            equal &= all(
                tree_equal((o[0], o[1]), ref[k][:2])
                and torch.equal(o[2].iters, ref[k][2].iters)
                for o in (o_keep, o_don))
            cs_keep = o_keep[1]
        torch.cuda.synchronize()
        launches = launch_counts()
        check_launches(launches, "fused_solve", runs,
                       f"jit_control_step ({controller})")
        print(f"jit_control_step ({controller}, {N_SCENARIOS} x {N_AGENTS}, "
              f"{JIT_STEPS} steps, donate=True and False): outputs bitwise "
              f"equal to control on the same inputs: {equal}; the donated "
              f"state in the storage passed in at every step: {shared}; "
              f"the undonated input untouched: {untouched} | launches "
              f"{launches} = consensus iterations run {runs} | {card}",
              flush=True)
        if not (equal and shared and untouched):
            fail(f"jit_control_step ({controller}) differs from control or "
                 "does not share the donated storage")
        out[controller] = {"bitwise_equal": equal, "storage_shared": shared,
                           "input_untouched": untouched,
                           "launches": launches}
    report["jit_control_step"] = out


def fault_schedules(S, killer=True):
    """Phase 29's schedules, one per scenario on the CPU, each keyed
    ``prng_key(s)``, by scenario index mod 4: no fault (but active), agent
    0 lost at step 3, 30% consensus dropout held 2 steps, agent 5 degraded
    to 0.6 thrust from step 2 with 0.01 sensor noise; with ``killer`` the
    last scenario's agent 0 gets an infinite thrust scale from
    KILL_STEP."""
    from tpu_aerial_transport_torch.resilience import faults, prng

    groups = (dict(), dict(t_fail={0: 3}), dict(drop_rate=0.3, drop_hold=2),
              dict(t_degrade={5: 2}, thrust_scale=0.6, noise_std=0.01))
    out = []
    for s in range(S):
        kw = groups[s % 4]
        if killer and s == S - 1:
            kw = dict(t_degrade={0: KILL_STEP}, thrust_scale=math.inf)
        out.append(faults.make_schedule(
            N_AGENTS, key=prng.prng_key(s, device="cpu"), device="cpu",
            **kw))
    return faults.stack_schedules(out)


def on_card(tree):
    from tpu_aerial_transport_torch.tree import tree_map

    return tree_map(lambda t: t.cuda(), tree)


def resilient_run(controller, device, S, sched, steps, shards=1,
                  telemetry=None, **kw):
    """``(ctl, run, states, css)``: ``controller`` at S x 8 on ``device``
    through ``resilience.jit_resilient_rollout`` with the health-aware step
    and the forest reference, ``steps`` high-level steps."""
    from tpu_aerial_transport_torch.harness import rollout
    from tpu_aerial_transport_torch.resilience import rollout as res

    ctl = rollout.make_controller(controller, N_AGENTS, max_iter=20,
                                  shards=shards, device=device, **kw)
    make = (res.make_cadmm_hl_step if controller == "cadmm"
            else res.make_dd_hl_step)
    hl = make(ctl.params, ctl.cfg, ctl.forest, shards=shards)
    run = res.jit_resilient_rollout(
        hl, ctl.ll.control, ctl.params, n_hl_steps=steps,
        acc_des_fn=rollout.make_forest_acc_des(ctl.forest), faults=sched,
        telemetry=telemetry)
    return (ctl, run, rollout.scenario_batch(ctl.state0, S),
            rollout.stack_scenarios(ctl.cs0, S))


def logs_vs_cpu(logs, logs_c, n_cpu, force_bar):
    """The first ``n_cpu`` scenarios' logs against the CPU's: max state and
    error difference, max force difference, iteration counts and rungs."""
    cut = lambda t: t[:logs_c.xl.shape[0], :n_cpu].cpu()  # noqa: E731
    errs = {f: float((getattr(logs_c, f) - cut(getattr(logs, f))).abs()
                     .max()) for f in STATE_FIELDS + ("x_err", "v_err")}
    f_err = float((logs_c.f_des - cut(logs.f_des)).abs().max())
    same = (cut(logs.iters).tolist() == logs_c.iters.tolist()
            and cut(logs.fallback_rung).tolist()
            == logs_c.fallback_rung.tolist())
    ok = max(errs.values()) <= CPU_STATE_ATOL and f_err <= force_bar and same
    return ok, {"err": errs, "f_des_err": f_err,
                "iters_card": cut(logs.iters).tolist(),
                "iters_cpu": logs_c.iters.tolist(), "counts_equal": same}


def timed_call(run, states, css):
    """``(seconds, outputs)`` of one ``run`` call, ending in a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(states, css)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def resilient_phase(card, report):
    """Phase 29, the resilient headline: C-ADMM at 256 x 8 in the seed-0
    forest through ``jit_resilient_rollout`` with phase 29's per-scenario
    schedules (``fault_schedules``), RES_STEPS steps after one warm-up
    call. Checks: the fault masks on the card bitwise the CPU's (and the
    sensor noise within NOISE_ATOL); one ``warp_solve_kernel`` launch per
    consensus iteration run; the scaled substeps' graph replay bitwise the
    eager substeps, the killer's infinite scale included; the killer
    scenario quarantined from KILL_STEP with its state frozen, no other
    scenario quarantined; every other scenario's logs bitwise equal to a
    run whose last scenario has a benign schedule; lost agents' forces exactly zero from their death
    step; every state finite; the first 8 scenarios against the CPU over
    RES_CPU_STEPS steps (phase 22's bars, rungs and counts equal); and
    ``faults=None`` and ``no_faults(8)`` bitwise ``jit_rollout`` with the
    same launch count. Prints each group's rung histogram and carried load,
    the resilient and plain rates in turns, one profiled step's host time
    in ``tat.faults`` and ``tat.fallback``, and the cost of the masked
    equilibrium's pseudo-inverse. Returns the CPU schedules and the
    timed run's logs (phase 32 compares with them)."""
    import torch

    from tpu_aerial_transport_torch.control import centralized
    from tpu_aerial_transport_torch.harness import rollout
    from tpu_aerial_transport_torch.models.rqp import GRAVITY
    from tpu_aerial_transport_torch.resilience import faults
    from tpu_aerial_transport_torch.resilience import rollout as res

    S = N_SCENARIOS
    sched_c = fault_schedules(S)
    sched = on_card(sched_c)
    masks_equal, noise_err = True, 0.0
    ctl, run, states, css = resilient_run("cadmm", "cuda", S, sched,
                                          RES_STEPS)
    for t in range(RES_STEPS):
        a, b = faults.fault_step(sched, t), faults.fault_step(sched_c, t)
        masks_equal &= all(torch.equal(getattr(a, k).cpu(), getattr(b, k))
                           for k in ("alive", "thrust_scale", "msg_ok"))
    states_c = states.replace(**{k: getattr(states, k).cpu() for k in (
        "xl", "vl", "w")})
    for t in (0, RES_STEPS - 1):
        na = faults.apply_sensor_noise(sched, t, states)
        nb = faults.apply_sensor_noise(sched_c, t, states_c)
        noise_err = max(noise_err, *(float((getattr(na, k).cpu()
                                            - getattr(nb, k)).abs().max())
                                     for k in ("xl", "vl", "w")))
    print(f"fault masks on the card ({S} per-scenario schedules, "
          f"{RES_STEPS} steps) bitwise the CPU's: {masks_equal}; sensor "
          f"noise max|card - CPU| {noise_err:.2e} (atol {NOISE_ATOL}) | "
          f"{card}", flush=True)
    if not masks_equal or noise_err > NOISE_ATOL:
        fail("the fault draws on the card differ from the CPU's")

    warm_s, _ = timed_call(run, states, css)
    zero_launches()
    secs, (state, _, logs) = timed_call(run, states, css)
    launches = launch_counts()
    runs = int(logs.iters.max(dim=1).values.sum())
    what = "the resilient headline"
    check_launches(launches, "fused_solve", runs, what)
    check_body(launches, "fused_solve", "warp_solve_kernel", what)
    g = run.substeps.graph
    if (g.captures, g.replays) != (1, 2 * RES_STEPS):
        fail(f"{what}: {g.captures} captures and {g.replays} replays, "
             f"expected 1 and {2 * RES_STEPS}")
    for f in STATE_FIELDS + ("f_des",):
        if not bool(torch.isfinite(getattr(logs, f)).all()):
            fail(f"{what}: the {f} log is not finite")
    # The scaled substeps' replay bitwise the eager substeps, on the last
    # step's forces and thrust scales (the killer's +inf among them).
    scale = faults.fault_step(sched, RES_STEPS - 1).thrust_scale
    eager = rollout.make_substeps(ctl.params, ctl.ll.control,
                                  cuda_graph=False, scaled=True)
    replay_bits = tree_bits_equal(run.substeps(states, logs.f_des[-1], scale),
                                  eager(states, logs.f_des[-1], scale))
    quar = logs.quarantined
    K = S - 1
    q_steps = torch.nonzero(quar[:, K]).flatten().tolist()
    if (not q_steps or q_steps[0] != KILL_STEP
            or q_steps != list(range(KILL_STEP, RES_STEPS))
            or bool(quar[:, :K].any())):
        fail(f"{what}: quarantine steps of scenario {K}: {q_steps}, others "
             f"flagged: {int(quar[:, :K].any(dim=0).sum())}")
    frozen = bool((logs.xl[KILL_STEP:, K] == logs.xl[KILL_STEP - 1, K])
                  .all())
    g1 = [s for s in range(S) if s % 4 == 1]
    dead_zero = bool((logs.f_des[3:, g1, 0] == 0.0).all())
    # The same batch with a benign last scenario: every other lane bitwise.
    _, run_b, _, _ = resilient_run("cadmm", "cuda", S,
                                   on_card(fault_schedules(S, False)),
                                   RES_STEPS)
    _, _, logs_b = run_b(states, css)
    keys = STATE_FIELDS + ("f_des", "x_err", "v_err", "iters", "solve_res",
                           "fallback_rung")
    leak = [k for k in keys if not torch.equal(getattr(logs, k)[:, :K],
                                               getattr(logs_b, k)[:, :K])]
    n_cpu = 8
    _, run_c, states_c8, css_c = resilient_run(
        "cadmm", "cpu", n_cpu, tree_rows(sched_c, n_cpu), RES_CPU_STEPS,
        pad_operators=True)
    _, _, logs_c = run_c(states_c8, css_c)
    cpu_ok, cpu = logs_vs_cpu(logs, logs_c, n_cpu, CPU_FORCE_ATOL)
    print(f"{what} (jit_resilient_rollout, C-ADMM {S} x {N_AGENTS}, forest "
          f"reference, {RES_STEPS} HL steps): {secs:.4f} s = "
          f"{S * RES_STEPS / secs:.2f} scenario-MPC-steps/s (warm-up call "
          f"{warm_s:.4f} s) | launches {launches} = consensus iterations "
          f"run {runs}, all warp_solve_kernel | the scaled substeps' graph "
          f"replay bitwise the eager ones (+inf scale included): "
          f"{replay_bits} | scenario {K} quarantined at "
          f"steps {q_steps}, xl frozen: {frozen}; no other flagged | the "
          f"other {K} scenarios bitwise the benign run's in {len(keys)} "
          f"log leaves: {not leak} | lost agents' forces exactly 0: "
          f"{dead_zero} | first {n_cpu} scenarios over {RES_CPU_STEPS} "
          f"steps against the CPU: max|state or error err| "
          f"{max(cpu['err'].values()):.2e} (atol {CPU_STATE_ATOL}), "
          f"max|f_des err| {cpu['f_des_err']:.2e} N (atol {CPU_FORCE_ATOL})"
          f", counts and rungs equal: {cpu['counts_equal']} "
          + ("ok" if cpu_ok else "FAIL") + f" | {card}", flush=True)
    if not (frozen and dead_zero and not leak and cpu_ok and replay_bits):
        fail(f"{what}: frozen {frozen}, lost agents zero {dead_zero}, lane "
             f"leakage in {leak}, CPU agreement {cpu_ok}, graph replay "
             f"bitwise {replay_bits}")

    # Each group's rungs and carried load (sum of f_z over m_T g).
    mtg = float(ctl.params.mT) * GRAVITY
    groups = {}
    names = ("nominal", "agent 0 lost at 3", "30% dropout",
             "agent 5 at 0.6 + noise")
    for gi, name in enumerate(names):
        lanes = [s for s in range(S) if s % 4 == gi and s != K]
        rungs = torch.bincount(logs.fallback_rung[:, lanes].flatten().cpu(),
                               minlength=4).tolist()
        load = (logs.f_des[..., 2].sum(-1)[:, lanes] / mtg).cpu()
        groups[name] = {"rung_hist": rungs, "load_mean": float(load.mean()),
                        "load_min": float(load.min()),
                        "load_max": float(load.max())}
        print(f"  group {name!r} ({len(lanes)} scenarios): rung histogram "
              f"{rungs}, sum f_z / m_T g mean {float(load.mean()):.4f} "
              f"(min {float(load.min()):.4f}, max {float(load.max()):.4f})",
              flush=True)
    rungs_k = logs.fallback_rung[:, K].tolist()
    print(f"  killer scenario {K}: rungs {rungs_k}", flush=True)

    # Zero cost when off: faults=None and no_faults(8) against jit_rollout.
    plain = rollout.jit_rollout(
        ctl.control, ctl.ll.control, ctl.params, n_hl_steps=RES_STEPS,
        acc_des_fn=rollout.make_forest_acc_des(ctl.forest))
    nominal = {}
    for name, f in (("jit_rollout", None), ("faults=None", None),
                    ("no_faults", faults.no_faults(N_AGENTS))):
        r = plain if name == "jit_rollout" else resilient_run(
            "cadmm", "cuda", S, f, RES_STEPS)[1]
        zero_launches()
        out = r(states, css)
        torch.cuda.synchronize()
        nominal[name] = (out, launch_counts())
    ref, ref_l = nominal["jit_rollout"]
    same = {name: (tree_equal(o[0], ref[0])
                   and torch.equal(o[2].f_des, ref[2].f_des) and l == ref_l)
            for name, (o, l) in nominal.items() if name != "jit_rollout"}
    print(f"zero cost when off: faults=None and no_faults({N_AGENTS}) "
          f"against jit_rollout ({RES_STEPS} steps): every state leaf and "
          f"f_des bitwise equal and the same launches ({ref_l}): {same} | "
          f"{card}", flush=True)
    if not all(same.values()):
        fail("the nominal resilient rollout differs from jit_rollout")

    # Rates in turns: resilient, plain, plain, resilient.
    turns = {"resilient": [S * RES_STEPS / secs], "plain": []}
    for arm in ("plain", "plain", "resilient"):
        r = plain if arm == "plain" else run
        turns[arm].append(S * RES_STEPS / timed_call(r, states, css)[0])
    print(f"scenario-MPC-steps/s in turns (resilient, plain, plain, "
          f"resilient; {RES_STEPS} steps each): resilient "
          f"{turns['resilient'][0]:.2f} and {turns['resilient'][1]:.2f}, "
          f"plain {turns['plain'][0]:.2f} and {turns['plain'][1]:.2f}: "
          f"ratio {sum(turns['resilient']) / sum(turns['plain']):.3f} | "
          f"{card}", flush=True)

    # One profiled step, and the masked equilibrium's pseudo-inverse.
    run1 = res.jit_resilient_rollout(
        res.make_cadmm_hl_step(ctl.params, ctl.cfg, ctl.forest),
        ctl.ll.control, ctl.params, n_hl_steps=1,
        acc_des_fn=rollout.make_forest_acc_des(ctl.forest), faults=sched)
    run1(states, css)
    wall, ph = profile_step(lambda: run1(states, css))
    print_profile("one resilient headline step (faults active, graph "
                  "substeps)", wall, ph, card)
    alive = faults.fault_step(sched, RES_STEPS - 1).alive
    pinv_ms = event_ms(
        lambda: centralized.equilibrium_forces(ctl.params, alive), 20)
    print(f"the masked equilibrium forces ({S} x {N_AGENTS} masks, batched "
          f"SVD pseudo-inverse, a host synchronisation): {pinv_ms:.4f} ms a "
          f"call, twice a step (the hl_step's and rung 3's) | {card}",
          flush=True)
    report["resilient"] = {
        "seconds": secs, "warmup_seconds": warm_s,
        "scenario_mpc_steps_per_s": S * RES_STEPS / secs,
        "launches": launches, "iterations_run": runs,
        "quarantined_steps": q_steps, "groups": groups,
        "killer_rungs": rungs_k, "card_vs_cpu": cpu,
        "noise_err": noise_err, "nominal_bitwise": same,
        "rates_in_turns": turns, "pinv_ms": pinv_ms,
        "profile": {"wall_ms": wall, "phases": ph}}
    return sched_c, logs


def tree_bits_equal(a, b) -> bool:
    """Every leaf of two state trees equal bit for bit, NaNs included."""
    import torch

    from tpu_aerial_transport_torch.tree import leaves

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    return all(torch.equal(bits(x), bits(y))
               for x, y in zip(leaves(a), leaves(b)))


def tree_rows(tree, n):
    """The first ``n`` entries of every leaf's leading axis."""
    from tpu_aerial_transport_torch.tree import tree_map

    return tree_map(lambda t: t[:n], tree)


def dd_fault_phase(card, report):
    """Phase 30, DD with a lost agent: DD (adaptive effort, the early-exit
    kernel) at 256 x 8 through ``make_dd_hl_step`` for DD_FAULT_STEPS
    steps, agent 0 lost at step 1 in every scenario: one
    ``warp_solve_early_kernel`` launch per dual-ascent iteration, agent
    0's forces exactly zero from step 1, every state finite, and the first
    8 scenarios against the CPU: iteration counts and rungs equal at every
    step, and step 0 (every agent alive) within CPU_STATE_ATOL and
    DD_FORCE_BAR. After the loss DD does not converge, in the JAX package
    as here (the quasi-Newton step keeps its all-healthy cores; the JAX
    package's own n = 8 run ends each step at its 21-iteration cap with a
    consensus residual of ~21 N), and its last iterate turns on which
    agent solves pass ``solver_tol``, so the later steps' distance from the
    CPU is printed, not held to a bar."""
    import torch

    from tpu_aerial_transport_torch.resilience import faults

    sched_c = faults.make_schedule(N_AGENTS, t_fail={0: 1}, device="cpu")
    _, run, states, css = resilient_run(
        "dd", "cuda", N_SCENARIOS, on_card(sched_c), DD_FAULT_STEPS,
        effort="adaptive")
    zero_launches()
    secs, (_, _, logs) = timed_call(run, states, css)
    launches = launch_counts()
    runs = int(logs.iters.max(dim=1).values.sum())
    what = "DD with a lost agent"
    check_launches(launches, "fused_solve_early", runs, what)
    check_body(launches, "fused_solve_early", "warp_solve_early_kernel",
               what)
    for f in STATE_FIELDS + ("f_des",):
        if not bool(torch.isfinite(getattr(logs, f)).all()):
            fail(f"{what}: the {f} log is not finite")
    dead_zero = bool((logs.f_des[1:, :, 0] == 0.0).all())
    n_cpu = 8
    _, run_c, states_c, css_c = resilient_run(
        "dd", "cpu", n_cpu, sched_c, DD_FAULT_STEPS, effort="adaptive",
        pad_operators=True)
    _, _, logs_c = run_c(states_c, css_c)
    _, cpu_all = logs_vs_cpu(logs, logs_c, n_cpu, math.inf)
    ok0, cpu0 = logs_vs_cpu(logs, tree_rows(logs_c, 1), n_cpu,
                            DD_FORCE_BAR)
    ok = ok0 and cpu_all["counts_equal"]
    rungs = torch.bincount(logs.fallback_rung.flatten().cpu(),
                           minlength=4).tolist()
    res_max = float(logs.solve_res[1:].max())
    print(f"{what} (jit_resilient_rollout, DD adaptive {N_SCENARIOS} x "
          f"{N_AGENTS}, agent 0 lost at step 1, {DD_FAULT_STEPS} steps, "
          f"the capture included): {secs:.4f} s | launches {launches} = "
          f"dual-ascent iterations run {runs}, all warp_solve_early_kernel "
          f"| agent 0's forces exactly 0 from step 1: {dead_zero} | rung "
          f"histogram {rungs}, worst final residual after the loss "
          f"{res_max:.3e} N | first {n_cpu} scenarios against the CPU: "
          f"counts and rungs equal at every step: "
          f"{cpu_all['counts_equal']}; step 0 max|state or error err| "
          f"{max(cpu0['err'].values()):.2e} (atol {CPU_STATE_ATOL}), "
          f"max|f_des err| {cpu0['f_des_err']:.2e} N (atol {DD_FORCE_BAR}) "
          + ("ok" if ok else "FAIL") + f"; after the loss (unconverged, "
          f"not held) max|state err| {max(cpu_all['err'].values()):.2e}, "
          f"max|f_des err| {cpu_all['f_des_err']:.2e} N | {card}",
          flush=True)
    if not (ok and dead_zero):
        fail(f"{what}: CPU agreement {ok}, lost agent zero {dead_zero}")
    report["dd_fault"] = {"seconds": secs, "launches": launches,
                          "iterations_run": runs, "rung_hist": rungs,
                          "res_max_after_loss": res_max,
                          "card_vs_cpu_step0": cpu0,
                          "card_vs_cpu_all_steps": cpu_all}


def telemetry_phase(card, report):
    """Phase 31, telemetry: the headline through ``jit_rollout`` with
    ``TelemetryConfig(track_agents=True)`` and ``track_agent_stats=True``,
    RES_STEPS steps. The accumulator's counts (``steps``, ``rung_hist``,
    ``iters_sum``, ``consensus_hist``, ``collision_steps``,
    ``agent_fail_steps``) equal a host recount from the logs and the
    recorded per-agent residuals exactly; ``res_min``/``res_max`` exact,
    ``res_sum`` to float32; the P² markers equal a host replay of the
    estimator over each scenario's logged residuals (P2_RTOL). Ten
    observations a scenario are too few for P²'s accuracy bound, so the
    estimator also folds a P2_STREAM-observation lognormal stream a
    scenario on the card: scenario 0's is the stream of
    ``tests/test_telemetry.py:77-97``, held to its bound (P2_BOUND of
    ``np.percentile``); the worst scenario's deviation is printed. Prints ms a step with telemetry on and off in turns."""
    import numpy as np
    import torch

    from tpu_aerial_transport_torch.harness import rollout
    from tpu_aerial_transport_torch.obs import telemetry as tel_mod

    S = N_SCENARIOS
    ctl = rollout.make_controller("cadmm", N_AGENTS, max_iter=20,
                                  track_agent_stats=True, device="cuda")
    agent_res = []

    def recording(css, states, acc):
        out = ctl.control(css, states, acc)
        agent_res.append(out[2].agent_solve_res)
        return out

    tcfg = tel_mod.TelemetryConfig(track_agents=True)
    acc_fn = rollout.make_forest_acc_des(ctl.forest)
    run_rec = rollout.jit_rollout(recording, ctl.ll.control, ctl.params,
                                  n_hl_steps=RES_STEPS, acc_des_fn=acc_fn,
                                  telemetry=tcfg)
    states = rollout.scenario_batch(ctl.state0, S)
    css = rollout.stack_scenarios(ctl.cs0, S)
    _, _, logs, tel = run_rec(states, css)
    host = {k: getattr(tel, k).cpu() for k in tel_mod.LEAF_FIELDS}
    it = logs.iters.cpu()
    res = logs.solve_res.cpu()
    ares = torch.stack(agent_res).cpu()
    fin = torch.isfinite(res)
    recount = {
        "steps": torch.full((S,), RES_STEPS, dtype=torch.int32),
        "rung_hist": torch.stack([torch.bincount(
            logs.fallback_rung[:, s].cpu(), minlength=4)
            for s in range(S)]).to(torch.int32),
        "iters_sum": it.clamp(min=0).sum(0).to(torch.int32),
        "consensus_hist": torch.as_tensor(np.stack([
            tel_mod.iter_histogram(it[:, s].numpy())
            for s in range(S)])).to(torch.int32),
        "collision_steps": logs.collision.cpu().sum(0).to(torch.int32),
        "agent_fail_steps": ((~torch.isfinite(ares))
                             | (ares >= tcfg.solver_tol)).sum(0).to(
                                 torch.int32),
    }
    counts_ok = {k: torch.equal(host[k], v) for k, v in recount.items()}
    inf = torch.full_like(res, math.inf)
    res_min_ok = torch.equal(host["res_min"],
                             torch.where(fin, res, inf).amin(0))
    res_max_ok = torch.equal(host["res_max"],
                             torch.where(fin, res, -inf).amax(0))
    res_sum_ref = torch.where(fin, res, 0.0).double().sum(0)
    res_sum_err = float(((host["res_sum"].double() - res_sum_ref).abs()
                         / res_sum_ref.abs().clamp(min=1e-30)).max())
    # The estimator replayed on the host over the logged residuals.
    rep = tel_mod.init_telemetry(tcfg, N_AGENTS, device="cpu", batch=(S,))
    q, npos, count = rep.p2_q, rep.p2_n, rep.res_count
    for t in range(RES_STEPS):
        q2, n2 = tel_mod._p2_update(tcfg, q, npos, count, res[t])
        f = fin[t][:, None, None]
        q, npos = torch.where(f, q2, q), torch.where(f, n2, npos)
        count = count + fin[t].to(torch.int32)
    p2_err = float(((host["p2_q"] - q).abs()
                    / q.abs().clamp(min=1e-30)).nan_to_num(0.0).max())
    p2_pos_ok = torch.equal(host["p2_n"], npos)
    # A long stream a scenario folded on the card; scenario 0's is the
    # stream of tests/test_telemetry.py:77-97, held to its accuracy bound.
    xs = np.concatenate([
        np.random.default_rng(0).lognormal(-3.0, 1.0, (P2_STREAM, 1)),
        np.random.default_rng(1).lognormal(-3.0, 1.0, (P2_STREAM, S - 1)),
    ], axis=1).astype(np.float32)
    lane = tel_mod.init_telemetry(tcfg, device="cuda", batch=(S,))
    q_l, n_l, c_l = lane.p2_q, lane.p2_n, lane.res_count
    for x in torch.as_tensor(xs).cuda():
        q_l, n_l = tel_mod._p2_update(tcfg, q_l, n_l, c_l, x)
        c_l = c_l + 1
    est = q_l[..., 2].cpu().numpy()
    dev = np.stack([np.abs(est[:, i] - np.percentile(xs, p * 100, axis=0))
                    / np.percentile(xs, p * 100, axis=0)
                    for i, p in enumerate(tcfg.quantiles)], axis=1)
    test_dev, worst = float(dev[0].max()), float(dev.max())
    ok = (all(counts_ok.values()) and res_min_ok and res_max_ok
          and res_sum_err <= 1e-5 and p2_err <= P2_RTOL and p2_pos_ok
          and test_dev < P2_BOUND)
    summary = tel_mod.summary(tel)
    print(f"telemetry (jit_rollout, C-ADMM {S} x {N_AGENTS}, track_agents, "
          f"{RES_STEPS} steps): counts equal to the host recount "
          f"{counts_ok}; res_min/res_max exact {res_min_ok}/{res_max_ok}, "
          f"res_sum rel err {res_sum_err:.2e}; P² markers against the host "
          f"replay rel err {p2_err:.2e} (rtol {P2_RTOL}), positions equal "
          f"{p2_pos_ok}; P² on the card over {P2_STREAM} lognormal "
          f"observations a scenario: the test's stream (scenario 0) "
          f"p50/p90/p99 within {test_dev:.4f} of np.percentile (bound "
          f"{P2_BOUND}), the worst of the {S} streams {worst:.4f} | "
          f"summary: "
          f"rungs {summary['rung_hist']}, residual p50/p90/p99 "
          f"{summary['residual']['p50']:.3e}/{summary['residual']['p90']:.3e}"
          f"/{summary['residual']['p99']:.3e}, agent_fail_steps "
          f"{summary['agent_fail_steps']} " + ("ok" if ok else "FAIL")
          + f" | {card}", flush=True)
    if not ok:
        fail("the telemetry accumulator disagrees with the logs")
    # ms a step with telemetry on (the recording run, its graph captured)
    # and off, in turns.
    run_on = run_rec
    run_off = rollout.jit_rollout(ctl.control, ctl.ll.control, ctl.params,
                                  n_hl_steps=RES_STEPS, acc_des_fn=acc_fn)
    run_off(states, css)
    turns = {"on": [], "off": []}
    for arm in ("on", "off", "off", "on"):
        r = run_on if arm == "on" else run_off
        turns[arm].append(1e3 * timed_call(r, states, css)[0] / RES_STEPS)
    print(f"ms a step with telemetry on and off in turns (on, off, off, "
          f"on; {RES_STEPS} steps each): on {turns['on'][0]:.2f} and "
          f"{turns['on'][1]:.2f}, off {turns['off'][0]:.2f} and "
          f"{turns['off'][1]:.2f} | {card}", flush=True)
    report["telemetry"] = {
        "counts_equal": counts_ok, "res_sum_rel_err": res_sum_err,
        "p2_replay_rel_err": p2_err, "p2_test_stream_dev": test_dev, "p2_stream_worst_dev": worst,
        "summary": summary, "ms_per_step_in_turns": turns}


def sharded_fault_phase(card, report, sched_c, logs_single):
    """Phase 32, sharded health: C-ADMM at 256 x 8 over SHARDS shards with
    ``pallas_ring`` and phase 29's schedules for SHARDED_FAULT_STEPS steps:
    one whole-solve launch per consensus iteration and two ring sums an
    iteration plus one a step (the alive count); against the single
    program's first steps of phase 29 (the same schedules): iteration
    counts equal in SHARDED_EQUAL_SHARE of the scenarios, forces within
    SHARDED_HEALTH_BAR on those."""
    import torch

    _, run, states, css = resilient_run(
        "cadmm", "cuda", N_SCENARIOS, on_card(sched_c), SHARDED_FAULT_STEPS,
        shards=SHARDS, consensus_impl="pallas_ring")
    zero_launches()
    secs, (_, _, logs) = timed_call(run, states, css)
    launches = launch_counts()
    runs = int(logs.iters.max(dim=1).values.sum())
    what = "sharded C-ADMM with faults"
    check_launch_counts(launches, {
        "fused_solve": runs, "ring_sum": 2 * runs + SHARDED_FAULT_STEPS},
        what)
    single = tree_rows(logs_single, SHARDED_FAULT_STEPS)
    same = (logs.iters == single.iters).all(dim=0)
    share = float(same.float().mean())
    f_err = (float((logs.f_des - single.f_des)[:, same].abs().max())
             if bool(same.any()) else math.inf)
    ok = share >= SHARDED_EQUAL_SHARE and f_err <= SHARDED_HEALTH_BAR
    print(f"{what} ({SHARDS} shards, pallas_ring, {N_SCENARIOS} x "
          f"{N_AGENTS}, phase 29's schedules, {SHARDED_FAULT_STEPS} steps, "
          f"the capture included): {secs:.4f} s | launches {launches}: "
          f"whole-solve = iterations run {runs}, ring sums = 2 x {runs} + "
          f"{SHARDED_FAULT_STEPS} | against the single program: counts "
          f"equal in {100 * share:.2f}% (bar {100 * SHARDED_EQUAL_SHARE:.0f}"
          f"%), max|f_des err| on those {f_err:.3e} N (bar "
          f"{SHARDED_HEALTH_BAR}) " + ("ok" if ok else "FAIL")
          + f" | {card}", flush=True)
    if not ok:
        fail(f"{what} disagrees with the single program")
    report["sharded_fault"] = {"seconds": secs, "launches": launches,
                               "iterations_run": runs, "equal_share": share,
                               "f_des_err": f_err}


def recovery_setup(S):
    """Phase 33's set-up, the same in the parent and in its children: the
    headline's C-ADMM at S x 8 (``max_iter=20``, ``inner_iters=20``, fixed
    effort, forest seed 0, the forest reference, the ``default_rng(0)``
    batch) chunked by ``make_chunked_rollout`` (REC_STEPS steps in
    REC_CHUNKS chunks), and the run's config hash. Returns ``(ctl, run,
    states, css, acc, config_hash)``."""
    from tpu_aerial_transport_torch.harness import checkpoint, rollout

    ctl = rollout.make_controller("cadmm", N_AGENTS, max_iter=20,
                                  inner_iters=20, effort="fixed",
                                  device="cuda")
    acc = rollout.make_forest_acc_des(ctl.forest)
    run = rollout.make_chunked_rollout(
        ctl.control, ctl.ll.control, ctl.params, n_hl_steps=REC_STEPS,
        n_chunks=REC_CHUNKS, acc_des_fn=acc)
    config_hash = checkpoint.config_fingerprint(
        params=ctl.params, n=N_AGENTS, scenarios=S, max_iter=20,
        inner_iters=20, forest_seed=0, n_hl_steps=REC_STEPS,
        n_chunks=REC_CHUNKS)
    return (ctl, run, rollout.scenario_batch(ctl.state0, S),
            rollout.stack_scenarios(ctl.cs0, S), acc, config_hash)


def leaf_digests(tree) -> list:
    """The sha256 of every leaf's bytes, in tree order."""
    import hashlib

    import numpy as np

    from tpu_aerial_transport_torch.tree import leaves

    return [hashlib.sha256(np.ascontiguousarray(
        t.detach().cpu().numpy()).tobytes()).hexdigest()
        for t in leaves(tree)]


def recovery_child(mode: str, run_dir: str, S: int) -> int:
    """Phase 33's child process. ``preempt``: the chunked headline through
    ``run_chunks`` into ``run_dir`` under ``GracefulInterrupt``, sending
    itself SIGTERM during chunk REC_STOP_CHUNK, so the run stops at that
    chunk's boundary. ``resume``: ``resume_run`` on ``run_dir`` with a
    tracer on the metrics file (its ``resume`` span times the walk over
    the snapshots). Prints one ``recovery-child {json}`` line: the status,
    the chunks, the seconds, and for ``resume`` the per-leaf digests of
    the final carry and the concatenated logs. Never prints the final
    result line."""
    import signal

    import torch

    from tpu_aerial_transport_torch.obs import export, trace
    from tpu_aerial_transport_torch.resilience import recovery

    t0 = time.perf_counter()
    ctl, run, states, css, _, config_hash = recovery_setup(S)
    metrics = os.path.join(run_dir, "run.metrics.jsonl")
    if mode == "preempt":
        plan = recovery.RunPlan(
            run_dir=run_dir, n_hl_steps=REC_STEPS, n_chunks=REC_CHUNKS,
            seed=0, config_hash=config_hash,
            meta={"controller": "cadmm", "n": N_AGENTS, "scenarios": S})

        def chunk(carry, i0):
            out = run.chunk_jit(carry, i0)
            if i0 == REC_STOP_CHUNK * run.chunk_len:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        with recovery.GracefulInterrupt() as interrupt:
            res = recovery.run_chunks(plan, chunk,
                                      run.init_carry(states, css),
                                      interrupt=interrupt, metrics=metrics)
        out = {"status": res.status, "chunks_done": res.chunks_done,
               "signal": interrupt.triggered}
    else:
        tracer = trace.Tracer(export.MetricsWriter(metrics), track="resume")
        res = recovery.resume_run(run_dir, run.chunk_jit,
                                  run.init_carry(states, css),
                                  config_hash=config_hash, metrics=metrics,
                                  tracer=tracer)
        out = {"status": res.status, "chunks_done": res.chunks_done,
               "resumed_from_chunk": res.resumed_from_chunk,
               "digests": leaf_digests((res.carry, res.logs))}
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    print("recovery-child " + json.dumps(out), flush=True)
    return 0


# The command of phase 33's children (this script in its child mode).
CHILD_CMD = [sys.executable, os.path.abspath(__file__)]


def spawn_recovery_child(mode: str, run_dir: str, S: int):
    """``(wall seconds, the child's recovery-child record)``; fails the
    phase if the child fails, prints no record, or prints a result
    line."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        CHILD_CMD + ["--recovery-child", mode, run_dir, str(S)],
        capture_output=True, text=True, timeout=300, cwd=HERE)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    recs = [json.loads(line.split(" ", 1)[1]) for line in lines
            if line.startswith("recovery-child ")]
    if proc.returncode != 0 or len(recs) != 1 or any(
            '"ok"' in line for line in lines):
        fail(f"phase 33's {mode} child exited {proc.returncode}: stdout "
             f"{proc.stdout[-2000:]!r} stderr {proc.stderr[-4000:]!r}")
    return wall, recs[0]


def flip_payload_byte(path: str) -> None:
    """Rewrite a snapshot with one byte of its first leaf's payload flipped
    and the stale manifest kept: the zip container stays valid, so only
    the per-leaf digest can catch it."""
    import numpy as np

    raw = dict(np.load(path, allow_pickle=False))
    leaf = raw["leaf_000000"]
    flipped = np.frombuffer(leaf.tobytes(), np.uint8).copy()
    flipped[0] ^= 1
    raw["leaf_000000"] = flipped.view(leaf.dtype).reshape(leaf.shape)
    with open(path, "wb") as fh:
        np.savez(fh, **raw)


def recovery_phase(card, report):
    """Phase 33, chunked rollouts and crash recovery at the headline's
    N_SCENARIOS x 8 (``recovery_setup``):

    (a) ``make_chunked_rollout`` (REC_STEPS steps in REC_CHUNKS chunks)
    against ``jit_rollout``: final state, controller state and every log
    leaf bitwise equal, one substeps capture and REC_STEPS replays across
    the chunks, equal ``warp_solve_kernel`` launches; the two rates in
    turns (chunked, plain, plain, chunked); the cost of one boundary
    publish (``host_copy`` + the carry and log snapshots).
    (b) a child process runs it through ``run_chunks`` and SIGTERMs itself
    during chunk REC_STOP_CHUNK: ``preempted`` with REC_STOP_CHUNK + 1
    chunks done; the parent flips a payload byte of that chunk's carry
    snapshot; a second child ``resume_run``s, skips the snapshot as
    ``corrupt`` and starts a chunk earlier; its final carry and logs,
    leaf by leaf by sha256, are the uninterrupted run's.
    (c) the resilient headline with phase 29's schedules (the last
    scenario's thrust scale +inf from KILL_STEP) through
    ``make_chunked_resilient_rollout``: bitwise ``jit_resilient_rollout``,
    the quarantine flag in the carry from the first boundary after
    KILL_STEP, the other scenarios bitwise a benign run's; preempted after
    chunk REC_STOP_CHUNK and resumed in-process, bitwise the uninterrupted
    chunked run.
    (d) the metrics file passes ``validate_file``; the journal holds
    ``run_start``, the chunks, ``preempted``, ``resume``, the rest of the
    chunks and ``done``."""
    import shutil

    import torch

    from tpu_aerial_transport_torch.harness import checkpoint, rollout
    from tpu_aerial_transport_torch.obs import export, trace
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.resilience import recovery
    from tpu_aerial_transport_torch.resilience import rollout as res
    from tpu_aerial_transport_torch.tree import leaves

    S = N_SCENARIOS
    what = "phase 33"
    ctl, run, states, css, acc, config_hash = recovery_setup(S)
    plain = rollout.jit_rollout(ctl.control, ctl.ll.control, ctl.params,
                                n_hl_steps=REC_STEPS, acc_des_fn=acc)
    # (a) Chunked against unchunked.
    outs, warp, boundary = {}, {}, []
    for name in ("plain", "chunked"):
        zero_launches()
        if name == "plain":
            outs[name] = plain(states, css)
        else:
            outs[name] = run(states, css, on_boundary=lambda c, carry, lg:
                             boundary.append((carry, lg)))
        torch.cuda.synchronize()
        warp[name] = dict(admm_kernel.KERNEL_LAUNCHES)
    g = run.substeps.graph
    graph = (g.captures, g.replays)
    bits = tree_bits_equal(outs["plain"], outs["chunked"])
    runs = int(outs["chunked"][2].iters.max(dim=1).values.sum())
    n_warp = warp["chunked"].get("warp_solve_kernel", 0)
    if not bits or graph != (1, REC_STEPS) or (
            warp["plain"] != warp["chunked"] or n_warp != runs):
        fail(f"{what}: chunked bitwise the unchunked run: {bits}; substeps "
             f"{graph[0]} captures, {graph[1]} replays (expected 1, "
             f"{REC_STEPS}); launches plain {warp['plain']} chunked "
             f"{warp['chunked']}, consensus iterations run {runs}")
    turns = {"chunked": [], "plain": []}
    for arm in ("chunked", "plain", "plain", "chunked"):
        secs, _ = timed_call(run if arm == "chunked" else plain, states, css)
        turns[arm].append(S * REC_STEPS / secs)
    print(f"{what} (a): make_chunked_rollout ({REC_STEPS} HL steps in "
          f"{REC_CHUNKS} chunks, C-ADMM {S} x {N_AGENTS}, forest reference) "
          f"bitwise jit_rollout in the final state, controller state and "
          f"every log leaf: {bits} | substeps graph {graph[0]} capture, "
          f"{graph[1]} replays across the chunks | warp_solve_kernel "
          f"launches {n_warp} in each run = consensus iterations run {runs} "
          f"| scenario-MPC-steps/s in turns (chunked, plain, plain, "
          f"chunked): chunked {turns['chunked'][0]:.2f} and "
          f"{turns['chunked'][1]:.2f}, plain {turns['plain'][0]:.2f} and "
          f"{turns['plain'][1]:.2f} | {card}", flush=True)

    # The cost of one boundary publish, on chunk 0's carry and logs.
    carry0, logs0 = boundary[0]
    pub_dir = os.path.join(HERE, "build", "recovery_publish")
    shutil.rmtree(pub_dir, ignore_errors=True)
    carry_bytes = sum(t.numel() * t.element_size() for t in leaves(carry0))
    logs_bytes = sum(t.numel() * t.element_size() for t in leaves(logs0))
    pub_ms = []
    for i in range(REC_PUBLISHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = recovery.host_copy(carry0)
        checkpoint.save_snapshot(pub_dir, i, host, prefix="carry",
                                 config_hash=config_hash)
        checkpoint.save_snapshot(pub_dir, i, logs0, prefix="logs",
                                 config_hash=config_hash, keep_last=0)
        pub_ms.append((time.perf_counter() - t0) * 1e3)
    shutil.rmtree(pub_dir, ignore_errors=True)
    print(f"{what}: one boundary publish (host_copy + save_snapshot of the "
          f"carry, {carry_bytes / 1e6:.3f} MB, and of the chunk's logs, "
          f"{logs_bytes / 1e6:.3f} MB; fsync'd): "
          + ", ".join(f"{m:.2f}" for m in pub_ms) + f" ms | {card}",
          flush=True)

    # (b) Preempt in a child, corrupt, resume in a second child.
    run_dir = os.path.join(HERE, "build", "recovery_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    wall_p, rec_p = spawn_recovery_child("preempt", run_dir, S)
    if (rec_p["status"], rec_p["chunks_done"], rec_p["signal"]) != (
            "preempted", REC_STOP_CHUNK + 1, "SIGTERM"):
        fail(f"{what}: the preempted child reported {rec_p}")
    snap = checkpoint.snapshot_path(run_dir, REC_STOP_CHUNK,
                                    recovery.CARRY_PREFIX)
    flip_payload_byte(snap)
    wall_r, rec_r = spawn_recovery_child("resume", run_dir, S)
    ref_digests = leaf_digests(((outs["plain"][0], outs["plain"][1]),
                                outs["plain"][2]))
    same = rec_r["digests"] == ref_digests
    journal = recovery.RunJournal(run_dir).read()
    events = [e["event"] for e in journal]
    resume = next((e for e in journal if e["event"] == "resume"), {})
    expect = (["run_start"] + ["chunk"] * (REC_STOP_CHUNK + 1)
              + ["preempted", "resume"]
              + ["chunk"] * (REC_CHUNKS - REC_STOP_CHUNK) + ["done"])
    metrics = os.path.join(run_dir, "run.metrics.jsonl")
    errors = export.validate_file(metrics)
    walk = [r for r in trace.trace_rows(export.read_events(metrics))
            if r["name"] == trace.RESUME]
    walk_ms = ((walk[0]["t1_mono"] - walk[0]["t0_mono"]) * 1e3
               if walk else math.nan)
    skipped = resume.get("skipped", [])
    ok = (same and rec_r["resumed_from_chunk"] == REC_STOP_CHUNK
          and rec_r["status"] == "done" and events == expect and not errors
          and len(walk) == 1 and skipped and "[corrupt]" in skipped[0])
    print(f"{what} (b): a child ran run_chunks and SIGTERMed itself in chunk "
          f"{REC_STOP_CHUNK}: {rec_p['status']} with {rec_p['chunks_done']} "
          f"chunks done (child wall {wall_p:.2f} s, {rec_p['seconds']:.2f} s "
          f"inside); one payload byte of {os.path.basename(snap)} flipped; a "
          f"second child's resume_run skipped it ({skipped[:1]}) and resumed "
          f"from chunk {rec_r['resumed_from_chunk']} (child wall {wall_r:.2f}"
          f" s, {rec_r['seconds']:.2f} s inside; the resume walk "
          f"{walk_ms:.2f} ms): final carry and logs, {len(ref_digests)} "
          f"leaves by sha256, bitwise the uninterrupted run: {same} | "
          f"(d) journal {events} as expected: {events == expect}; metrics "
          f"file errors {errors} | " + ("ok" if ok else "FAIL")
          + f" | {card}", flush=True)
    if not ok:
        fail(f"{what}: the preempted-and-resumed run (resumed from "
             f"{rec_r.get('resumed_from_chunk')}, digests equal {same}, "
             f"journal {events}, metrics errors {errors}, walk spans "
             f"{len(walk)}, skipped {skipped})")

    # (c) The resilient headline, chunked, preempted and resumed.
    K = S - 1
    sched = on_card(fault_schedules(S))
    hl = res.make_cadmm_hl_step(ctl.params, ctl.cfg, ctl.forest)

    def chunked_res(faults_):
        return res.make_chunked_resilient_rollout(
            hl, ctl.ll.control, ctl.params, n_hl_steps=REC_STEPS,
            n_chunks=REC_CHUNKS, acc_des_fn=acc, faults=faults_)

    runr = chunked_res(sched)
    carries = []
    whole = runr(states, css,
                 on_boundary=lambda c, carry, lg: carries.append(carry))
    unchunked = res.jit_resilient_rollout(
        hl, ctl.ll.control, ctl.params, n_hl_steps=REC_STEPS,
        acc_des_fn=acc, faults=sched)(states, css)
    flags = [bool(c[3][K]) for c in carries]
    first_q = KILL_STEP // runr.chunk_len  # the first flagged boundary.
    benign = chunked_res(on_card(fault_schedules(S, False)))(states, css)[2]
    keys = STATE_FIELDS + ("f_des", "x_err", "v_err", "iters", "solve_res",
                           "fallback_rung")
    leak = [k for k in keys if not torch.equal(getattr(whole[2], k)[:, :K],
                                               getattr(benign, k)[:, :K])]
    res_dir = os.path.join(HERE, "build", "recovery_resilient")
    shutil.rmtree(res_dir, ignore_errors=True)
    interrupt = recovery.GracefulInterrupt()

    def stopping(carry, i0):
        out = runr.chunk_jit(carry, i0)
        if i0 == REC_STOP_CHUNK * runr.chunk_len:
            interrupt.triggered = "SIGTERM"
        return out

    plan = recovery.RunPlan(run_dir=res_dir, n_hl_steps=REC_STEPS,
                            n_chunks=REC_CHUNKS, config_hash=config_hash)
    pre = recovery.run_chunks(plan, stopping, runr.init_carry(states, css),
                              interrupt=interrupt)
    resumed = recovery.resume_run(res_dir, runr.chunk_jit,
                                  runr.init_carry(states, css),
                                  config_hash=config_hash)
    chunked_bits = tree_bits_equal(whole, unchunked)
    resumed_bits = (tree_bits_equal(carries[-1], resumed.carry)
                    and tree_bits_equal(whole[2], resumed.logs))
    ok_c = (chunked_bits and resumed_bits
            and flags == [i >= first_q for i in range(REC_CHUNKS)]
            and bool(whole[2].quarantined[KILL_STEP:, K].all())
            and not bool(whole[2].quarantined[:, :K].any()) and not leak
            and pre.chunks_done == REC_STOP_CHUNK + 1
            and resumed.resumed_from_chunk == REC_STOP_CHUNK + 1)
    print(f"{what} (c): make_chunked_resilient_rollout (phase 29's "
          f"schedules, scenario {K} at +inf thrust from step {KILL_STEP}) "
          f"bitwise jit_resilient_rollout: {chunked_bits} | scenario {K}'s "
          f"quarantine flag in the carry at the {REC_CHUNKS} boundaries "
          f"(every {runr.chunk_len} steps): {flags} | the other {K} "
          f"scenarios bitwise a benign run's in {len(keys)} log leaves: "
          f"{not leak} | preempted after {pre.chunks_done} chunks, resumed "
          f"in-process from chunk {resumed.resumed_from_chunk}: carry and "
          f"logs bitwise the uninterrupted chunked run's: {resumed_bits} "
          + ("ok" if ok_c else "FAIL") + f" | {card}", flush=True)
    if not ok_c:
        fail(f"{what}: the chunked resilient run (flags {flags}, lane "
             f"leakage in {leak}, preempted after {pre.chunks_done}, resumed "
             f"from {resumed.resumed_from_chunk})")
    report["recovery"] = {
        "chunked_bitwise": bits, "warp_solve_launches": n_warp,
        "iterations_run": runs, "graph": list(graph),
        "rates_in_turns": turns, "publish_ms": pub_ms,
        "carry_bytes": carry_bytes, "logs_bytes": logs_bytes,
        "child_wall_s": {"preempt": wall_p, "resume": wall_r},
        "child_inside_s": {"preempt": rec_p["seconds"],
                           "resume": rec_r["seconds"]},
        "resume_walk_ms": walk_ms, "journal": events,
        "resilient_flags": flags, "resilient_chunked_bitwise": chunked_bits,
        "resilient_resumed_bitwise": resumed_bits}


def main() -> int:
    child = sys.argv[1:2] == ["--recovery-child"]
    if not os.path.isdir(os.path.join(HERE, PKG)):
        print(f"chip_smoke: the {PKG} package is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this smoke "
              "runs on an NVIDIA card only", file=sys.stderr)
        return 1
    if child:
        mode, run_dir, S = sys.argv[2:5]
        return recovery_child(mode, run_dir, int(S))

    from tpu_aerial_transport_torch.harness import rollout
    from tpu_aerial_transport_torch.ops import _build, admm_kernel

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | host: {os.cpu_count()} cores, load "
          f"{os.getloadavg()[0]:.2f}", flush=True)
    report = {"card": card, "kind": kind}
    # Seconds since the start at which each phase began (the report's
    # "phase_at"), to see where the smoke's time limit goes.
    phase_at = report["phase_at"] = {}

    # 1. Build.
    t0 = time.perf_counter()
    built = _build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {sorted(built)} in {build_s:.2f} s", flush=True)
    report["ptxas"] = {}
    for name, (_, log) in built.items():
        funcs = ptxas_summary(log)
        report["ptxas"][name] = funcs
        worst = max(funcs.values(), key=lambda f: f["registers"])
        spills = {f: v["spill_bytes"] for f, v in funcs.items()
                  if v["spill_bytes"]}
        print(f"  ptxas[{name}]: {len(funcs)} entry functions, at most "
              f"{worst['registers']} registers, spills "
              f"{spills if spills else 'none'}", flush=True)
        if name != "ring_sum":
            for f, v in funcs.items():
                print(f"    {f}: {v['registers']} registers, "
                      f"{v['spill_bytes']} B spilled", flush=True)
    report["build_s"] = build_s

    phase_at["2"] = time.perf_counter() - t_start
    # 2. The main path, with the warm-up step's kernel inputs captured.
    run, css0, states0 = rollout.build(
        n=N_AGENTS, n_scenarios=N_SCENARIOS, max_iter=20, inner_iters=20,
        device="cuda",
    )
    captured = []
    launch = admm_kernel.fused_solve_lanes

    def capture(*args, **kw):
        if not captured:
            captured.append(([None if a is None else a.clone() for a in args],
                             dict(kw)))
        return launch(*args, **kw)

    admm_kernel.fused_solve_lanes = capture
    try:
        css1, states1, iters1 = run(css0, states0, 1)
    finally:
        admm_kernel.fused_solve_lanes = launch
    torch.cuda.synchronize()
    first_step = (css1, states1, iters1)

    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    css, states, iters = run(css0, states0, TIMED_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = launch_counts()
    consensus_iters = int(iters.max(dim=1).values.sum())
    if launches["fused_solve"] <= 0:
        fail("the main path never launched the fused_solve kernel")
    if launches["fused_solve"] != consensus_iters:
        fail(f"fused_solve launches {launches['fused_solve']} != consensus "
             f"iterations run {consensus_iters}")
    if not captured:
        fail("no fused_solve call captured in the warm-up step")
    main_name = entry_name(*captured[0])
    check_body(launches, "fused_solve", main_name, "the main path")
    graph = run.mpc_step.substeps.graph
    if (graph.captures, graph.replays) != (1, 1 + TIMED_STEPS):
        fail(f"the main path's substeps: {graph.captures} captures and "
             f"{graph.replays} graph replays, expected 1 and "
             f"{1 + TIMED_STEPS}")
    for f in ("R", "w", "xl", "vl", "Rl", "wl"):
        if not bool(torch.isfinite(getattr(states, f)).all()):
            fail(f"non-finite state field {f} after the timed steps")
    if not bool(torch.isfinite(css.f).all()):
        fail("non-finite consensus forces after the timed steps")
    rate = N_SCENARIOS * TIMED_STEPS / elapsed
    it = iters.to(torch.float32)
    print(f"main path: {N_SCENARIOS}x{N_AGENTS} C-ADMM forest, "
          f"{TIMED_STEPS} MPC steps in {elapsed:.4f} s = {rate:.2f} "
          f"scenario-MPC-steps/s | consensus iters/step mean "
          f"{float(it.mean()):.3f} max {int(iters.max())} | launches "
          f"{launches} = consensus iterations run {consensus_iters}, all "
          f"{main_name} | substeps from the CUDA graph ({graph.replays} "
          f"replays) | {card}", flush=True)
    report["main_path"] = {
        "scenario_mpc_steps_per_s": rate, "seconds": elapsed,
        "timed_steps": TIMED_STEPS, "iters_mean": float(it.mean()),
        "iters_max": int(iters.max()),
        "iters_per_step_max": iters.max(dim=1).values.tolist(),
        "launches": launches,
    }

    phase_at["3"] = time.perf_counter() - t_start
    # 3. Kernel against its plain version on the main path's inputs.
    args, kw = captured[0]
    nv, n_box, soc = kw["nv"], kw["n_box"], tuple(kw["soc_dims"])
    m = args[8].shape[-1]
    unpadded_args, unpadded_kw = None, None
    run_u, css_u, states_u = rollout.build(
        n=N_AGENTS, n_scenarios=125, max_iter=20, inner_iters=20,
        pad_operators=False, device="cuda",
    )
    captured.clear()
    admm_kernel.fused_solve_lanes = capture
    try:
        run_u(css_u, states_u, 1)
    finally:
        admm_kernel.fused_solve_lanes = launch
    unpadded_args, unpadded_kw = captured[0]

    def lanes(a, B):
        return [None if t is None else t[:B].contiguous() for t in a]

    cases = [
        ("headline", args, kw),
        ("headline_no_shift", args[:11] + [None], kw),
        ("ragged_B1000", lanes(args, 1000), kw),
        ("unpadded", unpadded_args, unpadded_kw),
    ]
    names = ("x", "y", "z", "prim_res", "dual_res")
    checks = {}
    for case, a, k in cases:
        got = launch(*a, **k)
        ref = admm_kernel.fused_solve_lanes_reference(*a, **k)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for nm, g, r in zip(names, got, ref):
            err = float((g - r).abs().max())
            scale = max(1.0, float(r.abs().max()))
            errs[nm] = err
            ok = ok and err <= KERNEL_ATOL * scale and bool(
                torch.isfinite(g).all())
        B = a[0].shape[0]
        print(f"kernel check {case}: B={B} nv={k['nv']} m={a[8].shape[-1]} "
              f"n_box={k['n_box']} soc={tuple(k['soc_dims'])} "
              f"iters={k['iters']} shift={a[11] is not None} max|err| "
              + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
              + f" (atol {KERNEL_ATOL} x max(1, |ref|)) "
              + ("ok" if ok else "FAIL"), flush=True)
        checks[case] = {"B": B, "max_abs_err": errs, "ok": ok}
        if not ok:
            fail(f"kernel disagrees with its plain version on {case}")
    report["kernel_checks"] = checks

    B = args[0].shape[0]
    iters_k = kw["iters"]
    bytes_ = B * admm_kernel.fused_solve_bytes_per_lane(nv, m, n_box)
    flops = B * admm_kernel.fused_solve_flops_per_lane(nv, m, iters_k, soc)
    t_bytes = bytes_ / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    main_timing = kernel_timing("the headline", args, kw, bound_ms, card)
    kernel_ms = main_timing["ms"]
    # Where the headline solve's time goes: staging and the exit residuals
    # (0 iterations) against the iterations, with one lane an SM (a lane's
    # own latency) and with the whole batch.
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    split = {}
    for B_s in (n_sm, B):
        a_s = lanes(args, B_s)
        for it in (0, iters_k):
            split[(B_s, it)] = cuda_ms(
                lambda: launch(*a_s, **dict(kw, iters=it)), 100)
    per_it = {B_s: (split[B_s, iters_k] - split[B_s, 0]) / iters_k * 1e3
              for B_s in (n_sm, B)}
    print(f"{main_name} split (the headline's inputs, CUDA graphs): 0 and "
          f"{iters_k} iterations at {n_sm} lanes (one an SM) "
          f"{split[n_sm, 0]:.4f} and {split[n_sm, iters_k]:.4f} ms, at {B} "
          f"lanes {split[B, 0]:.4f} and {split[B, iters_k]:.4f} ms: staging "
          f"and exit residuals {split[B, 0]:.4f} ms, {per_it[B]:.3f} us an "
          f"iteration ({per_it[n_sm]:.3f} us for a lane alone) | {card}",
          flush=True)
    main_timing["split_ms"] = {f"B{b}_iters{i}": v
                               for (b, i), v in split.items()}
    plain_ms = cuda_ms(
        lambda: admm_kernel.fused_solve_lanes_reference(*args, **kw), 5)
    print(f"fused_solve timing (B={B}, d={nv + m}, iters={iters_k}): kernel "
          f"{kernel_ms:.4f} ms/launch, plain PyTorch {plain_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms by {bound_by} ({bytes_ / 1e6:.2f} MB / "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s = {t_bytes:.4f} ms; "
          f"{flops / 1e6:.1f} MFLOP / {PEAK_F32_FLOP_S / 1e12:.0f} TFLOP/s = "
          f"{t_ops:.4f} ms); no single PyTorch call computes this function "
          f"| {card}", flush=True)
    report["fused_solve"] = {
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "bytes": bytes_, "flops": flops,
        "timing": main_timing,
    }

    phase_at["4"] = time.perf_counter() - t_start
    # 4. Where one MPC step's time goes.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(css0, states0, 1)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    phases = phase_breakdown(prof)
    in_path_us = per_launch_us(prof, main_name)
    in_trace = own_in_trace(prof)
    dev_total = phases["kernels_us"] or sum(phases["device_us"].values())
    print(f"profile of one MPC step: wall {step_s * 1e3:.2f} ms (profiler "
          f"on), device busy {dev_total / 1e3:.2f} ms = "
          f"{100 * dev_total / 1e3 / (step_s * 1e3):.1f}% | {card}",
          flush=True)
    for ph in sorted(phases["device_us"],
                     key=lambda p: -phases["device_us"][p]):
        print(f"  tat.{ph}: device {phases['device_us'][ph] / 1e3:.3f} ms, "
              f"host {phases['host_us'].get(ph, 0.0) / 1e3:.3f} ms")
    print(f"  {main_name} in the main path: "
          + ("not found in the trace" if in_path_us is None
             else f"{in_path_us / 1e3:.4f} ms/launch")
          + f"; the port's kernels in the trace by name: {in_trace}",
          flush=True)
    if in_trace and set(in_trace) != {main_name}:
        fail(f"the main path's trace shows {in_trace}, not {main_name} alone")
    report["profile"] = {"wall_ms": step_s * 1e3, "phases": phases,
                         "kernel_us_per_launch": in_path_us,
                         "kernels_in_trace": in_trace}

    phase_at["5"] = time.perf_counter() - t_start
    # 5. The card's first step against the CPU's plain path, 8 scenarios.
    n_cpu = 8
    step_cpu, cs0_cpu, _ = rollout.make_mpc_step(
        "cadmm", N_AGENTS, max_iter=20, inner_iters=20, pad_operators=True,
        device="cpu",
    )
    to_cpu = lambda t: t[:n_cpu].cpu()  # noqa: E731
    st_cpu = type(states0)(**{k: to_cpu(v) for k, v in
                              vars(states0).items()})
    css_cpu = rollout.stack_scenarios(cs0_cpu, n_cpu)
    css_c, st_c, stats_c = step_cpu(css_cpu, st_cpu)
    css_g, st_g, it_g = first_step
    it_cpu = stats_c.iters.numpy()
    it_card = it_g[0, :n_cpu].cpu().numpy()
    errs = {f: float((getattr(st_c, f) - to_cpu(getattr(st_g, f))).abs().max())
            for f in ("R", "w", "xl", "vl", "Rl", "wl")}
    f_err = float((css_c.f - to_cpu(css_g.f)).abs().max())
    same_iters = int((it_cpu == it_card).sum())
    ok = max(errs.values()) <= CPU_STATE_ATOL and f_err <= CPU_FORCE_ATOL
    print(f"card vs CPU, first MPC step of {n_cpu} scenarios: max|state err| "
          + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" (atol {CPU_STATE_ATOL}), max|force err| {f_err:.2e} N (atol "
          f"{CPU_FORCE_ATOL}), consensus iterations equal in {same_iters}/"
          f"{n_cpu} (card {it_card.tolist()}, CPU {it_cpu.tolist()}) "
          + ("ok" if ok else "FAIL"), flush=True)
    report["card_vs_cpu"] = {"state_err": errs, "force_err": f_err,
                             "iters_card": it_card.tolist(),
                             "iters_cpu": it_cpu.tolist(), "ok": ok}
    if not ok:
        fail("the card's first step disagrees with the CPU plain path")

    phase_at["6"] = time.perf_counter() - t_start
    # 6. The adaptive headline: the same rollout with effort="adaptive",
    # through the whole-solve kernel's early-exit form.
    step_fx, _, _ = rollout.make_mpc_step(
        "cadmm", N_AGENTS, max_iter=20, inner_iters=20, effort="fixed",
        device="cuda")
    fixed_first = step_fx(css0, states0)
    step_ad, _, _ = rollout.make_mpc_step(
        "cadmm", N_AGENTS, max_iter=20, inner_iters=20, effort="adaptive",
        device="cuda")
    early_args = []
    with capturing(admm_kernel, "fused_solve_lanes", early_args,
                  when=lambda kw: kw.get("check_every", 0) > 0):
        adaptive_first = step_ad(css0, states0)
    torch.cuda.synchronize()
    quality = first_step_quality(fixed_first, adaptive_first)
    print(f"adaptive vs fixed effort, first MPC step of {N_SCENARIOS} "
          f"scenarios: final consensus residual max "
          f"{quality['fixed_res_max']:.3e} (fixed) "
          f"{quality['adaptive_res_max']:.3e} (adaptive); "
          f"{quality['scenarios_under_bar_fixed']} scenarios under "
          f"{EFFORT_BAR} N with fixed effort, {quality['lost_the_bar']} of "
          f"them not with adaptive; applied forces max|diff| "
          f"{quality['force_err']:.3e} N (bar {EFFORT_BAR}) "
          + ("ok" if quality["ok"] else "FAIL"), flush=True)
    if not quality["ok"]:
        fail("adaptive effort misses the fixed arm's quality bar")
    css_a, states_a, iters_a, inner_a, secs_a, launches_a, _ = timed_steps(
        step_ad, css0, states0, TIMED_STEPS)
    runs_a = int(iters_a.max(dim=1).values.sum())
    check_launches(launches_a, "fused_solve_early", runs_a,
                   "the adaptive headline")
    if not early_args or not early_args[0][1].get("check_every"):
        fail("no early-exit call captured in the adaptive warm-up step")
    early_name = entry_name(*early_args[0])
    check_body(launches_a, "fused_solve_early", early_name,
               "the adaptive headline")
    check_states(css_a, states_a, "the adaptive headline")
    if inner_a is None or not bool((inner_a.sum(dim=1) > 0).all()):
        fail("the adaptive headline reported no inner iterations")
    if bool((inner_a < 0).any()) or bool(
            (inner_a > N_AGENTS * 20 * iters_a).any()):
        fail("inner iterations outside [0, n x inner_iters x iterations]")
    rate_a = N_SCENARIOS * TIMED_STEPS / secs_a
    it_a = iters_a.to(torch.float32)
    # The fixed arm runs every lane of the batch for the full inner budget
    # in every consensus iteration it runs.
    fixed_work = N_SCENARIOS * N_AGENTS * 20 * runs_a
    inner_per_step = float(inner_a.sum()) / TIMED_STEPS
    print(f"adaptive headline: {N_SCENARIOS}x{N_AGENTS} C-ADMM forest, "
          f"effort adaptive, {TIMED_STEPS} MPC steps in {secs_a:.4f} s = "
          f"{rate_a:.2f} scenario-MPC-steps/s | consensus iters/step mean "
          f"{float(it_a.mean()):.3f} max {int(iters_a.max())} | inner "
          f"iterations/step {inner_per_step:.1f} (summed over scenarios and "
          f"agents; the fixed arm's kernel runs {fixed_work / TIMED_STEPS:.1f}"
          f" lane-iterations/step for the same consensus iterations) | "
          f"launches {launches_a} = consensus iterations run {runs_a} | "
          f"{card}", flush=True)
    # The same comparison in turns (fixed, adaptive, adaptive, fixed), so
    # a drift of the shared host's speed does not read as a difference.
    secs_a2 = timed_steps(step_ad, css0, states0, TIMED_STEPS)[4]
    secs_f2 = timed_steps(step_fx, css0, states0, TIMED_STEPS)[4]
    turns = {"fixed": [N_SCENARIOS * TIMED_STEPS / elapsed,
                       N_SCENARIOS * TIMED_STEPS / secs_f2],
             "adaptive": [rate_a, N_SCENARIOS * TIMED_STEPS / secs_a2]}
    print(f"fixed vs adaptive effort in turns (fixed, adaptive, adaptive, "
          f"fixed): fixed {turns['fixed'][0]:.2f} and {turns['fixed'][1]:.2f}"
          f", adaptive {turns['adaptive'][0]:.2f} and "
          f"{turns['adaptive'][1]:.2f} scenario-MPC-steps/s | {card}",
          flush=True)
    report["adaptive_path"] = {
        "scenario_mpc_steps_per_s": rate_a, "seconds": secs_a,
        "rates_in_turns": turns,
        "iters_mean": float(it_a.mean()), "iters_max": int(iters_a.max()),
        "inner_iters_per_step": inner_per_step,
        "fixed_lane_iterations_per_step": fixed_work / TIMED_STEPS,
        "launches": launches_a, "first_step_quality": quality,
    }
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_ad(css0, states0)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    phases_a = phase_breakdown(prof)
    dev_total = phases_a["kernels_us"]
    print(f"profile of one adaptive MPC step: wall {step_s * 1e3:.2f} ms "
          f"(profiler on), device busy {dev_total / 1e3:.2f} ms = "
          f"{100 * dev_total / 1e3 / (step_s * 1e3):.1f}% | {card}",
          flush=True)
    for ph in sorted(phases_a["device_us"],
                     key=lambda p: -phases_a["device_us"][p]):
        print(f"  tat.{ph}: device {phases_a['device_us'][ph] / 1e3:.3f} ms,"
              f" host {phases_a['host_us'].get(ph, 0.0) / 1e3:.3f} ms")
    early_us = per_launch_us(prof, early_name)
    in_trace = own_in_trace(prof)
    print(f"  {early_name} in the adaptive path: "
          + ("not found in the trace" if early_us is None
             else f"{early_us / 1e3:.4f} ms/launch")
          + f"; the port's kernels in the trace by name: {in_trace}",
          flush=True)
    if in_trace and set(in_trace) != {early_name}:
        fail(f"the adaptive trace shows {in_trace}, not {early_name} alone")
    report["adaptive_path"]["profile"] = {
        "wall_ms": step_s * 1e3, "phases": phases_a,
        "kernel_us_per_launch": early_us, "kernels_in_trace": in_trace}

    phase_at["7"] = time.perf_counter() - t_start
    # 7. DD at 256 x 8, adaptive effort (its warm-up step gives phase 8
    # DD's d = 56 inputs).
    step_dd, cs0_dd, _ = rollout.make_mpc_step(
        "dd", N_AGENTS, max_iter=20, effort="adaptive", device="cuda")
    css0_dd = rollout.stack_scenarios(cs0_dd, N_SCENARIOS)
    dd_args = []
    with capturing(admm_kernel, "fused_solve_lanes", dd_args,
                  when=lambda kw: kw.get("check_every", 0) > 0):
        dd_first = step_dd(css0_dd, states0)
    torch.cuda.synchronize()
    css_d, states_d, iters_d, inner_d, secs_d, launches_d, _ = timed_steps(
        step_dd, css0_dd, states0, TIMED_STEPS)
    runs_d = int(iters_d.max(dim=1).values.sum())
    check_launches(launches_d, "fused_solve_early", runs_d, "DD")
    if not dd_args:
        fail("no early-exit call captured in DD's warm-up step")
    check_body(launches_d, "fused_solve_early", entry_name(*dd_args[0]), "DD")
    check_states(css_d, states_d, "DD")
    rate_d = N_SCENARIOS * TIMED_STEPS / secs_d
    it_d = iters_d.to(torch.float32)
    print(f"DD: {N_SCENARIOS}x{N_AGENTS} forest, effort adaptive (gate "
          f"only), inner_iters 40, {TIMED_STEPS} MPC steps in {secs_d:.4f} "
          f"s = {rate_d:.2f} scenario-MPC-steps/s | dual-ascent iters/step "
          f"mean {float(it_d.mean()):.3f} max {int(iters_d.max())} | inner "
          f"iterations/step {float(inner_d.sum()) / TIMED_STEPS:.1f} | "
          f"launches {launches_d} = iterations run {runs_d} | {card}",
          flush=True)
    step_dd_cpu, cs0_dd_cpu, _ = rollout.make_mpc_step(
        "dd", N_AGENTS, max_iter=20, effort="adaptive", pad_operators=True,
        device="cpu")
    css_c, st_c, stats_c = step_dd_cpu(
        rollout.stack_scenarios(cs0_dd_cpu, n_cpu), st_cpu)
    errs = {f: float((getattr(st_c, f)
                      - to_cpu(getattr(dd_first[1], f))).abs().max())
            for f in ("R", "w", "xl", "vl", "Rl", "wl")}
    f_err = float((css_c.f - to_cpu(dd_first[0].f)).abs().max())
    it_card = dd_first[2].iters[:n_cpu].cpu().tolist()
    it_cpu = stats_c.iters.tolist()
    ok = max(errs.values()) <= CPU_STATE_ATOL and f_err <= CPU_FORCE_ATOL
    print(f"DD card vs CPU, first MPC step of {n_cpu} scenarios: max|state "
          f"err| " + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" (atol {CPU_STATE_ATOL}), max|force err| {f_err:.2e} N (atol "
          f"{CPU_FORCE_ATOL}), iterations card {it_card} CPU {it_cpu} "
          + ("ok" if ok else "FAIL"), flush=True)
    if not ok:
        fail("DD's first step on the card disagrees with the CPU plain path")
    report["dd_path"] = {
        "scenario_mpc_steps_per_s": rate_d, "seconds": secs_d,
        "iters_mean": float(it_d.mean()), "iters_max": int(iters_d.max()),
        "inner_iters_per_step": float(inner_d.sum()) / TIMED_STEPS,
        "launches": launches_d,
        "card_vs_cpu": {"state_err": errs, "force_err": f_err,
                        "iters_card": it_card, "iters_cpu": it_cpu},
    }

    phase_at["8"] = time.perf_counter() - t_start
    # 8. The early-exit kernel against its plain version, on inputs
    # captured from the adaptive main path (its first consensus iteration)
    # and DD's.
    if not early_args or not dd_args:
        fail("no early-exit call captured in the warm-up steps")
    e_args, e_kw = early_args[0]
    B_e = e_args[0].shape[0]
    half = torch.arange(B_e, device=e_args[0].device) % 2 == 0
    cases = [
        ("adaptive_headline", e_args, e_kw),
        ("ungated", e_args[:12] + [None], e_kw),
        ("half_gated", e_args[:12] + [half], e_kw),
        ("ragged_B1000", lanes(e_args[:12] + [half], 1000), e_kw),
        ("remainder_25_of_10", e_args, dict(e_kw, iters=25)),
        ("dd_d56", dd_args[0][0], dd_args[0][1]),
    ]
    e_checks, e_err = check_early_exit(cases, card)
    report["early_exit_checks"] = e_checks
    got = admm_kernel.fused_solve_lanes(*e_args, **e_kw)
    e_bytes, e_flops = early_exit_bound(e_args, e_kw, got[5])
    e_bound, e_by = bound(e_bytes, e_flops)
    e_timing = kernel_timing("the adaptive headline's first consensus "
                             "iteration", e_args, e_kw, e_bound, card)
    e_ms = e_timing["ms"]
    d_args, d_kw = dd_args[0]
    d_eff = admm_kernel.fused_solve_lanes(*d_args, **d_kw)[5]
    dd_timing = kernel_timing(
        "DD's first dual-ascent iteration", d_args, d_kw,
        bound(*early_exit_bound(d_args, d_kw, d_eff))[0], card)
    e_plain = event_ms(
        lambda: admm_kernel.fused_solve_lanes_reference(*e_args, **e_kw), 5)
    print(f"fused_solve early-exit timing (the adaptive headline's first "
          f"consensus iteration: B={B_e}, d={e_kw['nv'] + e_args[8].shape[-1]}"
          f", iters={e_kw['iters']}, check_every={e_kw['check_every']}, "
          f"tol={e_kw['tol']}, mean eff {float(got[5].float().mean()):.2f}): "
          f"kernel {e_ms:.4f} ms/launch (CUDA graph), plain PyTorch "
          f"{e_plain:.4f} ms (host-driven: it synchronises once a chunk), "
          f"bound {e_bound:.4f} ms by {e_by} ({e_bytes / 1e6:.2f} MB, "
          f"{e_flops / 1e6:.1f} MFLOP) | {card}", flush=True)
    report["fused_solve_early"] = {
        "kernel_ms": e_ms, "plain_ms": e_plain, "bound_ms": e_bound,
        "bound_by": e_by, "bytes": e_bytes, "flops": e_flops,
        "timing": e_timing, "dd_timing": dd_timing,
    }

    phase_at["9"] = time.perf_counter() - t_start
    # 9. The chunk kernel: the chunked route, fixed and adaptive, and the
    # full QP's; both bodies against their plain version and timed.
    chunk_rows = chunk_phases(card, report, css0, states0, dd_args, lanes)

    phase_at["10"] = time.perf_counter() - t_start
    # 10-12. bf16 storage; 13. the entry step and the centralized
    # controller; 14. C-ADMM's full QP, rho schedule and two-phase budget.
    bf16_rows = bf16_phases(card, report, lanes)
    phase_at["13"] = time.perf_counter() - t_start
    central_rows = centralized_phases(card, report)
    phase_at["14"] = time.perf_counter() - t_start
    option_launches = cadmm_option_phases(card, report)
    phase_at["15"] = time.perf_counter() - t_start
    # 15-19. The agent-sharded paths and the ring-sum kernel.
    ring_row = sharded_phases(card, report)
    phase_at["20"] = time.perf_counter() - t_start
    # 20. The centralized controller at n = 16 and 64: route "scan".
    centralized_scan_phase(card, report)
    phase_at["21"] = time.perf_counter() - t_start
    # 21-24. The CUDA-graph substeps, the logged rollout, the bucketing A/B
    # and the padded tier.
    graph_phase(card, report, run, css0, states0)
    phase_at["22"] = time.perf_counter() - t_start
    logged_rollout_phase(card, report)
    phase_at["23"] = time.perf_counter() - t_start
    bucketing_phase(card, report, run, css0, states0)
    phase_at["24"] = time.perf_counter() - t_start
    padded_phase(card, report, unpadded_args, unpadded_kw)
    # 25-28. The environment-query A/B, the city world on the main path,
    # the SM law and jit_control_step.
    phase_at["25"] = time.perf_counter() - t_start
    env_query_phase(card, report)
    phase_at["26"] = time.perf_counter() - t_start
    city_phase(card, report)
    phase_at["27"] = time.perf_counter() - t_start
    sm_phase(card, report, run, css0, states0)
    phase_at["28"] = time.perf_counter() - t_start
    control_step_phase(card, report)
    # 29-32. The resilience tier: the resilient headline, DD with a lost
    # agent, the run-health telemetry and sharded health.
    phase_at["29"] = time.perf_counter() - t_start
    sched_c, res_logs = resilient_phase(card, report)
    phase_at["30"] = time.perf_counter() - t_start
    dd_fault_phase(card, report)
    phase_at["31"] = time.perf_counter() - t_start
    telemetry_phase(card, report)
    phase_at["32"] = time.perf_counter() - t_start
    sharded_fault_phase(card, report, sched_c, res_logs)
    # 33. Chunked rollouts and crash recovery.
    phase_at["33"] = time.perf_counter() - t_start
    recovery_phase(card, report)

    kernels = [
        solve_row(main_timing, launches["fused_solve"],
                  max(max(c["max_abs_err"].values())
                      for c in checks.values()), plain_ms, bound_by),
        solve_row(e_timing, launches_a["fused_solve_early"], e_err, e_plain,
                  e_by),
    ] + bf16_rows + central_rows + chunk_rows + [ring_row]
    report["kernels"] = kernels
    report["launches_elsewhere"] = {
        "fused_solve_cadmm_options": option_launches,
    }
    path = os.environ.get("TAT_SMOKE_REPORT") or os.path.join(
        HERE, "build", "chip_smoke.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    total_s = time.perf_counter() - t_start
    report["total_s"] = total_s
    with open(path, "w") as f:
        json.dump(report, f, indent=1, default=str)
    print(f"total: {total_s:.1f} s, the build included; phases began at "
          + ", ".join(f"{k}: {v:.1f} s" for k, v in phase_at.items())
          + f" | {card}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
