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
   fixed headline with the graph on and off in turns (phase 43 profiles
   both); the entry's periods/s with and without the graph;
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
   ``jit_resilient_rollout`` with the same kernel launches (each run
   counted from zero), preempted and resumed in-process with the
   NaN scenario's quarantine flag in the carry; the journal's events and
   the metrics file checked;
34. the RP model at 256 scenarios x 8 agents (``rp_setup(8)``) through the
   whole-solve kernel's shared-memory body at d = 111, in the JAX package's
   closed-loop circle test's loop (one control step and ten 1 kHz
   ``rp.integrate`` substeps a period; each scenario's start velocities
   and reference phase from numpy seed 0): (a) the centralized controller,
   one warm-up and ``TIMED_STEPS`` timed periods, one ``fused_solve_kernel``
   launch a period, the substeps replayed from a CUDA graph bitwise the
   eager ones; (b) C-ADMM (``max_iter=20``, ``inner_iters=20``) likewise,
   one launch a consensus iteration run, its mean and max iterations and
   ``ok_frac``; (c) ``rp_cadmm_control_sharded`` over 8 shards against the
   single program, 3 periods (forces 2e-4 N, iterations +-1); (d) n = 9 on
   one scenario, 3 periods, route "scan" and no launch; (e) the first 8
   scenarios of (a) and (b) on the CPU plain path for 3 periods, each from
   the card's state at its start: the control step against the card's
   (forces 1e-2 N, iterations equal) and the physics from the card's
   forces against the card's next state (1e-4); (f) the kernel against its plain version on (a)'s and (b)'s
   inputs at the kernel bar, timed beside its bound;
35. the PMRL model at 256 x 8 (``pmrl_setup(8)``) in the JAX setpoint
   test's loop (dt 1e-2; seeded setpoints): one warm-up and ``TIMED_STEPS``
   timed steps, one ``fused_solve_early_kernel`` launch a step (d = 111),
   ``pmrl.integrate`` under ``torch.cuda.set_sync_debug_mode("error")``;
   the first 8 scenarios on the CPU for 3 steps, as in 34(e) (states 1e-4,
   forces 1e-2 N; the early-exit counts reported, with every lane that stopped early
   within tol on both sides: float32 rounding decides the stop of these
   solves); the early-exit kernel against its plain version (outputs at
   the kernel bar on the lanes whose counts agree, counts apart on no more
   lanes than ``flip_bar`` allows) and its fixed form at the kernel bar,
   timed beside its bound;
36. the differentiable simulation (``harness/diff.py``) at n = 8 from the
   grad-tuning example's tilted start (``k_att=1``), launching no kernel:
   (a) ``make_rollout_loss``'s value and gradient on the card against the
   CPU port from the same inputs (value rtol 1e-5, gradients rtol 1e-3);
   (b) ``remat=True`` against ``False`` in turns: equal within
   ``tests/test_diff.py``'s bars, each arm's peak memory and ms per value
   and gradient; (c) ``tune_gains`` (SGD, detuned start) replayed from its
   CUDA graph against ``graph=False``, in turns: histories and best gains
   bitwise equal, gradient evaluations/s, captures and replays; (d) the
   example through its ``main`` on the card: the tuned loss below 0.98 x
   the detuned; (e) system identification from a recording (the JAX
   test's, cut to ``DIFF_SYSID_STEPS``), 40% heavy start: the mass within
   2%; (f) trajectory optimisation with Adam: the loss below its start,
   its first 3 history values against the CPU port's (rtol 1e-4); (g)
   every launch counter at 0.
37. the serving tier (``serving/``, ``resilience/backend.py``) on the card,
   three families: ``cadmm4`` and ``centralized4`` (the canonical ones) and
   ``cadmm8`` (C-ADMM at the headline's n = 8, ``FamilySpec``'s other
   defaults); buckets (64, 128, 256), so the largest batch is the main
   path's 256 scenarios: (a) after one warm-up batch of every (family,
   bucket), SERVE_REQUESTS seeded requests (horizons 2-16 high-level steps
   on the chunk grid) on a Poisson clock, every counter zeroed just before:
   all completed, every chunk on the card's rung with zero guard
   fallbacks, the warp body (C-ADMM) and the block body (centralized)
   launched from the server's own dispatch, the kernel on the inputs
   captured from one served chunk of each family against its plain
   version at the kernel bar, 8 sampled requests against the same
   requests served on the CPU (states 1e-4); requests/s, admit->complete
   p50/p99, chunk dispatch and harvest ms by bucket; (b) a request of each
   family served alone (bucket 64), in a full batch (256) and late-joined
   at a boundary: bitwise (or within 1e-6 with equal consensus counts,
   reported); (c) host and device lane surgery, sync and pipelined
   dispatch: every result bitwise, surgery ms; one ``pump()`` of three full
   batches profiled (the device's busy share); (d) both serving examples
   with ``--run-dir`` preempted by their own SIGTERM in a child (this
   script with ``--serving-child preempt``) and resumed in a second
   (``resume``): every per-request and per-step digest the uninterrupted
   runs'; (e) ``TAT_BACKEND_FAULTS=crash@3`` for one server run: exactly
   its third guarded chunk fails, with one journaled ``backend_event``,
   its batch's requests ``failed`` (reason ``device_crash``, journaled),
   nothing run on the CPU, every other chunk on the card and every other
   result bitwise a clean card run, the failed requests resubmitted and
   served bitwise a clean run too; a real
   ``torch.OutOfMemoryError`` classified ``oom`` with the card usable
   after; ``probe_subprocess`` on the card; (f) 256 concurrent ``cadmm4``
   sessions x 10 control steps: every served control bitwise the family's
   chunk run offline on the same post-delta states, no degraded step; one
   session's 1 us step deadline degrades that step to hold-last, counted,
   its state and next step unforked. The smoke refuses to start with
   ``TAT_BACKEND_FAULTS`` set.
38. the user's drivers (``tpu_aerial_transport_torch/examples``), one
   scenario each, in a child process (this script with
   ``--driver-child``) that runs them through their ``main`` on the card,
   every launch counter zeroed before each and read after: (a)
   ``rqp_forest`` with C-ADMM and DD at n = 8 and the centralized
   controller at n = 3 for ``DRIVER_T`` s, C-ADMM with its timing pass
   (and ``--plots`` where matplotlib is installed; where it is not, the
   flag refused before any rollout): the warp body (C-ADMM, DD) and the
   block body's early form (centralized) launched, the first
   ``DRIVER_CPU_STEPS`` steps of each log against the same driver run on
   the CPU in this process (states 1e-4, forces 1e-2 N, iteration counts
   equal); (b) its chunked run as a user starts it (``python -m``),
   SIGTERMed by this script once ``DRIVER_SIGTERM_AFTER`` chunks are
   journaled, then ``--resume`` in a fresh process: the log bitwise the
   uninterrupted chunked run's by sha256; (c) ``fault_injection``'s three
   scenarios at n = 8: the killed agent's forces exactly 0 from its
   failure step, the dropout masks bitwise the CPU's, and its
   checkpointed run preempted and resumed likewise, every snapshot leaf
   bitwise the uninterrupted run's; (d) ``city_forest`` at 16384 trees:
   "bucketed" resolved and printed, the telemetry counts equal to a
   recount from the logs, the grid record and the rate; (e)
   ``convergence_rates`` (100 samples, 25 iterations) and its effort A/B:
   every sample's residual curve within ``CONV_BAR`` of the CPU's; (f)
   ``replay`` on (a)'s C-ADMM log: its layout, the forest rebuilt bitwise,
   and the frames, the ghost snapshot and the figures where matplotlib is
   installed (where it is not, replay refuses up front, and the figures
   are left to the CPU tests); (g) ``serve_sessions`` with the live hub
   and the SLO pass: the hub's counters equal to a recount from the
   journal and a nominal storm firing no alert.
39. the serving fleet (``serving/fleet.py`` and the harness
   ``tpu_aerial_transport_torch/tools/fleet_local.py``): ``run_fleet`` with
   ``FLEET_REPLICAS`` replica processes on the card (each its own CUDA
   context, the kernels built once before they start), the canonical
   families and the ``serve_fleet`` example's tenants, ``FLEET_REQUESTS``
   requests submitted once every replica has built its server; first
   fault-free, then under ``FLEET_CHAOS`` (r1 SIGKILLed, r0 wedged for 2
   s, both after every replica booted): every request resolved exactly
   once, every completed result from a replica on ``cuda`` and every
   digest the fault-free run's, the killed replica's requests failed over
   on their original trace ids with a retry segment on the timeline of
   the replica that served them, the killed replica respawned, resumed
   and exited cleanly, zero guard fallbacks and failed chunks in every
   replica, the warp and block bodies launched (the replicas' own
   counts, from their heartbeats); ``FLEET_CPU_SAMPLES`` completed
   requests served again on the card in this process (their digests the
   fleet's) and on the CPU (states within 1e-4); replica boot seconds,
   requests/s and the failover's latencies.

40. scenario sharding across processes (``parallel/pods.py``, the
   scenario tier of ``parallel/mesh.py`` and the harness
   ``tpu_aerial_transport_torch/tools/pods_local.py``) at the headline's
   width: C-ADMM, n = 8, 256 scenarios, ``max_iter=20``,
   ``inner_iters=20``, ``consensus_impl="pallas_ring"``: (a) 2 worker
   processes on the card, each a 128-scenario slab of one 2x2 mesh (2
   scenario shards, 2 agent shards; one gloo group), ``PODS_STEPS`` steps
   and the alive-masked step, against 1 process of the same mesh: every
   digest leaf within 2e-3, the residuals equal exactly, and each worker
   launching ``warp_solve_kernel`` and ``ring_sum``; (b) the masked step's
   first ``PODS_CPU`` scenarios against the CPU (forces 1e-2 N, consensus
   counts equal); (c) the chunked run of ``PODS_RESUME_STEPS`` steps in 4
   chunks on 2 processes, preempted at boundary 1 and resumed with
   ``--trace``: each process's final slab bitwise the uninterrupted run's
   by per-leaf sha256, the stitched trace on tracks ``p0of2`` and
   ``p1of2``; (d) scenario-MPC-steps/s of 2 processes x 128 and 1 x 256
   in turns (2, 1, 1, 2), each worker's boot seconds and the spawn to
   result wall time; (e) ``ScenarioServer(mesh=)`` on a 1-process 2x2
   mesh serving ``PODS_SERVE_REQUESTS`` requests bitwise the meshless
   server on the card.

41. bundled serving (``tpu_aerial_transport_torch/aot``, the entry-point
   registry ``analysis/contracts.py``, ``tools/aot_bundle.py`` and
   ``ScenarioServer(bundle=, require_bundle=)``): (a) a bundle of the
   probe and the four serving entries at ``BUNDLE_BUCKETS``, built on the
   card, carrying the three kernel libraries under the live sources'
   digests (the chunks' variants record ``fused_solve``, the probe's
   ``ring_sum``); (b) a fresh process with an empty kernel build
   directory serves ``BUNDLE_REQUESTS`` requests of the serving example's
   seeded stream (``serve_scenarios --bundle --require-bundle
   --expect-zero-compile``): exit 0, no ``nvcc`` build, every
   ``aot_serve`` rung ``bundle_exec``, ``warp_solve_kernel`` (C-ADMM) and
   ``fused_solve_early_kernel`` (centralized) launched from the installed
   library (the bundle installs all three libraries before its first
   call), every result digest the same stream's served eagerly in this
   process, ``BUNDLE_CPU_SAMPLES`` results within 1e-4 of the CPU; (c)
   ``probe_subprocess(bundle_dir=)`` with an empty build directory:
   ``BACKEND_OK`` with note ``bundle``, one ``ring_sum`` launch equal to
   ``x.sum(0)``, no ``nvcc``; (d) a copy whose fingerprint names another
   torch serves on ``eager_cached`` with ``tried`` holding
   ``bundle[bundle_stale]``, and refuses under ``require_bundle`` with the
   rebuild hint; (e) the time to the first served chunk in a fresh process
   (``tools.aot_bundle serve``), each rung once: ``bundle_exec`` with an
   empty build directory, ``eager_cold`` (a new build directory: the
   process runs ``nvcc``) and ``eager_cached``, the first chunk's CUDA
   graph capture timed apart.

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

The children of phases 33, 37 and 38 print one ``recovery-child``,
``serving-child`` or ``driver-child`` record each and never the result
line. Phase 39's replica processes and phase 40's workers print nothing
to stdout; phase 41's children print their tools' JSON lines.

42. the float64 oracle and the static analysis
   (``tpu_aerial_transport_torch/native``, ``analysis/``): (a) build the
   oracle with ``g++`` and solve the headline's 2048 agent QPs (the first
   ``fused_solve_lanes`` call of phase 2's warm-up step, d = 48, warm
   starts included) in float64 at the kernel's iteration count; the
   kernel's fixed form within the kernel bar of the oracle (the oracle in
   place of the float64 plain version) and the float64 plain version
   within ``ORACLE_RTOL`` of it; the oracle's host seconds beside the
   kernel's ms; (b) ``analysis.contracts.run_contracts(device="cuda")``
   over every registry entry but ``parallel.pods:pods_control_step``
   (phase 40's), one line an entry with its host syncs (dispatch count,
   ``set_sync_debug_mode`` count, the dispatched and card-only budgets),
   rebuilds on the second call and launches; any finding fails; each row
   of the ``kernels`` line gains the phase's launches
   (``contract_launches``); (c) the lint's Tiers A and C
   over the port's tree (``tools/lint.py``, by file path) exit 0.
43. the operator's tools (``tpu_aerial_transport_torch/tools``) on the
   card: (a) ``TOOL_STEPS`` fixed-headline steps under ``torch.profiler``,
   with the CUDA graph off and on, each trace exported and read back by
   ``op_profile --by-phase``: the whole-solve kernel at 21 launches a step
   in the trace and the counters, ``local_solve`` and ``consensus`` among
   the phases, at least ``ATTRIBUTION_BAR`` of the graph-off device time
   in ``tat.*`` phases, and the tool's device time per phase within
   ``PHASE_AGREEMENT`` of ``phase_breakdown``'s on the graph-off capture;
   (b) ``profile_dd64`` at n = 64, batch 64, one rep, its differences
   finite and its kernels launched in every variant; (c) ``run_health
   --validate`` and its summary over the metrics files phases 33 and 37-41
   leave under ``build/`` (``TOOL_METRICS``), every row kind rendering its
   section, and ``trace_view --out`` of the pods run and the guarded
   server's spans, which ``--validate`` accepts with phase 40's trace; (d)
   ``probe_chip``: one logged probe, rc 0.

Output: timing lines carry the card's name and power limit; a ``kernels``
JSON line, the ``nvidia-smi`` name/power-limit line, and last
``{"ok": true, "device": {...}}``. The full report is written as JSON to
``build/chip_smoke.json``, or to the path in ``TAT_SMOKE_REPORT``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = "tpu_aerial_transport_torch"
# Each kernel's earlier time at the shapes timed here, from PERF.md's kernel
# table (NVIDIA H100 80GB HBM3, 700.00 W): the whole-solve kernel's
# one-block-a-lane body at the agent QPs, the cluster ring sum and the chunk
# kernel's one-block body at the headline; and, by (entry point, d, lanes),
# the shared-memory body's times before its K2 rows were summed in two
# chains (chip run 3 of PR 10).
EARLIER_MS = {"warp_solve_kernel": 0.0623, "warp_solve_early_kernel": 0.0656,
              "warp_solve_bf16_kernel": 0.0705,
              "warp_solve_early_bf16_kernel": 0.1598,
              "ring_sum_kernel": 0.0060, "admm_chunk_kernel": 0.0504,
              ("fused_solve_early_kernel", 67, 1): 0.0384,
              ("fused_solve_early_kernel", 67, 256): 0.1522,
              ("fused_solve_early_kernel", 79, 256): 0.1658,
              ("fused_solve_kernel", 72, 2048): 0.1704,
              ("fused_solve_bf16_kernel", 72, 2048): 0.2422,
              ("fused_solve_early_bf16_kernel", 72, 2048): 0.2730,
              ("admm_chunk_kernel", 72, 2048): 0.0989}

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
# Phases 34-35, the RP and PMRL models: the circle test's radius, angular
# rate, substep and substeps a period (tests/test_rp_cadmm.py:153-183), the
# setpoint test's step (tests/test_pmrl_centralized.py:70); periods of the
# CPU comparison, of the sharded comparison and at n = 9; the sharded
# step's bars, the JAX package's own (tests/test_rp_cadmm.py:125-131).
RP_RADIUS, RP_OMEGA, RP_DT, RP_SUBSTEPS, PMRL_DT = 0.5, 0.4, 1e-3, 10, 1e-2
RP_CPU_PERIODS, RP_SHARDED_PERIODS, RP_N9_PERIODS = 3, 3, 3
RP_SHARDED_FORCE_BAR, RP_SHARDED_ITERS_APART = 2e-4, 1
# Phase 36, the differentiable simulation (harness/diff.py) at the
# headline's width, n = 8, from the grad-tuning example's tilted start
# (k_att = 1, 10 substeps a step). Depth only is cut, to hold the phase
# near 60 s (an eager value and gradient costs about 0.3 s of host time
# an MPC step on the card, a graph capture two to three times that): MPC
# steps of (a) card against CPU and (b) the remat A/B (the example runs
# 40); (c) the graph-against-eager descent's steps and SGD iterations;
# (d) the example's steps (its 40; its 25 iterations kept); (e) the sysid
# recording's steps (the JAX test's 25) and iterations (its 40; the
# measured-curvature lr contracts the error about 0.82x an iteration, so
# 20 reach under 1%); (f) the trajopt horizon and Adam iterations (the
# JAX test's 60 and 200).
DIFF_N = 8
DIFF_CPU_STEPS, DIFF_REMAT_STEPS = 5, 5
DIFF_AB_STEPS, DIFF_AB_ITERS = 2, 3
DIFF_TUNE_STEPS, DIFF_TUNE_ITERS = 5, 25
DIFF_SYSID_STEPS, DIFF_SYSID_ITERS = 10, 20
DIFF_TRAJ_STEPS, DIFF_TRAJ_ITERS = 10, 10
# Card against CPU (value rtol; gradients rtol and atol), remat against no
# remat (tests/test_diff.py's value and gradient rtol), the tuned loss's
# bar against the detuned loss (tests/test_diff.py), the recovered mass's
# relative error, and the trajopt history's first values against the CPU
# port's (tests/test_torch_diff_tuning.py's descent bar).
DIFF_VALUE_RTOL, DIFF_GRAD_RTOL, DIFF_GRAD_ATOL = 1e-5, 1e-3, 1e-8
REMAT_VALUE_RTOL, REMAT_GRAD_RTOL = 1e-6, 1e-4
TUNED_BAR, SYSID_MASS_RTOL, TRAJ_HIST_RTOL = 0.98, 0.02, 1e-4
# Phase 37, the serving tier: (a) the stream's requests, buckets (the
# largest the main path's 256 scenarios), queue capacity, Poisson arrival
# rate (requests/s) and the requests held against the CPU; (c) the mode
# stream's requests; (d) the examples' preempted runs (requests; session
# clients and steps) and the pump rounds before each child's SIGTERM; (e)
# the guarded stream's requests; (f) concurrent sessions and their steps.
# Each example's SIGTERM lands mid-run: the scenario stream's batches hold
# every request from their launch (3 chunks at most), and the session
# storm serves a warm-up request and then one step a round.
SERVE_REQUESTS, SERVE_BUCKETS, SERVE_CAPACITY = 512, (64, 128, 256), 512
SERVE_RATE, SERVE_CPU_SAMPLES = 2000.0, 8
# The stream opens with a backlog (about 150 requests a family, so each
# family's first batch takes the largest bucket) and the rest arrives on
# the Poisson clock, joining running batches at chunk boundaries: a batch
# keeps the bucket it launched at.
SERVE_BACKLOG = 448
SERVE_MODE_REQUESTS, SERVE_GUARD_REQUESTS = 192, 96
SERVE_PREEMPT_REQUESTS, SERVE_PREEMPT_CLIENTS, SERVE_PREEMPT_STEPS = 192, 64, 4
SERVE_SIGTERM_AFTER = {"scen": 1, "sess": 3}
SESSIONS, SESSION_STEPS = 256, 10
# Phase 38, the user's drivers (tpu_aerial_transport_torch/examples), one
# scenario each as a user runs them: (a) rqp_forest at n = 8 (C-ADMM, DD)
# and n = 3 (centralized) for DRIVER_T s (50 MPC steps), C-ADMM's timing
# pass in chunks of DRIVER_TIME_CHUNK steps, the first DRIVER_CPU_STEPS
# steps (DRIVER_CPU_T s) held against the CPU; (b) the chunked C-ADMM run
# (DRIVER_CHUNK_T s in DRIVER_CHUNKS chunks), SIGTERMed by this script
# once DRIVER_SIGTERM_AFTER chunks are journaled; (c) fault_injection's
# three scenarios and its checkpointed run at n = 8 for FAULT_STEPS steps
# (the example's 200 cut to hold the phase near two minutes; the agent
# dies at half); (d) city_forest at CITY_TREES trees, CITY_N agents,
# CITY_T s (the example's defaults); (e) convergence_rates at its
# defaults, the card's curves within CONV_BAR of the CPU's; (g) the
# session example's nominal storm with the live hub.
DRIVER_N, DRIVER_T, DRIVER_TIME_CHUNK = 8, 0.5, 10
DRIVER_CPU_T, DRIVER_CPU_STEPS = 0.035, 3
DRIVER_CHUNK_T, DRIVER_CHUNKS, DRIVER_SIGTERM_AFTER = 0.4, 4, 2
FAULT_STEPS = 40
CITY_N, CITY_T = 4, 0.5
CONV_SAMPLES, CONV_ITERS, CONV_BAR = 100, 25, 1e-2
DRIVER_SESSION_ARGS = ["--clients", "16", "--steps", "3", "--buckets",
                       "16,32", "--lease-s", "600", "--offline-check"]
# The command that runs a driver module as a user does (``-m``).
DRIVER_CMD = [sys.executable, "-m"]
# Phase 39, the serving fleet: FLEET_REPLICAS replica processes on the
# card behind one front, FLEET_REQUESTS requests of the harness's seeded
# stream over the canonical families with the example's demo tenants, all
# submitted once every replica has built its server; the storm wedges r0
# (which owns the centralized group's hash key at these buckets, and the
# C-ADMM failover key) and SIGKILLs r1 (the C-ADMM group's) within their
# first batches: at 4 lanes r1 has about nine chunks to serve.
# FLEET_CPU_SAMPLES completed requests are served again on the card in
# this process and on the CPU.
FLEET_REPLICAS, FLEET_REQUESTS, FLEET_SEED = 3, 48, 0
FLEET_FAMILIES, FLEET_BUCKETS = "cadmm4,centralized4", "2,4"
FLEET_CHAOS = "sigkill@0.1:r1,wedge@0.05:r0=2"
FLEET_CPU_SAMPLES = 4
# Phase 40: scenario sharding across processes at the headline's width
# (C-ADMM, n = 8, 256 scenarios from default_rng(0), max_iter 20, inner
# 20, pallas_ring over 2 agent shards), depth cut to PODS_STEPS steps: 2
# worker processes on the card, each a 128-scenario slab of one 2x2 mesh
# (2 scenario shards, 2 agent shards), against 1 process of the same
# mesh; PODS_CPU scenarios of the masked step on the CPU; a resumed run
# of PODS_RESUME_STEPS steps in 4 chunks; the rate A/B in turns; and
# PODS_SERVE_REQUESTS requests served on a 1-process 2x2 mesh.
PODS_STEPS, PODS_CPU, PODS_SERVE_REQUESTS = 2, 8, 8
PODS_RESUME_STEPS, PODS_CHUNKS = 8, 4
PODS_BENCH_STEPS, PODS_BENCH_REPS = 3, 3
PODS_WORKLOAD = ["--n", str(N_AGENTS), "--scenarios", str(N_SCENARIOS),
                 "--max-iter", "20", "--inner-iters", "20",
                 "--consensus-impl", "pallas_ring", "--device", "cuda",
                 "--timeout", "300"]
# Phase 41: bundled serving. A bundle of the probe and the four serving
# entries at BUNDLE_BUCKETS, built on the card; BUNDLE_REQUESTS requests of
# the serving example's seeded stream (both canonical families) served by
# a fresh process from the bundle with an empty kernel build directory,
# against the same stream served eagerly in this process;
# BUNDLE_CPU_SAMPLES of them again on the CPU; BUNDLE_STALE_REQUESTS
# C-ADMM requests served from a copy with an edited fingerprint; and the
# time to the first served chunk of each rung in a fresh process.
BUNDLE_ENTRIES = ("serving.batcher:serving_chunk",
                  "serving.batcher:serving_chunk_centralized",
                  "serving.lanes:lane_surgery",
                  "serving.lanes:lane_surgery_centralized")
BUNDLE_BUCKETS = (8, 16)
BUNDLE_REQUESTS, BUNDLE_SEED, BUNDLE_CPU_SAMPLES = 24, 11, 4
BUNDLE_STALE_REQUESTS = 8
# Phase 37(e)'s metrics file, in its run directory.
SERVING_METRICS = "serving.metrics.jsonl"


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
    earlier = EARLIER_MS.get((info["name"], nv + m, args[0].shape[0]),
                             EARLIER_MS.get(info["name"]))
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
    from tpu_aerial_transport_torch.tools.op_profile import OWN_KERNELS

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
    from tpu_aerial_transport_torch.tools.op_profile import OWN_KERNELS

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
            else EARLIER_MS.get((info["name"], nv + m, B))
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
    the graph on and off in turns (phase 43(a) profiles both); the entry's
    periods/s with and without the graph in turns (phase 13 profiles a
    period)."""
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
    report["graph"] = {
        "substeps_bitwise_equal": equal, "entry_bitwise_equal": e_equal,
        "substeps_ms_in_turns": turns, "headline_rates_in_turns": rates,
        "entry_periods_per_s_in_turns": periods,
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


def spawn_child(argv: list, what: str, prefix: str):
    """``(wall seconds, the child's record)``: ``CHILD_CMD + argv`` run to
    its end, its one ``<prefix> {json}`` stdout line parsed; fails the
    phase if the child fails, prints no such record or more than one, or
    prints a result line."""
    t0 = time.perf_counter()
    proc = subprocess.run(CHILD_CMD + argv, capture_output=True, text=True,
                          timeout=300, cwd=HERE)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    recs = [json.loads(line.split(" ", 1)[1]) for line in lines
            if line.startswith(prefix + " ")]
    if proc.returncode != 0 or len(recs) != 1 or any(
            '"ok"' in line for line in lines):
        fail(f"{what} exited {proc.returncode}: stdout "
             f"{proc.stdout[-2000:]!r} stderr {proc.stderr[-4000:]!r}")
    return wall, recs[0]


def spawn_recovery_child(mode: str, run_dir: str, S: int):
    """Phase 33's child: ``(wall seconds, its recovery-child record)``."""
    return spawn_child(["--recovery-child", mode, run_dir, str(S)],
                       f"phase 33's {mode} child", "recovery-child")


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
    # The same work gives the same launches: each run's kernel launches
    # counted from zero.
    zero_launches()
    whole = runr(states, css,
                 on_boundary=lambda c, carry, lg: carries.append(carry))
    torch.cuda.synchronize()
    res_launches = {"chunked": {
        k: v for k, v in admm_kernel.KERNEL_LAUNCHES.items() if v}}
    zero_launches()
    unchunked = res.jit_resilient_rollout(
        hl, ctl.ll.control, ctl.params, n_hl_steps=REC_STEPS,
        acc_des_fn=acc, faults=sched)(states, css)
    torch.cuda.synchronize()
    res_launches["unchunked"] = {
        k: v for k, v in admm_kernel.KERNEL_LAUNCHES.items() if v}
    res_warp = res_launches["chunked"].get("warp_solve_kernel", 0)
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
    ok_c = (chunked_bits and resumed_bits and res_warp > 0
            and res_launches["chunked"] == res_launches["unchunked"]
            and flags == [i >= first_q for i in range(REC_CHUNKS)]
            and bool(whole[2].quarantined[KILL_STEP:, K].all())
            and not bool(whole[2].quarantined[:, :K].any()) and not leak
            and pre.chunks_done == REC_STOP_CHUNK + 1
            and resumed.resumed_from_chunk == REC_STOP_CHUNK + 1)
    print(f"{what} (c): make_chunked_resilient_rollout (phase 29's "
          f"schedules, scenario {K} at +inf thrust from step {KILL_STEP}) "
          f"bitwise jit_resilient_rollout: {chunked_bits}, kernel launches "
          f"chunked {res_launches['chunked']} unchunked "
          f"{res_launches['unchunked']} | scenario {K}'s "
          f"quarantine flag in the carry at the {REC_CHUNKS} boundaries "
          f"(every {runr.chunk_len} steps): {flags} | the other {K} "
          f"scenarios bitwise a benign run's in {len(keys)} log leaves: "
          f"{not leak} | preempted after {pre.chunks_done} chunks, resumed "
          f"in-process from chunk {resumed.resumed_from_chunk}: carry and "
          f"logs bitwise the uninterrupted chunked run's: {resumed_bits} "
          + ("ok" if ok_c else "FAIL") + f" | {card}", flush=True)
    if not ok_c:
        fail(f"{what}: the chunked resilient run (flags {flags}, lane "
             f"leakage in {leak}, launches {res_launches}, preempted after "
             f"{pre.chunks_done}, resumed from "
             f"{resumed.resumed_from_chunk})")
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
        "resilient_launches": res_launches,
        "resilient_resumed_bitwise": resumed_bits}



def all_finite(tree) -> bool:
    """Every floating leaf of a state tree finite."""
    import torch

    from tpu_aerial_transport_torch.tree import leaves

    return all(bool(torch.isfinite(t).all()) for t in leaves(tree)
               if t.is_floating_point())


def max_leaf_err(a, b, n) -> float:
    """The largest difference over every floating leaf of two state trees,
    ``b`` cut to its first ``n`` scenarios and moved to ``a``'s device."""
    from tpu_aerial_transport_torch.tree import leaves

    return max(float((x - y[:n].to(x.device)).abs().max())
               for x, y in zip(leaves(a), leaves(b)) if x.is_floating_point())


def rp_starts(state0, S):
    """The first ``S`` of the ``N_SCENARIOS`` seeded starts (numpy seed 0):
    the payload's velocity N(0, 0.1^2) and angular velocity N(0, 0.05^2) a
    component, and the circle reference's phase, uniform in [0, 2 pi);
    everything else from ``state0``. ``(states, phase (S,))``."""
    import numpy as np
    import torch

    from tpu_aerial_transport_torch.harness import rollout

    rng = np.random.default_rng(0)
    vl = rng.normal(size=(N_SCENARIOS, 3)) * 0.1
    wl = rng.normal(size=(N_SCENARIOS, 3)) * 0.05
    phase = rng.uniform(0.0, 2.0 * np.pi, size=N_SCENARIOS)
    dev = state0.xl.device
    f32 = lambda a: torch.as_tensor(a[:S], dtype=torch.float32,  # noqa: E731
                                    device=dev)
    return (rollout.stack_scenarios(state0, S).replace(vl=f32(vl),
                                                       wl=f32(wl)),
            f32(phase))


def circle_reference(t: float, phase):
    """The JAX closed-loop circle test's reference at time ``t``
    (``tests/test_rp_cadmm.py:155-172``), each scenario's circle started
    at its own phase and shifted to pass through the origin at t = 0:
    ``(x, v, a)``, each ``(S, 3)``."""
    import torch

    r, w = RP_RADIUS, RP_OMEGA
    ang = w * t + phase
    c, s = torch.cos(ang), torch.sin(ang)
    z = torch.zeros_like(phase)
    x = torch.stack([r * c - r * torch.cos(phase), r * s - r * torch.sin(
        phase), z + 0.1 * t], dim=-1)
    v = torch.stack([-r * w * s, r * w * c, z + 0.1], dim=-1)
    a = torch.stack([-r * w**2 * c, -r * w**2 * s, z], dim=-1)
    return x, v, a


def rp_substeps(params):
    """The ten 1 kHz ``rp.integrate`` substeps of a period."""
    from tpu_aerial_transport_torch.models import rp

    def substeps(state, f):
        for _ in range(RP_SUBSTEPS):
            state = rp.integrate(params, state, f, RP_DT)
        return state

    return substeps


def circle_acc(i, state, phase):
    """Period ``i``'s reference acceleration of the circle test's PD loop
    ``(dvl_des, dwl_des)``."""
    import torch

    x_ref, v_ref, a_ref = circle_reference(i * RP_DT * RP_SUBSTEPS, phase)
    dvl = a_ref - 1.5 * (state.vl - v_ref) - 2.0 * (state.xl - x_ref)
    return dvl, torch.zeros_like(dvl)


def rp_periods(control, substeps, cs, state, phase, first, count,
               record=None):
    """``count`` periods of the circle test's loop from period ``first``:
    the PD reference acceleration, one control step, the ten substeps.
    Appends ``(i, (cs, state) before, (state, f, stats) after)`` of each
    period to ``record``. ``-> (cs, state, [stats])``."""
    out = []
    for i in range(first, first + count):
        before = (cs, state)
        f, cs, stats = control(cs, state, circle_acc(i, state, phase))
        state = substeps(state, f)
        out.append(stats)
        if record is not None:
            record.append((i, before, (state, f, stats)))
    return cs, state, out


def cut_to_cpu(tree, n):
    """The first ``n`` scenarios of a state tree, on the CPU."""
    from tpu_aerial_transport_torch.tree import tree_map

    return tree_map(lambda t: t[:n].cpu(), tree)


def periods_vs_cpu(record, control_cpu, physics_cpu, n_cpu):
    """The card's recorded periods against the CPU plain path, on the first
    ``n_cpu`` scenarios, each period from the card's own state and
    controller state at its start: the CPU's control step
    (``control_cpu(i, cs, state) -> (f, stats)``) against the card's
    forces and iteration counts, and the CPU's physics from the card's
    state and forces (``physics_cpu(state, f) -> state``) against the
    card's next state. Each bar then holds the part it measures: the
    forces the controller's rounding, the states the physics'. (A force
    gap within the force bar moves a light payload's state by more than
    the state bar within one period.) ``-> (state err, force err, card
    iters, CPU iters)``."""
    s_err = f_err = 0.0
    it_card, it_cpu = [], []
    for i, (cs_in, st_in), (s_g, f_g, stats_g) in record:
        st_c = cut_to_cpu(st_in, n_cpu)
        f_c, stats_c = control_cpu(i, cut_to_cpu(cs_in, n_cpu), st_c)
        s_c = physics_cpu(st_c, f_g[:n_cpu].cpu())
        s_err = max(s_err, max_leaf_err(s_c, s_g, n_cpu))
        f_err = max(f_err, float((f_c - f_g[:n_cpu].cpu()).abs().max()))
        it_card.append(stats_g.iters[:n_cpu].cpu().tolist())
        it_cpu.append(stats_c.iters.tolist())
    return s_err, f_err, it_card, it_cpu


def flip_bar(disagree64: float, lanes: int) -> float:
    """The share of lanes whose early-exit count may differ between two
    float32 runs of the same solves, where float32 rounding decides the
    stop: ROUNDING_FACTOR times the share on which the plain version's
    float32 and float64 runs differ (``disagree64``), plus three binomial
    standard deviations at ``lanes``, and at least 1 - EFF_EQUAL_SHARE."""
    p = min(ROUNDING_FACTOR * disagree64, 1.0)
    return max(1.0 - EFF_EQUAL_SHARE,
               p + 3.0 * math.sqrt(p * (1.0 - p) / lanes))


def rounding_flips(args, kw) -> float:
    """The share of lanes on which the plain version's early-exit count in
    float32 differs from its count in float64 on the same inputs."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    eff32 = admm_kernel.fused_solve_lanes_reference(*args, **kw)[5]
    eff64 = plain64(args, kw)[5]
    return float((eff32 != eff64).float().mean())


def check_flipped_early_exit(case, a, k, card):
    """The early-exit kernel against its plain version where float32
    rounding decides the stop (the PMRL QPs): outputs within the kernel bar
    on the lanes whose counts agree, every lane that stopped early within
    ``tol`` at its exit, and counts different on no larger a share than
    :func:`flip_bar` allows. Returns the report and the largest error."""
    import torch

    from tpu_aerial_transport_torch.ops import admm_kernel

    names = ("x", "y", "z", "prim_res", "dual_res")
    got = admm_kernel.fused_solve_lanes(*a, **k)
    ref = admm_kernel.fused_solve_lanes_reference(*a, **k)
    ref64 = plain64(a, k)
    torch.cuda.synchronize()
    same = got[5] == ref[5]
    disagree = 1.0 - float(same.float().mean())
    disagree64 = float((ref[5] != ref64[5]).float().mean())
    bar = flip_bar(disagree64, a[0].shape[0])
    errs, noise, ok = agreement(names, got[:5], ref[:5], ref64[:5],
                                same & (ref64[5] == ref[5]))
    stop_ok = stopped_within_tol(got, a, k)
    ok = ok and stop_ok and disagree <= bar
    print(f"early-exit check {case}: B={a[0].shape[0]} d="
          f"{k['nv'] + a[8].shape[-1]} iters={k['iters']} check_every="
          f"{k['check_every']} tol={k['tol']}: counts differ in "
          f"{disagree * 100:.2f}% of lanes (plain float32 vs float64: "
          f"{disagree64 * 100:.2f}%; bar {bar * 100:.2f}%), mean "
          f"{float(got[5].float().mean()):.2f}; lanes that stopped early "
          f"within tol at exit: {stop_ok}; max|err| on equal lanes "
          + " ".join(f"{n}={e:.3e}" for n, e in errs.items())
          + "; plain float32 vs float64 "
          + " ".join(f"{n}={e:.3e}" for n, e in noise.items()) + " "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    if not ok:
        fail(f"early-exit kernel disagrees with its plain version on {case}")
    return {"B": a[0].shape[0], "eff_differ_share": disagree,
            "plain_f32_vs_f64_differ_share": disagree64, "bar": bar,
            "max_abs_err": errs, "plain_f32_vs_f64": noise,
            "stopped_within_tol": stop_ok, "ok": ok}, max(errs.values())


def fixed_timing(what, a, k, card):
    """A fixed-form whole-solve call timed (CUDA graph) beside its bound,
    and its plain version's time: ``(timing, plain_ms, bound_by)``."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    nv, m, B = k["nv"], a[8].shape[-1], a[0].shape[0]
    bytes_ = B * admm_kernel.fused_solve_bytes_per_lane(nv, m, k["n_box"])
    flops = B * admm_kernel.fused_solve_flops_per_lane(
        nv, m, k["iters"], tuple(k["soc_dims"]))
    b_ms, b_by = bound(bytes_, flops)
    timing = kernel_timing(what, a, k, b_ms, card)
    timing.update(bytes=bytes_, flops=flops)
    plain = cuda_ms(
        lambda: admm_kernel.fused_solve_lanes_reference(*a, **k), 5)
    print(f"{timing['name']} ({what}): plain PyTorch {plain:.4f} ms; bound "
          f"{b_ms:.4f} ms by {b_by} ({bytes_ / 1e6:.2f} MB, "
          f"{flops / 1e6:.1f} MFLOP) | {card}", flush=True)
    return timing, plain, b_by


def rp_phase(card, report):
    """Phase 34, the RP model at 256 scenarios x 8 agents through the
    whole-solve kernel's shared-memory body (d = 111): (a) the centralized
    controller in the circle test's loop, one warm-up and TIMED_STEPS timed
    periods, one ``fused_solve_kernel`` launch a period, the substeps from
    a CUDA graph bitwise the eager ones; (b) C-ADMM (max_iter 20, inner 20)
    likewise, one launch a consensus iteration run; (c) the sharded step
    over SHARDS shards against the single program; (d) n = 9 on route
    "scan" with no launch; (e) the first 8 scenarios of (a) and (b) on the
    CPU; (f) the kernel against its plain version on (a)'s and (b)'s
    inputs, timed. Returns the two rows of the kernels line."""
    import torch

    from tpu_aerial_transport_torch.control import rp_cadmm, rp_centralized
    from tpu_aerial_transport_torch.harness import rollout, setup
    from tpu_aerial_transport_torch.harness.cuda_graph import GraphedFn
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.parallel import mesh

    S, n = N_SCENARIOS, N_AGENTS
    report["rp"] = {}

    def build(device, controller, n_=n):
        params, _, state0 = setup.rp_setup(n_, device=device)
        f_eq = rp_centralized.equilibrium_forces(params)
        if controller == "centralized":
            cfg = rp_centralized.make_config(params)
            cs0 = rp_centralized.init_ctrl_state(params, cfg)
            mod = rp_centralized
        else:
            cfg = rp_cadmm.make_config(params, max_iter=20, inner_iters=20)
            cs0 = rp_cadmm.init_state(params, cfg, f_eq)
            mod = rp_cadmm
        return params, cfg, f_eq, cs0, state0, (
            lambda cs, s, a: mod.control(params, cfg, f_eq, cs, s, a))

    rows, captured, records = [], {}, {}
    for controller, form_what in (("centralized", "RP centralized"),
                                  ("cadmm", "RP C-ADMM")):
        params, cfg, f_eq, cs0, state0, control = build("cuda", controller)
        states0, phase = rp_starts(state0, S)
        css0 = rollout.stack_scenarios(cs0, S)
        eager = rp_substeps(params)
        graphed = GraphedFn(eager)
        args, record = [], []
        with capturing(admm_kernel, "fused_solve_lanes", args):
            css1, st1, _ = rp_periods(control, graphed, css0, states0, phase,
                                      0, 1, record)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        css, st, stats = rp_periods(control, graphed, css1, st1, phase, 1,
                                    TIMED_STEPS, record)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = launch_counts()
        iters = torch.stack([s_.iters for s_ in stats])  # (T, S)
        runs = (TIMED_STEPS if controller == "centralized"
                else int(iters.max(dim=1).values.sum()))
        what = f"{form_what} n = {n}"
        check_launches(launches, "fused_solve", runs, what)
        name = entry_name(*args[0])
        if name != "fused_solve_kernel":
            fail(f"{what} took {name}, not the shared-memory body's "
                 "fused_solve_kernel")
        check_body(launches, "fused_solve", name, what)
        if not (all_finite(st) and all_finite(css)):
            fail(f"{what}: non-finite state or forces")
        if (graphed.captures, graphed.replays) != (1, 1 + TIMED_STEPS):
            fail(f"{what}: substeps {graphed.captures} captures, "
                 f"{graphed.replays} replays, expected 1 and "
                 f"{1 + TIMED_STEPS}")
        f_last = record[-1][2][1]
        bits = tree_equal(eager(st1, f_last), graphed(st1, f_last))
        if not bits:
            fail(f"{what}: the graph substeps are not bitwise the eager ones")
        ok_frac = float(torch.stack([s_.ok_frac for s_ in stats]).mean())
        it = iters.float()
        a, k = args[0]
        d = k["nv"] + a[8].shape[-1]
        print(f"{what}: {S} scenarios, circle test loop, d = {d}, "
              f"{TIMED_STEPS} periods in {secs:.4f} s = "
              f"{S * TIMED_STEPS / secs:.2f} scenario-MPC-steps/s"
              + ("" if controller == "centralized" else
                 f" | consensus iters/period mean {float(it.mean()):.3f} max "
                 f"{int(iters.max())}")
              + f" | ok_frac {ok_frac:.4f} | launches {launches} = "
              f"{'periods' if controller == 'centralized' else 'consensus iterations run'}"
              f" {runs}, all {name} | substeps from the CUDA graph, bitwise "
              f"the eager ones: {bits} | {card}", flush=True)
        captured[controller] = args[0]
        records[controller] = record
        report["rp"][controller] = {
            "d": d, "scenario_mpc_steps_per_s": S * TIMED_STEPS / secs,
            "seconds": secs, "launches": launches, "runs": runs,
            "iters_mean": float(it.mean()), "iters_max": int(iters.max()),
            "ok_frac_mean": ok_frac, "graph_bitwise": bits}
        if controller == "cadmm":
            cadmm_setup = (params, cfg, f_eq, css0, states0, phase, control)

    # (c) The sharded step against the single program, on the single
    # program's trajectory.
    params, cfg, f_eq, css, st, phase, control = cadmm_setup
    step_sh = mesh.rp_cadmm_control_sharded(
        params, cfg, f_eq, mesh.make_mesh({"agent": SHARDS}))
    f_err, apart, sh_launches, sh_runs = 0.0, 0, 0, 0
    for i in range(RP_SHARDED_PERIODS):
        acc = circle_acc(i, st, phase)
        zero_launches()
        f_sh, _, stats_sh = step_sh(css, st, acc)
        launches = launch_counts()
        sh_launches += launches["fused_solve"]
        sh_runs += int(stats_sh.iters.max())
        f_1, css, stats_1 = control(css, st, acc)
        f_err = max(f_err, float((f_sh - f_1).abs().max()))
        apart = max(apart, int((stats_sh.iters - stats_1.iters).abs().max()))
        st = rp_substeps(params)(st, f_1)
    ok = (f_err <= RP_SHARDED_FORCE_BAR and apart <= RP_SHARDED_ITERS_APART
          and sh_launches == sh_runs)
    print(f"RP C-ADMM sharded over {SHARDS} shards against the single "
          f"program, {RP_SHARDED_PERIODS} periods of {S} scenarios: max|force"
          f" err| {f_err:.3e} N (bar {RP_SHARDED_FORCE_BAR}), iterations at "
          f"most {apart} apart (bar {RP_SHARDED_ITERS_APART}), "
          f"fused_solve launches {sh_launches} = consensus iterations run "
          f"{sh_runs} " + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    if not ok:
        fail("the sharded RP C-ADMM step disagrees with the single program")
    report["rp"]["sharded"] = {"force_err": f_err, "iters_apart": apart,
                               "launches": sh_launches}

    # (d) n = 9: more than 16 SOC blocks, route "scan", no launch.
    params9, cfg9, f_eq9, cs9, state9, control9 = build("cuda", "centralized",
                                                        9)
    route = rp_centralized.solve_route(9, cfg9)
    if route != "scan":
        fail(f"RP centralized n = 9 resolved to route {route!r}, not 'scan'")
    st9, phase9 = rp_starts(state9, 1)
    zero_launches()
    t0 = time.perf_counter()
    _, st9, _ = rp_periods(control9, rp_substeps(params9),
                           rollout.stack_scenarios(cs9, 1), st9, phase9, 0,
                           RP_N9_PERIODS)
    torch.cuda.synchronize()
    secs9 = time.perf_counter() - t0
    check_launch_counts(launch_counts(), {}, "RP centralized n = 9")
    if not all_finite(st9):
        fail("RP centralized n = 9: non-finite state")
    print(f"RP centralized n = 9 (1 scenario, {RP_N9_PERIODS} periods): "
          f"route {route}, no kernel launched, {RP_N9_PERIODS / secs9:.2f} "
          f"periods/s | {card}", flush=True)
    report["rp"]["n9"] = {"route": route,
                          "periods_per_s": RP_N9_PERIODS / secs9}

    # (e) The first 8 scenarios on the CPU plain path, the first
    # RP_CPU_PERIODS periods, each from the card's state at its start.
    n_cpu = 8
    for controller, form_what in (("centralized", "RP centralized"),
                                  ("cadmm", "RP C-ADMM")):
        params_c, _, _, _, state_c, control_c = build("cpu", controller)
        phase_c = rp_starts(state_c, n_cpu)[1]

        def control_cpu(i, cs, st):
            f, _, stats = control_c(cs, st, circle_acc(i, st, phase_c))
            return f, stats

        s_err, f_err, it_card, it_cpu = periods_vs_cpu(
            records[controller][:RP_CPU_PERIODS], control_cpu,
            rp_substeps(params_c), n_cpu)
        ok = (s_err <= CPU_STATE_ATOL and f_err <= CPU_FORCE_ATOL
              and it_card == it_cpu)
        print(f"{form_what} card vs CPU, {RP_CPU_PERIODS} periods of {n_cpu} "
              f"scenarios, each from the card's state at its start (the "
              f"physics from the card's forces): max|state err| "
              f"{s_err:.2e} (atol {CPU_STATE_ATOL}), "
              f"max|force err| {f_err:.2e} N (atol {CPU_FORCE_ATOL}), "
              f"iterations card {it_card} CPU {it_cpu} "
              + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
        if not ok:
            fail(f"{form_what}: the card disagrees with the CPU plain path")
        report["rp"][controller]["card_vs_cpu"] = {
            "state_err": s_err, "force_err": f_err, "iters_card": it_card,
            "iters_cpu": it_cpu}

    # (f) The kernel against its plain version on (a)'s and (b)'s inputs,
    # timed beside its bound.
    cases = [("rp_central_d111_B256", *captured["centralized"]),
             ("rp_cadmm_d111_B2048", *captured["cadmm"])]
    checks, _ = check_fixed_forms(cases, card)
    report["rp"]["kernel_checks"] = checks
    for (case, a, k), controller in zip(cases, ("centralized", "cadmm")):
        timing, plain, b_by = fixed_timing(case, a, k, card)
        row = solve_row(timing, report["rp"][controller]["launches"][
            "fused_solve"], max(checks[case]["max_abs_err"].values()), plain,
            b_by)
        row["path"] = f"rp_{controller}_n{n}"
        rows.append(row)
        report["rp"][controller].update(timing=timing, plain_ms=plain)
    return rows


def pmrl_starts(state0, S):
    """The first ``S`` of the ``N_SCENARIOS`` seeded starts (numpy seed 0):
    the payload's velocity N(0, 0.05^2) and angular velocity N(0, 0.02^2) a
    component, and the setpoint, uniform in [-0.5, 0.5] x [-0.5, 0.5] x
    [0, 0.4] m; everything else from ``state0``. ``(states, target (S,
    3))``."""
    import numpy as np
    import torch

    from tpu_aerial_transport_torch.harness import rollout

    rng = np.random.default_rng(0)
    vl = rng.normal(size=(N_SCENARIOS, 3)) * 0.05
    wl = rng.normal(size=(N_SCENARIOS, 3)) * 0.02
    target = rng.uniform([-0.5, -0.5, 0.0], [0.5, 0.5, 0.4],
                         size=(N_SCENARIOS, 3))
    dev = state0.xl.device
    f32 = lambda a: torch.as_tensor(a[:S], dtype=torch.float32,  # noqa: E731
                                    device=dev)
    return (rollout.stack_scenarios(state0, S).replace(vl=f32(vl),
                                                       wl=f32(wl)),
            f32(target))


def setpoint_acc(state, target):
    """The setpoint test's clamped PD reference acceleration ``(dvl_des,
    dwl_des)``."""
    import torch

    dvl = -3.0 * state.vl - 1.5 * (state.xl - target)
    nrm = torch.linalg.vector_norm(dvl, dim=-1, keepdim=True)
    dvl = dvl * torch.clamp(1.0 / torch.clamp(nrm, min=1e-9), max=1.0)
    return dvl, torch.zeros_like(dvl)


def pmrl_steps(params, cfg, cs, state, target, count, record=None,
               sync_free=False):
    """``count`` steps of the JAX setpoint test's loop
    (``tests/test_pmrl_centralized.py:70-90``): the clamped PD reference,
    one control step, one ``pmrl.integrate`` at PMRL_DT; with
    ``sync_free`` the integration runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a host synchronisation
    in it fails the run. Appends ``(step, (cs, state) before, (state, f,
    stats) after)`` of each step to ``record``. ``-> (cs, state)``."""
    import torch

    from tpu_aerial_transport_torch.control import pmrl_centralized
    from tpu_aerial_transport_torch.models import pmrl

    for i in range(count):
        before = (cs, state)
        f, cs, stats = pmrl_centralized.control(params, cfg, cs, state,
                                                setpoint_acc(state, target))
        if sync_free:
            torch.cuda.set_sync_debug_mode("error")
        try:
            state = pmrl.integrate(params, state, f, PMRL_DT)
        except RuntimeError as err:
            fail(f"pmrl.integrate synchronised the host: {err}")
        finally:
            if sync_free:
                torch.cuda.set_sync_debug_mode("default")
        if record is not None:
            record.append((i, before, (state, f, stats)))
    return cs, state


def stopped_within_tol(out, args, kw) -> bool:
    """The early-exit stop rule on one call's outputs: every lane that ran
    fewer than ``iters`` iterations (and was not gated off) left with both
    residuals at most ``tol``, or one of them NaN."""
    import torch

    stopped = out[5] < kw["iters"]
    if len(args) > 12 and args[12] is not None:
        stopped = stopped & (args[12] > 0)
    at_tol = (((out[3] <= kw["tol"]) & (out[4] <= kw["tol"]))
              | torch.isnan(out[3]) | torch.isnan(out[4]))
    return bool(at_tol[stopped].all())


@contextlib.contextmanager
def recording_eff(store: list, lanes: int):
    """Record, for every early-exit whole-solve call (card or CPU), its
    first ``lanes`` effective iteration counts and whether the call kept
    the stop rule (:func:`stopped_within_tol`)."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    fn = admm_kernel.fused_solve_lanes

    def wrapper(*args, **kw):
        out = fn(*args, **kw)
        if len(out) == 6:
            store.append((out[5][:lanes].cpu(),
                          stopped_within_tol(out, args, kw)))
        return out

    admm_kernel.fused_solve_lanes = wrapper
    try:
        yield
    finally:
        admm_kernel.fused_solve_lanes = fn


def pmrl_phase(card, report):
    """Phase 35, the PMRL model at 256 scenarios x 8 agents through the
    whole-solve kernel's early-exit form, shared-memory body (d = 111): one
    warm-up and TIMED_STEPS timed steps of the setpoint test's loop, one
    ``fused_solve_early_kernel`` launch a step, ``pmrl.integrate`` free of
    host synchronisations; the first 8 scenarios on the CPU; the kernel
    against its plain version on the warm-up's inputs, timed. Returns the
    row of the kernels line."""
    import torch

    from tpu_aerial_transport_torch.control import pmrl_centralized
    from tpu_aerial_transport_torch.harness import rollout, setup
    from tpu_aerial_transport_torch.models import pmrl
    from tpu_aerial_transport_torch.ops import admm_kernel

    S, n = N_SCENARIOS, N_AGENTS

    def build(device, S_):
        params, _, state0 = setup.pmrl_setup(n, device=device)
        cfg = pmrl_centralized.make_config(params)
        cs0 = rollout.stack_scenarios(
            pmrl_centralized.init_ctrl_state(params, cfg, state0), S_)
        return (params, cfg, cs0) + pmrl_starts(state0, S_)

    params, cfg, css0, states0, target = build("cuda", S)
    n_cpu = 8
    args, record, eff_card = [], [], []
    with capturing(admm_kernel, "fused_solve_lanes", args), \
            recording_eff(eff_card, n_cpu):
        css1, st1 = pmrl_steps(params, cfg, css0, states0, target, 1, record,
                               sync_free=True)
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        css, st = pmrl_steps(params, cfg, css1, st1, target, TIMED_STEPS,
                             record, sync_free=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = launch_counts()
    what = f"PMRL centralized n = {n}"
    check_launches(launches, "fused_solve_early", TIMED_STEPS, what)
    a, k = args[0]
    name = entry_name(a, k)
    if name != "fused_solve_early_kernel":
        fail(f"{what} took {name}, not the shared-memory body's "
             "fused_solve_early_kernel")
    check_body(launches, "fused_solve_early", name, what)
    if not (all_finite(st) and all_finite(css)):
        fail(f"{what}: non-finite state or forces")
    ok_frac = float(torch.stack([r[2][2].ok_frac for r in record[1:]]
                                ).mean())
    err = float(torch.linalg.vector_norm(st.xl - target, dim=-1).mean())
    d = k["nv"] + a[8].shape[-1]
    print(f"{what}: {S} scenarios, setpoint test loop (dt {PMRL_DT}), d = {d},"
          f" {TIMED_STEPS} steps in {secs:.4f} s = {S * TIMED_STEPS / secs:.2f}"
          f" scenario-MPC-steps/s | ok_frac {ok_frac:.4f} | mean distance to "
          f"the setpoint {err:.4f} m | pmrl.integrate under sync debug mode "
          f"'error': no host synchronisation | launches {launches}, all "
          f"{name} | {card}", flush=True)
    report["pmrl"] = {"d": d, "scenario_mpc_steps_per_s":
                      S * TIMED_STEPS / secs, "seconds": secs,
                      "launches": launches, "ok_frac_mean": ok_frac,
                      "setpoint_distance_mean": err, "integrate_sync_free":
                      True}

    # The first 8 scenarios on the CPU plain path, the first RP_CPU_PERIODS
    # steps, each from the card's state at its start.
    params_c, cfg_c, _, _, target_c = build("cpu", n_cpu)
    eff_cpu = []

    def control_cpu(i, cs, st):
        f, _, stats = pmrl_centralized.control(
            params_c, cfg_c, cs, st, setpoint_acc(st, target_c))
        return f, stats

    with recording_eff(eff_cpu, n_cpu):
        s_err, f_err, _, _ = periods_vs_cpu(
            record[:RP_CPU_PERIODS], control_cpu,
            lambda st, f: pmrl.integrate(params_c, st, f, PMRL_DT), n_cpu)
    eff_g = torch.stack([e for e, _ in eff_card[:RP_CPU_PERIODS]])
    eff_c = torch.stack([e for e, _ in eff_cpu])
    differ = float((eff_g != eff_c).float().mean())
    stop_ok = all(ok_ for _, ok_ in eff_card + eff_cpu)
    # How often float32 rounding alone flips the stop on these solves, on
    # the card's warm-up lanes (plain float32 against float64): the
    # decision is the dual residual at tol within rounding, not a fault, so
    # the counts are reported and the stop rule is held on both sides.
    flips = rounding_flips(a, k)
    ok = s_err <= CPU_STATE_ATOL and f_err <= CPU_FORCE_ATOL and stop_ok
    print(f"{what} card vs CPU, {RP_CPU_PERIODS} steps of {n_cpu} scenarios, "
          f"each from the card's state at its start (the physics from the "
          f"card's forces): max|state err| "
          f"{s_err:.2e} (atol {CPU_STATE_ATOL}), max|force err| {f_err:.2e} "
          f"N (atol {CPU_FORCE_ATOL}), early-exit counts card"
          f" {eff_g.tolist()} CPU {eff_c.tolist()}: {differ * 100:.2f}% differ"
          f" (the plain version's float32 and float64 counts differ on "
          f"{flips * 100:.2f}% of the card's {a[0].shape[0]} warm-up lanes); "
          f"every lane that stopped early left within tol on both: {stop_ok} "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    if not ok:
        fail(f"{what}: the card disagrees with the CPU plain path")
    report["pmrl"]["card_vs_cpu"] = {
        "state_err": s_err, "force_err": f_err, "eff_card": eff_g.tolist(),
        "eff_cpu": eff_c.tolist(), "eff_differ_share": differ,
        "plain_f32_vs_f64_differ_share": flips, "stopped_within_tol":
        stop_ok}

    # The kernel against its plain version on the warm-up's inputs (and its
    # fixed form at the same inputs), timed beside its bound.
    check, err_e = check_flipped_early_exit("pmrl_d111_B256", a, k, card)
    f_checks, err_f = check_fixed_forms(
        [("pmrl_d111_B256_fixed", *fixed_form(a, k))], card)
    eff = admm_kernel.fused_solve_lanes(*a, **k)[5]
    bytes_, flops = early_exit_bound(a, k, eff)
    b_ms, b_by = bound(bytes_, flops)
    timing = kernel_timing("PMRL's control step", a, k, b_ms, card)
    plain = event_ms(
        lambda: admm_kernel.fused_solve_lanes_reference(*a, **k), 5)
    print(f"{name} (PMRL, B={a[0].shape[0]}, d={d}, mean eff "
          f"{float(eff.float().mean()):.2f}): plain PyTorch {plain:.4f} ms "
          f"(host-driven: it synchronises once a chunk); bound {b_ms:.4f} ms "
          f"by {b_by} ({bytes_ / 1e6:.2f} MB, {flops / 1e6:.1f} MFLOP) | "
          f"{card}", flush=True)
    report["pmrl"].update(kernel_check=check, fixed_check=f_checks,
                          timing=timing, plain_ms=plain, bytes=bytes_,
                          flops=flops)
    row = solve_row(timing, launches["fused_solve_early"], max(err_e, err_f),
                    plain, b_by)
    row["path"] = f"pmrl_centralized_n{n}"
    return [row]


def turns(arms, order):
    """Run ``arms[name]()`` in ``order`` (e.g. a, b, b, a, so a drift of
    the shared host's speed does not read as a difference); returns each
    arm's results in its order of runs."""
    out = {}
    for name in order:
        out.setdefault(name, []).append(arms[name]())
    return out


def grads_apart(g, ref, rtol, atol):
    """``(max relative gap, within rtol/atol)`` of gradient dicts."""
    gap, ok = 0.0, True
    for k in ref:
        a, b = float(g[k].double().cpu()), float(ref[k].double().cpu())
        gap = max(gap, abs(a - b) / max(abs(b), 1e-30))
        ok = ok and abs(a - b) <= atol + rtol * abs(b)
    return gap, ok


def iteration_ops(descent):
    """``(ops, views)``: the ATen operators one eager iteration of
    ``descent`` dispatches, and how many of them are views."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.ops += 1
            Count.views += bool(func.is_view)
            return func(*args, **(kwargs or {}))

    with Count():
        descent.iteration()
    return Count.ops, Count.views


def diff_phase(card, report):
    """Phase 36, the differentiable simulation at n = 8 from the
    grad-tuning example's tilted start: card against CPU, the remat A/B,
    the descent's CUDA graph against eager, the example's outcome, system
    identification and trajectory optimisation on the card, and no kernel
    launched (module docstring)."""
    import torch

    from tpu_aerial_transport_torch import convert
    from tpu_aerial_transport_torch.control import centralized
    from tpu_aerial_transport_torch.examples import grad_tuning
    from tpu_aerial_transport_torch.harness import diff, setup
    from tpu_aerial_transport_torch.ops import admm_kernel

    n = DIFF_N
    t_phase = time.perf_counter()
    zero_launches()
    for k in diff.GRAPH_COUNTS:
        diff.GRAPH_COUNTS[k] = 0
    out = report["diff"] = {}
    detuned = grad_tuning.DETUNED
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()

    # (a) Card against CPU: the same inputs (built on the CPU, copied).
    params_c, f_eq_c, st_c, ref_c = grad_tuning.start(n, "cpu")
    params_g, f_eq_g, st_g, ref_g = on_card((params_c, f_eq_c, st_c, ref_c))
    loss_c = diff.make_rollout_loss(params_c, f_eq_c, ref_c,
                                    n_steps=DIFF_CPU_STEPS, k_att=1.0)
    loss_g = diff.make_rollout_loss(params_g, f_eq_g, ref_g,
                                    n_steps=DIFF_CPU_STEPS, k_att=1.0)
    gains_g = convert.gains(detuned, "cuda")
    t0 = time.perf_counter()
    v_g, g_g = diff.value_and_grad(loss_g, gains_g, st_g)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_c, g_c = diff.value_and_grad(
        loss_c, convert.gains(detuned, "cpu"), st_c)
    cpu_s = time.perf_counter() - t0
    v_gap = abs(float(v_g) - float(v_c)) / abs(float(v_c))
    g_gap, g_ok = grads_apart(g_g, g_c, DIFF_GRAD_RTOL, DIFF_GRAD_ATOL)
    ok = v_gap <= DIFF_VALUE_RTOL and g_ok
    print(f"diff (a) card vs CPU, make_rollout_loss n = {n}, "
          f"{DIFF_CPU_STEPS} steps, k_att 1, detuned gains: value "
          f"{float(v_g):.8f} vs {float(v_c):.8f} ({v_gap:.2e} relative, rtol "
          f"{DIFF_VALUE_RTOL}); gradients " + " ".join(
              f"{k} {float(g_g[k]):.6e} vs {float(g_c[k]):.6e}" for k in g_c)
          + f" (max {g_gap:.2e} relative, rtol {DIFF_GRAD_RTOL}); value and "
          f"gradient {card_s:.3f} s on the card (eager, first call), "
          f"{cpu_s:.3f} s on the CPU " + ("ok" if ok else "FAIL")
          + f" | {card}", flush=True)
    out["card_vs_cpu"] = {"steps": DIFF_CPU_STEPS, "value_gap": v_gap,
                          "grad_gap": g_gap, "card_s": card_s,
                          "cpu_s": cpu_s}
    if not ok:
        fail("diff (a): the card's value or gradient disagrees with the CPU")

    # (b) Remat against no remat, in turns, with each arm's peak memory
    # above the phase's start and above the arm's own start (the first
    # holds whatever the phase allocated before the arm).
    losses = {r: diff.make_rollout_loss(params_g, f_eq_g, ref_g,
                                        n_steps=DIFF_REMAT_STEPS,
                                        remat=r, k_att=1.0)
              for r in (True, False)}

    def remat_arm(r):
        def run():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            v, g = diff.value_and_grad(losses[r], gains_g, st_g)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            return v, g, ms, (peak - mem0, peak - base)
        return run

    runs = turns({"remat": remat_arm(True), "no_remat": remat_arm(False)},
                 ("remat", "no_remat", "no_remat", "remat"))
    (v1, g1, _, _), (v2, g2, _, _) = runs["remat"][0], runs["no_remat"][0]
    bitwise = torch.equal(v1, v2) and all(torch.equal(g1[k], g2[k])
                                          for k in g1)
    v_gap = abs(float(v1) - float(v2)) / abs(float(v2))
    g_gap, g_ok = grads_apart(g1, g2, REMAT_GRAD_RTOL, 1e-8)
    ok = v_gap <= REMAT_VALUE_RTOL and g_ok
    ms = {k: [r[2] for r in v] for k, v in runs.items()}
    peak = {k: [r[3] for r in v] for k, v in runs.items()}
    print(f"diff (b) remat vs no remat, {DIFF_REMAT_STEPS} steps on the "
          f"card, in turns (remat, no remat, no remat, remat): value "
          f"{v_gap:.2e} apart, gradients {g_gap:.2e} (rtol "
          f"{REMAT_VALUE_RTOL} and {REMAT_GRAD_RTOL}), bitwise equal: "
          f"{bitwise}; ms per value and gradient remat {ms['remat']} no "
          f"remat {ms['no_remat']}; peak memory (B) above the phase's and "
          f"the arm's start remat {peak['remat']}, no remat "
          f"{peak['no_remat']} "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    out["remat"] = {"steps": DIFF_REMAT_STEPS, "value_gap": v_gap,
                    "grad_gap": g_gap, "bitwise": bitwise, "ms": ms,
                    "peak_bytes": peak}
    if not ok:
        fail("diff (b): remat and no remat disagree")

    # (c) The descent replayed from its CUDA graph against eager, in turns.
    loss_ab, st_ab = grad_tuning.problem(n, DIFF_AB_STEPS, "cuda")

    def graph_arm():
        d = diff.Descent(loss_ab, gains_g, st_ab, lr=0.05)
        before = dict(diff.GRAPH_COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d.capture()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = d.run(DIFF_AB_ITERS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return res, t1 - t0, t2 - t1, tuple(
            diff.GRAPH_COUNTS[k] - before[k] for k in ("captures", "replays"))

    def eager_arm():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = diff.tune_gains(loss_ab, gains_g, st_ab, lr=0.05,
                              iters=DIFF_AB_ITERS, graph=False)
        torch.cuda.synchronize()
        return res, 0.0, time.perf_counter() - t0, (0, 0)

    runs = turns({"graph": graph_arm, "eager": eager_arm},
                 ("graph", "eager", "eager", "graph"))
    # What one graph holds: the ATen ops of one eager iteration of one MPC
    # step (views launch no kernel).
    loss_1, st_1 = grad_tuning.problem(n, 1, "cuda")
    ops, views = iteration_ops(diff.Descent(loss_1, gains_g, st_1))
    ref_best, ref_hist = runs["eager"][0][0]
    equal = all(torch.equal(h, ref_hist) and all(
        torch.equal(b[k], ref_best[k]) for k in ref_best)
        for (b, h), *_ in runs["graph"] + runs["eager"])
    evals = DIFF_AB_ITERS + 1
    rate = {k: [evals / r[2] for r in v] for k, v in runs.items()}
    capture_s = [r[1] for r in runs["graph"]]
    counts = [r[3] for r in runs["graph"]]
    print(f"diff (c) tune_gains graph vs eager, {DIFF_AB_STEPS} steps, SGD "
          f"{DIFF_AB_ITERS} iterations from the detuned gains, in turns "
          f"(graph, eager, eager, graph): histories and best gains bitwise "
          f"equal: {equal} (hist {ref_hist.tolist()}); gradient evaluations"
          f"/s graph {[round(x, 3) for x in rate['graph']]} (replays only; "
          f"warm-up and capture {[round(x, 3) for x in capture_s]} s), eager "
          f"{[round(x, 3) for x in rate['eager']]}; (captures, replays) of "
          f"each graph arm {counts}; one iteration of one MPC step "
          f"dispatches {ops} ATen ops, {views} of them views | {card}",
          flush=True)
    out["graph_vs_eager"] = {
        "steps": DIFF_AB_STEPS, "iters": DIFF_AB_ITERS, "bitwise": equal,
        "evals_per_s": rate, "capture_s": capture_s, "graph_counts": counts,
        "hist": ref_hist.tolist(), "ops_per_step": ops,
        "views_per_step": views}
    if not equal or counts != [(1, evals)] * 2:
        fail("diff (c): the descent's graph replay is not bitwise the eager "
             "descent, or it did not replay from one capture")

    # (d) The example's outcome at n = 8 through the graph.
    before = dict(diff.GRAPH_COUNTS)
    t0 = time.perf_counter()
    res = grad_tuning.main(["--n", str(n), "--steps", str(DIFF_TUNE_STEPS),
                            "--iters", str(DIFF_TUNE_ITERS), "--device",
                            "cuda"])
    ex_s = time.perf_counter() - t0
    delta = {k: diff.GRAPH_COUNTS[k] - before[k] for k in before}
    improvement = res["hist"][0] / res["tuned"]
    ok = (all(math.isfinite(v) for v in res["hist"])
          and all(v > 0 for v in res["gains"].values())
          and res["tuned"] < TUNED_BAR * res["detuned"]
          and delta == {"captures": 1, "replays": DIFF_TUNE_ITERS + 1})
    print(f"diff (d) grad_tuning example at n = {n}, {DIFF_TUNE_STEPS} steps,"
          f" {DIFF_TUNE_ITERS} SGD iterations through the graph ({delta}): "
          f"detuned {res['detuned']:.5f}, tuned {res['tuned']:.5f} (bar "
          f"{TUNED_BAR} x detuned), improvement {improvement:.4f}x, gains "
          f"{res['gains']}, wall {ex_s:.3f} s " + ("ok" if ok else "FAIL")
          + f" | {card}", flush=True)
    out["example"] = dict(res, steps=DIFF_TUNE_STEPS, iters=DIFF_TUNE_ITERS,
                          improvement=improvement, wall_s=ex_s,
                          graph_counts=delta)
    if not ok:
        fail("diff (d): the example's descent did not tune the gains")

    # (e) System identification: record at the true mass, start 40% heavy,
    # lr from the curvature measured here (tests/test_diff.py).
    params, _, st0 = setup.rqp_setup(n, device="cuda")
    f_eq = centralized.equilibrium_forces(params)
    ref = convert.gains(grad_tuning.REFERENCE, "cuda")
    xl_ref = st0.xl + torch.tensor([0.5, 0.2, 0.3], device="cuda")
    s, rec = st0, []
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(DIFF_SYSID_STEPS):
            f = diff.payload_pd_forces(params, f_eq, s, xl_ref)
            s = diff.substep_rollout(params, ref, s, f)
            rec.append((f, s.xl, s.vl))
    f_seq, xl_obs, vl_obs = (torch.stack(x) for x in zip(*rec))
    loss = diff.make_sysid_loss(params.m, params.J, params.Jl, params.r, ref,
                                f_seq, xl_obs, vl_obs)
    true_ml = float(params.ml)
    theta0 = {"log_ml": torch.full((), math.log(true_ml * 1.4),
                                   device="cuda")}
    with torch.no_grad():
        at_truth = float(loss({"log_ml": torch.log(params.ml)}, st0))
        at_start = float(loss(theta0, st0))
    lr = 0.1 / (at_start / math.log(1.4) ** 2)
    before = dict(diff.GRAPH_COUNTS)
    theta, hist = diff.tune_gains(loss, theta0, st0, lr=lr,
                                  iters=DIFF_SYSID_ITERS, min_gain=None)
    est = float(torch.exp(theta["log_ml"]))
    sys_s = time.perf_counter() - t0
    delta = {k: diff.GRAPH_COUNTS[k] - before[k] for k in before}
    rel = abs(est - true_ml) / true_ml
    ok = (bool(torch.isfinite(hist).all()) and float(hist[-1]) < float(
        hist[0]) and rel < SYSID_MASS_RTOL and at_start > 100 * max(
        at_truth, 1e-12))
    print(f"diff (e) sysid at n = {n}: {DIFF_SYSID_STEPS} recorded steps, "
          f"loss at the truth {at_truth:.3e}, at the 40%-heavy start "
          f"{at_start:.3e}, lr {lr:.4e}, {DIFF_SYSID_ITERS} SGD iterations "
          f"through the graph ({delta}): mass {est:.6f} vs {true_ml:.6f} "
          f"({rel * 100:.3f}%, bar {SYSID_MASS_RTOL * 100:.0f}%), wall "
          f"{sys_s:.3f} s " + ("ok" if ok else "FAIL") + f" | {card}",
          flush=True)
    out["sysid"] = {"steps": DIFF_SYSID_STEPS, "iters": DIFF_SYSID_ITERS,
                    "at_truth": at_truth, "at_start": at_start, "lr": lr,
                    "est": est, "true": true_ml, "rel_err": rel,
                    "hist": hist.tolist(), "wall_s": sys_s,
                    "graph_counts": delta}
    if not ok:
        fail("diff (e): system identification missed the payload mass")

    # (f) Trajectory optimisation with Adam (tests/test_diff.py's problem,
    # the horizon cut), on the card through the graph and its first
    # iterations on the CPU from the same inputs.
    params_c, _, st0_c = setup.rqp_setup(n, device="cpu")
    f_eq_c = centralized.equilibrium_forces(params_c)
    goal_c = st0_c.xl + torch.tensor([0.8, 0.0, 0.0])
    obs_c = st0_c.xl[:2] + torch.tensor([0.4, 0.0])
    kw = dict(n_steps=DIFF_TRAJ_STEPS, obstacle_radius=0.25, w_effort=1e-4)
    plan0 = {"acc": torch.zeros((DIFF_TRAJ_STEPS, 3))}
    args_g = on_card((params_c, f_eq_c, goal_c, obs_c, st0_c))
    loss_g = diff.make_trajopt_loss(*args_g[:3], obstacle_xy=args_g[3], **kw)
    before = dict(diff.GRAPH_COUNTS)
    t0 = time.perf_counter()
    plan, hist = diff.tune_gains(loss_g, {"acc": plan0["acc"].cuda()},
                                 args_g[4], lr=0.5,
                                 iters=DIFF_TRAJ_ITERS, min_gain=None,
                                 optimizer="adam")
    hist = hist.cpu()
    traj_s = time.perf_counter() - t0
    delta = {k: diff.GRAPH_COUNTS[k] - before[k] for k in before}
    loss_c = diff.make_trajopt_loss(params_c, f_eq_c, goal_c,
                                    obstacle_xy=obs_c, **kw)
    _, hist_c = diff.tune_gains(loss_c, plan0, st0_c, lr=0.5, iters=2,
                                min_gain=None, optimizer="adam")
    h_gap = float(((hist[:3] - hist_c).abs() / hist_c.abs()).max())
    ok = (bool(torch.isfinite(hist).all()) and float(hist.min()) < float(
        hist[0]) and h_gap <= TRAJ_HIST_RTOL and bool(
        torch.isfinite(plan["acc"]).all()))
    print(f"diff (f) trajopt with Adam at n = {n}: horizon "
          f"{DIFF_TRAJ_STEPS}, {DIFF_TRAJ_ITERS} iterations through the graph"
          f" ({delta}): loss {float(hist[0]):.6f} -> best "
          f"{float(hist.min()):.6f}; first 3 history values vs the CPU port "
          f"{h_gap:.2e} apart (rtol {TRAJ_HIST_RTOL}); wall {traj_s:.3f} s "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    out["trajopt"] = {"steps": DIFF_TRAJ_STEPS, "iters": DIFF_TRAJ_ITERS,
                      "hist": hist.tolist(), "hist_cpu": hist_c.tolist(),
                      "hist_gap": h_gap, "wall_s": traj_s,
                      "graph_counts": delta}
    if not ok:
        fail("diff (f): trajectory optimisation did not descend or "
             "disagrees with the CPU")

    # (g) No kernel on this path.
    counts = {**launch_counts(), **admm_kernel.KERNEL_LAUNCHES,
              **admm_kernel.CHUNK_LAUNCHES}
    launched = {k: v for k, v in counts.items() if v}
    phase_s = time.perf_counter() - t_phase
    print(f"diff (g) kernel launches across phase 36: "
          f"{launched if launched else 'none'}; phase 36 took {phase_s:.1f} s"
          f" | {card}", flush=True)
    out["launches"], out["phase_s"] = counts, phase_s
    if launched:
        fail(f"diff: phase 36 launched kernels {launched}")


SERVE_FAMILY_NAMES = ("cadmm4", "centralized4", "cadmm8")


def serving_families(device="cuda"):
    """Phase 37's families on ``device``: the two canonical ones and the
    headline's agent count as an ad-hoc C-ADMM family (``FamilySpec``'s
    other defaults)."""
    from tpu_aerial_transport_torch.serving import batcher

    return [batcher.make_family("cadmm4", device),
            batcher.make_family("centralized4", device),
            batcher.Family(batcher.FamilySpec(name="cadmm8",
                                              controller="cadmm", n=8),
                           device)]


def serving_stream(n: int, seed: int, prefix: str = "s"):
    """``n`` seeded requests mixed over the three families: horizons on
    the chunk grid, 2 to 16 high-level steps; payload starts N(0, 1) m and
    velocities N(0, 0.2) m/s from ``default_rng(seed)``."""
    import numpy as np

    from tpu_aerial_transport_torch.serving.queue import ScenarioRequest

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        fam = SERVE_FAMILY_NAMES[int(rng.integers(3))]
        out.append(ScenarioRequest(
            family=fam, horizon=2 * int(rng.integers(1, 9)),
            x0=tuple(float(v) for v in rng.normal(0.0, 1.0, 3)),
            v0=tuple(float(v) for v in rng.normal(0.0, 0.2, 3)),
            request_id=f"{prefix}{i:04d}"))
    return out


class ServeRecorder:
    """Wraps each family's program on the card: records each chunk's
    per-lane consensus counts (``logs.iters``, in dispatch order) and,
    while ``capture`` is on, the inputs of each family's first whole-solve
    launch. Its own launches (``launch``) bypass the capture."""

    def __init__(self, families):
        from tpu_aerial_transport_torch.ops import admm_kernel

        self.launch = admm_kernel.fused_solve_lanes
        self.iters, self.captured = [], {}
        self.capture, self.current = False, None
        for fam in families:
            chunk, carry = fam._build()
            fam._program = (self._wrap(fam.name, chunk), carry)
        admm_kernel.fused_solve_lanes = self._record

    def close(self):
        from tpu_aerial_transport_torch.ops import admm_kernel

        admm_kernel.fused_solve_lanes = self.launch

    def _wrap(self, name, chunk):
        def run(carry, i0):
            self.current = name
            try:
                carry, logs = chunk(carry, i0)
            finally:
                self.current = None
            self.iters.append((name, logs.iters))
            return carry, logs

        return run

    def _record(self, *args, **kw):
        if (self.capture and self.current is not None
                and self.current not in self.captured):
            self.captured[self.current] = (
                [None if a is None else a.clone() for a in args], dict(kw))
        return self.launch(*args, **kw)

    def counts(self, rows):
        """Each request's consensus counts, step by step: the recorded
        chunks matched in order to the tracer's ``chunk_dispatch`` rows
        (family and lane map), from ``rows`` (every dispatch on the card
        since the recorder's list was last cleared)."""
        disp = [r for r in rows if r["name"] == "chunk_dispatch"]
        if [r["attrs"]["family"] for r in disp] != [f for f, _ in
                                                     self.iters]:
            fail("phase 37: recorded chunks and dispatch spans disagree")
        out = {}
        for r, (_, it) in zip(disp, self.iters):
            it = it.cpu()
            for lane, rid, _ in r["attrs"]["lanes"]:
                out.setdefault(rid, []).extend(it[:, lane].tolist())
        return out


def span_ms(rows, name, key):
    """Milliseconds of each ``name`` span, grouped by ``key(row)``."""
    out = {}
    for r in rows:
        if r["name"] == name and "t1_mono" in r:
            out.setdefault(key(r), []).append(
                (r["t1_mono"] - r["t0_mono"]) * 1e3)
    return out


def ms_stats(groups):
    import numpy as np

    return {str(k): {"n": len(v), "mean": float(np.mean(v)),
                     "p50": float(np.percentile(v, 50)),
                     "max": float(np.max(v))}
            for k, v in sorted(groups.items(), key=lambda kv: str(kv[0]))}


def boundary_ms(rows):
    """Chunk dispatch and boundary harvest ms by ``family@bucket`` from a
    server's trace rows, and each batch's bucket by batch id."""
    bucket_of = {r["attrs"]["batch_id"]: r["attrs"]["bucket"]
                 for r in rows if r["name"] == "batch_form"}
    dispatch = ms_stats(span_ms(
        rows, "chunk_dispatch",
        lambda r: f"{r['attrs']['family']}@{r['attrs']['bucket']}"))
    harvest = ms_stats(span_ms(
        rows, "harvest", lambda r: f"{r['attrs']['family']}@"
        f"{bucket_of[r['attrs']['batch_id']]}"))
    return dispatch, harvest, bucket_of


def serve_drain(server, stream, rate=0.0, seed=0, backlog=0):
    """Submit ``stream`` -- its first ``backlog`` requests at once, the
    rest on a Poisson clock at ``rate`` arrivals/s (all at once when 0) --
    and pump until drained: ``(wall s, tickets)``."""
    import numpy as np
    import torch

    due = np.zeros(len(stream))
    if rate and len(stream) > backlog:
        due[backlog:] = np.cumsum(np.random.default_rng(seed + 1).exponential(
            1.0 / rate, len(stream) - backlog))
    t0 = time.perf_counter()
    tickets, i = [], 0
    while i < len(stream) or server.has_work():
        now = time.perf_counter() - t0
        while i < len(stream) and due[i] <= now:
            tickets.append(server.submit(stream[i]))
            i += 1
        if not server.pump() and i < len(stream):
            time.sleep(min(1e-3, max(0.0, due[i] - now)))
    torch.cuda.synchronize()
    return time.perf_counter() - t0, tickets


def check_served(server, tickets, what, rung):
    """Every ticket completed, every chunk on ``rung``, no fallback and
    no failed chunk."""
    bad = [t for t in tickets if t.status != "completed"]
    rungs = server.stats()["dispatch_rungs"]
    if (bad or set(rungs) != {rung} or server.guard.fallbacks
            or server.backend_failures):
        fail(f"phase 37 {what}: {len(bad)} requests not completed "
             f"({bad[:3]}), chunks by rung {rungs}, "
             f"{server.guard.fallbacks} guard fallbacks, "
             f"{server.backend_failures} failed chunks")
    return rungs[rung]


def results_apart(a: dict, b: dict):
    """``(requests whose results are bitwise equal, max abs difference)``
    over the request ids both maps hold."""
    from tpu_aerial_transport_torch.tree import leaves

    same, worst = 0, 0.0
    for rid in a:
        la, lb = leaves(a[rid]), leaves(b[rid])
        same += all(x.dtype == y.dtype and bool((x == y).all())
                    for x, y in zip(la, lb))
        worst = max([worst] + [float((x.double() - y.double()).abs().max())
                               for x, y in zip(la, lb)])
    return same, worst


def serving_child(mode: str, run_dir: str) -> int:
    """Phase 37's child process: both serving examples on the card, with
    ``--run-dir`` under ``run_dir``: ``preempt`` sends itself SIGTERM
    after each example's SERVE_SIGTERM_AFTER pump rounds; ``resume``
    resumes each run. Prints one ``serving-child {json}`` line with both summaries and
    never the result line."""
    import contextlib
    import io

    from tpu_aerial_transport_torch.examples import (
        serve_scenarios,
        serve_sessions,
    )

    t0 = time.perf_counter()
    out = {}
    for name, mod, argv in serving_example_args(run_dir):
        extra = (["--sigterm-after", str(SERVE_SIGTERM_AFTER[name])]
                 if mode == "preempt" else ["--resume"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = (serve_scenarios if mod == "scenarios"
                  else serve_sessions).main(
                argv + extra + ["--results",
                                os.path.join(run_dir, f"{name}_{mode}.json")])
        out[name] = {"rc": rc,
                     "summary": json.loads(buf.getvalue().splitlines()[-1])}
    out["seconds"] = time.perf_counter() - t0
    print("serving-child " + json.dumps(out), flush=True)
    return 0


def serving_example_args(run_dir):
    """The two examples' arguments in phase 37(d): ``(name, example,
    argv)``; ``run_dir`` None runs them uninterrupted, with no journal."""
    base = {
        "scen": ("scenarios", [
            "--requests", str(SERVE_PREEMPT_REQUESTS),
            "--buckets", ",".join(map(str, SERVE_BUCKETS)), "--seed", "7"]),
        "sess": ("sessions", [
            "--clients", str(SERVE_PREEMPT_CLIENTS), "--steps",
            str(SERVE_PREEMPT_STEPS), "--buckets",
            ",".join(map(str, SERVE_BUCKETS)), "--lease-s", "600"]),
    }
    return [(name, mod, argv + ["--device", "cuda"] + (
        ["--run-dir", os.path.join(run_dir, name)] if run_dir else []))
        for name, (mod, argv) in base.items()]


def serving_phase(card, report):
    """Phase 37, the serving tier on the card (module docstring): (a) the
    full-width stream, (b) composition independence, (c) surgery and
    dispatch modes, (d) preemption of both examples in child processes,
    (e) the guard, (f) sessions, and (g) the numbers."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from tpu_aerial_transport_torch.examples import (
        serve_scenarios,
        serve_sessions,
    )
    from tpu_aerial_transport_torch.obs import trace
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.resilience import backend
    from tpu_aerial_transport_torch.serving import server as server_mod
    from tpu_aerial_transport_torch.serving.queue import ScenarioRequest

    t_phase = time.perf_counter()
    out = report["serving"] = {}
    fams = serving_families("cuda")
    by_name = {f.name: f for f in fams}
    rec = ServeRecorder(fams)
    onchip = backend.RUNG_ONCHIP

    def server(**kw):
        kw.setdefault("buckets", SERVE_BUCKETS)
        kw.setdefault("capacity", SERVE_CAPACITY)
        return server_mod.ScenarioServer(families=fams, device="cuda", **kw)

    try:
        # (a) Warm every (family, bucket) shape once (kernel loads, graph
        # captures), then the timed stream: every counter zeroed just
        # before it, read just after.
        t0 = time.perf_counter()
        warm = server()
        for b in SERVE_BUCKETS:
            serve_drain(warm, [ScenarioRequest(
                family=f.name, horizon=2, x0=(0.1 * (i % 7), 0.0, 1.0),
                request_id=f"w{b}{f.name}{i}")
                for f in fams for i in range(b)])
        warm_s = time.perf_counter() - t0
        tracer = trace.Tracer(track="server")
        srv = server(tracer=tracer)
        stream = serving_stream(SERVE_REQUESTS, seed=0)
        rec.iters.clear()
        rec.capture = True
        zero_launches()
        torch.cuda.synchronize()
        wall, tickets = serve_drain(srv, stream, rate=SERVE_RATE,
                                    backlog=SERVE_BACKLOG)
        launches = launch_counts()
        by_body = {k: v for k, v in admm_kernel.KERNEL_LAUNCHES.items()
                   if v}
        rec.capture = False
        chunks = check_served(srv, tickets, "(a)", onchip)
        warp = sum(v for k, v in by_body.items() if k.startswith("warp_"))
        block = sum(v for k, v in by_body.items()
                    if k.startswith("fused_solve"))
        if not (warp and block):
            fail(f"phase 37 (a): whole-solve launches by body {by_body}: "
                 "both the warp body (C-ADMM) and the block body "
                 "(centralized) must launch")
        lat = np.array([t.slo.t_complete - t.slo.t_admit for t in tickets])
        dispatch_ms, harvest_ms, bucket_of = boundary_ms(tracer.rows)
        counts = rec.counts(tracer.rows)
        steps = sum(t.steps_served for t in tickets)
        print(f"serving (a): {len(tickets)} requests over "
              f"{SERVE_FAMILY_NAMES}, {SERVE_BACKLOG} queued at the start "
              f"and the rest on a Poisson clock at {SERVE_RATE:g}/s, "
              f"buckets {SERVE_BUCKETS} (launched "
              f"{sorted(set(bucket_of.values()))}): all completed in "
              f"{wall:.3f} s = "
              f"{len(tickets) / wall:.2f} requests/s, "
              f"{steps / wall:.2f} scenario-MPC-steps/s; {chunks} chunks, "
              f"every one on {onchip}, 0 fallbacks; admit->complete p50 "
              f"{np.percentile(lat, 50) * 1e3:.2f} ms, p99 "
              f"{np.percentile(lat, 99) * 1e3:.2f} ms; whole-solve launches "
              f"{by_body}; (warm-up of the 9 shapes {warm_s:.2f} s) | "
              f"{card}", flush=True)
        print(f"  chunk dispatch ms by family@bucket {dispatch_ms}; "
              f"boundary harvest ms by family@bucket {harvest_ms}",
              flush=True)
        out["a"] = {"requests": len(tickets), "wall_s": wall,
                    "requests_per_s": len(tickets) / wall,
                    "scenario_steps_per_s": steps / wall, "chunks": chunks,
                    "admit_to_complete_ms": {
                        "p50": float(np.percentile(lat, 50) * 1e3),
                        "p99": float(np.percentile(lat, 99) * 1e3)},
                    "launches": launches, "by_body": by_body,
                    "dispatch_ms": dispatch_ms, "harvest_ms": harvest_ms,
                    "warm_s": warm_s}
        # The kernel on the inputs captured from one served chunk of each
        # family, against its plain version.
        names = ("x", "y", "z", "prim_res", "dual_res")
        out["a"]["kernel"] = {}
        for fname, (args, kw) in sorted(rec.captured.items()):
            early = bool(kw.get("check_every")) and kw.get("tol", 0) > 0
            if early:
                checks, worst = check_early_exit(
                    [(f"served {fname}", args, kw)], card)
                out["a"]["kernel"][fname] = checks
                continue
            got = rec.launch(*args, **kw)
            ref = admm_kernel.fused_solve_lanes_reference(*args, **kw)
            errs, noise, ok = agreement(names, got, ref, plain64(args, kw))
            print(f"serving (a) kernel check, {fname}'s served chunk: B="
                  f"{args[0].shape[0]} d={kw['nv'] + args[8].shape[-1]} "
                  f"iters={kw['iters']}: max|err| " + " ".join(
                      f"{n}={e:.3e}" for n, e in errs.items())
                  + " " + ("ok" if ok else "FAIL") + f" | {card}",
                  flush=True)
            out["a"]["kernel"][fname] = {"max_abs_err": errs,
                                         "plain_f32_vs_f64": noise,
                                         "ok": ok}
            if not ok:
                fail(f"phase 37 (a): the kernel disagrees with its plain "
                     f"version on {fname}'s served chunk")
        if set(rec.captured) != set(SERVE_FAMILY_NAMES):
            fail(f"phase 37 (a): launches captured from {set(rec.captured)}")
        # 8 sampled requests against the same requests on the CPU.
        sample = tickets[::len(tickets) // SERVE_CPU_SAMPLES][
            :SERVE_CPU_SAMPLES]
        cpu = server_mod.ScenarioServer(
            families=[type(f)(f.spec, "cpu") for f in fams],
            buckets=(SERVE_CPU_SAMPLES,), device="cpu")
        _, cpu_t = serve_drain(cpu, [t.request for t in sample])
        same, worst = results_apart(
            {t.request.request_id: t.result for t in sample},
            {t.request.request_id: t.result for t in cpu_t})
        ok = worst <= CPU_STATE_ATOL and all(
            t.status == "completed" for t in cpu_t)
        print(f"serving (a) card vs CPU, {len(sample)} sampled requests "
              f"({sorted({t.request.family for t in sample})}): max |state "
              f"diff| {worst:.3e} (bar {CPU_STATE_ATOL}), {same} bitwise "
              + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
        out["a"]["cpu"] = {"max_abs": worst, "bitwise": same, "ok": ok}
        if not ok:
            fail("phase 37 (a): sampled requests disagree with the CPU")

        # (b) Composition independence: one request of each family served
        # alone (the smallest bucket, the rest filler lanes), inside a full
        # batch of the largest bucket and late-joined at a boundary of a
        # full batch.
        probes = {f: ScenarioRequest(family=f, horizon=8,
                                     x0=(1.2, -0.4, 0.8),
                                     v0=(0.1, 0.05, -0.05),
                                     request_id=f"probe_{f}")
                  for f in SERVE_FAMILY_NAMES}

        def others(f, n, horizon, tag):
            return [ScenarioRequest(family=f, horizon=horizon,
                                    x0=(0.01 * i, 0.02, 1.0),
                                    v0=(0.0, 0.0, 0.01 * (i % 5)),
                                    request_id=f"{tag}{f}{i}")
                    for i in range(n)]

        big = SERVE_BUCKETS[-1]
        comp, comp_counts = {}, {}
        for arm in ("alone", "busy", "late"):
            tr = trace.Tracer(track=arm)
            rec.iters.clear()
            s = server(tracer=tr, capacity=4 * big)
            if arm == "alone":
                _, ts = serve_drain(s, list(probes.values()))
            elif arm == "busy":
                _, ts = serve_drain(s, [r for f in SERVE_FAMILY_NAMES for r in
                                        others(f, big - 1, 8, "b")
                                        + [probes[f]]])
            else:
                first = [s.submit(r) for f in SERVE_FAMILY_NAMES for r in
                         others(f, big - 1, 8, "l")
                         + others(f, 1, 2, "ls")]
                s.pump()
                late = [s.submit(probes[f]) for f in SERVE_FAMILY_NAMES]
                serve_drain(s, [])
                ts = first + late
                for t in late:
                    if t.slo.t_admit <= first[0].slo.t_launch:
                        fail("phase 37 (b): the late request did not join "
                             "at a boundary")
            check_served(s, ts, f"(b) {arm}", onchip)
            got = {t.request.request_id: t for t in ts
                   if t.request.request_id.startswith("probe_")}
            comp[arm] = {rid: t.result for rid, t in got.items()}
            comp[arm + "_bucket"] = {rid: s._batches[t.request.family].bucket
                                     for rid, t in got.items()}
            cts = rec.counts(tr.rows)
            comp_counts[arm] = {rid: cts[rid] for rid in got}
        b_out = {}
        for arm in ("busy", "late"):
            same, worst = results_apart(comp["alone"], comp[arm])
            counts_eq = comp_counts["alone"] == comp_counts[arm]
            b_out[arm] = {"bitwise": same, "max_abs": worst,
                          "counts_equal": counts_eq,
                          "buckets": comp[arm + "_bucket"]}
            if not (same == len(probes)
                    or (worst <= BUCKET_STATE_ATOL and counts_eq)):
                fail(f"phase 37 (b): {arm} against alone: {same} of "
                     f"{len(probes)} bitwise, max {worst:.3e}, counts equal "
                     f"{counts_eq}")
        print(f"serving (b) composition: alone (buckets "
              f"{comp['alone_bucket']}) against busy and late-joined "
              f"(buckets {comp['busy_bucket']}): "
              + "; ".join(f"{arm} {v['bitwise']}/{len(probes)} bitwise, "
                          f"max {v['max_abs']:.3e}, counts equal "
                          f"{v['counts_equal']}" for arm, v in b_out.items())
              + f" | {card}", flush=True)
        out["b"] = b_out

        # (c) Surgery and dispatch modes on one mixed stream with late
        # joins: every result bitwise equal; the surgery spans timed.
        mode_stream = serving_stream(SERVE_MODE_REQUESTS, seed=3, prefix="m")
        modes, surgery_ms, mode_wall, mode_ms = {}, {}, {}, {}
        for arm, kw in (("host_sync", {}),
                        ("device_sync", {"surgery": "device"}),
                        ("device_pipelined", {"dispatch": "pipelined"})):
            tr = trace.Tracer(track=arm)
            s = server(tracer=tr, **kw)
            half = len(mode_stream) // 2
            t0 = time.perf_counter()
            ts = [s.submit(r) for r in mode_stream[:half]]
            s.pump()
            ts += [s.submit(r) for r in mode_stream[half:]]
            serve_drain(s, [])
            mode_wall[arm] = time.perf_counter() - t0
            mode_ms[arm] = boundary_ms(tr.rows)[:2]
            check_served(s, ts, f"(c) {arm}", onchip)
            modes[arm] = {t.request.request_id: t.result for t in ts}
            for impl, v in span_ms(tr.rows, trace.LANE_SURGERY,
                                   lambda r: r["attrs"]["impl"]).items():
                surgery_ms.setdefault(f"{impl} ({arm})", []).extend(v)
        c_out = {}
        for arm in ("device_sync", "device_pipelined"):
            same, worst = results_apart(modes["host_sync"], modes[arm])
            c_out[arm] = {"bitwise": same, "of": len(modes[arm]),
                          "max_abs": worst}
            if same != len(modes["host_sync"]):
                fail(f"phase 37 (c): {arm} against host_sync: {same} of "
                     f"{len(modes[arm])} bitwise (max {worst:.3e})")
        c_out["surgery_ms"] = ms_stats(surgery_ms)
        c_out["wall_s"], c_out["dispatch_harvest_ms"] = mode_wall, mode_ms
        print(f"serving (c) modes: {len(mode_stream)} requests, device "
              f"surgery and pipelined dispatch each bitwise the host splice "
              f"+ sync on every request; wall s {mode_wall}; surgery ms "
              f"{c_out['surgery_ms']}; host_sync's chunk dispatch and "
              f"harvest ms by family@bucket {mode_ms['host_sync']} | "
              f"{card}", flush=True)
        out["c"] = c_out

        # The guard's deadline watchdog (a thread a chunk) on the healthy
        # path: the same stream under the default guard and under one with
        # no watchdog (deadline 0: a plain call), in turns; each chunk's
        # dispatch span, whose median the host's spread moves less than a
        # stream's wall.
        guard_wall = {"watchdog": [], "plain": []}
        guard_ms = {"watchdog": [], "plain": []}
        guard_chunks = 0
        for arm in ("watchdog", "plain", "plain", "watchdog"):
            tr = trace.Tracer(track=f"guard_{arm}")
            s = server(tracer=tr, guard=backend.BackendGuard(
                deadline_s=None if arm == "watchdog" else 0,
                primary_rung=onchip))
            t0 = time.perf_counter()
            ts = [s.submit(r) for r in mode_stream[:half]]
            s.pump()
            ts += [s.submit(r) for r in mode_stream[half:]]
            serve_drain(s, [])
            guard_wall[arm].append(time.perf_counter() - t0)
            guard_ms[arm].extend(span_ms(tr.rows, trace.CHUNK_DISPATCH,
                                         lambda r: 0).get(0, []))
            guard_chunks = check_served(s, ts, f"(c) guard {arm}", onchip)
            same, worst = results_apart(
                modes["host_sync"], {t.request.request_id: t.result
                                     for t in ts})
            if same != len(modes["host_sync"]):
                fail(f"phase 37 (c): the {arm} guard's results: {same} of "
                     f"{len(ts)} bitwise host_sync's (max {worst:.3e})")
        p50 = {arm: float(np.median(v)) for arm, v in guard_ms.items()}
        print(f"serving (c) guard cost: {len(mode_stream)} requests, "
              f"{guard_chunks} chunks an arm, in turns (results bitwise): "
              f"chunk dispatch p50 with the watchdog "
              f"{p50['watchdog']:.3f} ms, without {p50['plain']:.3f} ms "
              f"({p50['watchdog'] - p50['plain']:+.3f} ms); wall s with "
              f"{guard_wall['watchdog']}, without {guard_wall['plain']} | "
              f"{card}", flush=True)
        out["c"]["guard"] = {"wall_s": guard_wall, "chunks": guard_chunks,
                             "dispatch_p50_ms": p50}

        # The device's busy share in one profiled pump of full batches.
        s = server(capacity=4 * big)
        for f in SERVE_FAMILY_NAMES:
            for r in others(f, big, 8, "p"):
                s.submit(r)
        s.pump()
        torch.cuda.synchronize()
        wall_ms, ph = profile_step(s.pump)
        print_profile(f"one pump() of three full ({big}-lane) batches",
                      wall_ms, ph, card)
        out["profile"] = {"wall_ms": wall_ms,
                          "busy_share": ph["kernels_us"] / 1e3 / wall_ms,
                          "phases": ph}
        serve_drain(s, [])

        # (d) Both examples preempted by SIGTERM in a child and resumed in
        # a second child; per-request (per-step) digests against the
        # uninterrupted runs, made here.
        run_dir = os.path.join(HERE, "build", "serving_run")
        shutil.rmtree(run_dir, ignore_errors=True)
        os.makedirs(run_dir)
        ref = {}
        for name, mod, argv in serving_example_args(None):
            path = os.path.join(run_dir, f"{name}_ref.json")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = (serve_scenarios if mod == "scenarios"
                      else serve_sessions).main(argv + ["--results", path])
            if rc:
                fail(f"phase 37 (d): the uninterrupted {name} run exited {rc}")
            with open(path) as fh:
                ref[name] = json.load(fh)
        walls = {}
        for mode in ("preempt", "resume"):
            walls[mode], child = spawn_child(
                ["--serving-child", mode, run_dir],
                f"phase 37's {mode} child", "serving-child")
            for name in ref:
                if child[name]["rc"] != 0:
                    fail(f"phase 37 (d): {mode} {name} exited "
                         f"{child[name]['rc']}")
                if mode == "preempt" and not child[name]["summary"][
                        "preempted"]:
                    fail(f"phase 37 (d): the {name} child was not preempted")
        d_out = {"child_wall_s": walls}
        for name in ref:
            merged = {}
            for mode in ("preempt", "resume"):
                with open(os.path.join(run_dir, f"{name}_{mode}.json")) as fh:
                    for rid, row in json.load(fh).items():
                        if "digest" in row:
                            merged[rid] = row["digest"]
            want = {rid: row["digest"] for rid, row in ref[name].items()
                    if "digest" in row}
            d_out[name] = {"digests": len(want),
                           "equal": sum(merged.get(r) == d
                                        for r, d in want.items())}
            if merged != want or not want:
                fail(f"phase 37 (d): {name}: {d_out[name]['equal']} of "
                     f"{len(want)} digests equal after preempt + resume "
                     f"({len(merged)} served)")
        print(f"serving (d) preemption: scenarios ({d_out['scen']['digests']}"
              f" requests) and sessions ({d_out['sess']['digests']} steps) "
              f"preempted by SIGTERM in a child after {SERVE_SIGTERM_AFTER} "
              f"pump rounds and resumed in another: every digest the "
              f"uninterrupted run's; child wall s {walls} | {card}",
              flush=True)
        out["d"] = d_out

        # (e) The guard.
        out["e"] = serving_guard_checks(card, server, fams)

        # (f) Sessions: 256 concurrent cadmm4 sessions, 10 control steps,
        # against the offline chunk on the card; one session at a 1 us
        # step deadline.
        out["f"] = serving_session_checks(card, server, by_name["cadmm4"])
    finally:
        rec.close()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"serving: phase 37 took {out['phase_s']:.1f} s | {card}",
          flush=True)
    return out["a"]["by_body"]


def serving_guard_checks(card, server, fams):
    """Phase 37(e): ``crash@3`` fails exactly the third guarded chunk on
    the card (one journaled ``backend_event``; its batch's requests
    ``failed``, journaled; no CPU rung; every other chunk on the card and
    every other result bitwise a clean run; the failed requests, submitted
    again, bitwise a clean run), a real OOM classifies ``oom`` with the
    process usable after, and the subprocess probe passes on the card."""
    import dataclasses
    import shutil

    import torch

    from tpu_aerial_transport_torch.obs import export, trace
    from tpu_aerial_transport_torch.resilience import backend
    from tpu_aerial_transport_torch.resilience.recovery import RunJournal
    from tpu_aerial_transport_torch.serving import server as server_mod

    stream = serving_stream(SERVE_GUARD_REQUESTS, seed=5, prefix="g")
    _, clean = serve_drain(server(), stream)
    run_dir = os.path.join(HERE, "build", "serving_guard")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.environ[backend.FAULTS_ENV] = "crash@3"
    try:
        # Its metrics and spans (one file, SERVING_METRICS) are what phase
        # 43 reads back with the operator's tools.
        writer = export.MetricsWriter(os.path.join(run_dir, SERVING_METRICS))
        s = server(run_dir=run_dir, metrics=writer,
                   tracer=trace.Tracer(writer, track="server"))
    finally:
        del os.environ[backend.FAULTS_ENV]
    _, got = serve_drain(s, stream)
    stats = s.stats()
    rungs = stats["dispatch_rungs"]
    journal = RunJournal(run_dir, server_mod.SERVING_JOURNAL).read()
    events = [e for e in journal if e["event"] == "backend_event"]
    failed = [t for t in got if t.status == "failed"]
    failed_rows = {e["request_id"] for e in journal
                   if e["event"] == "serving_done"
                   and e["status"] == "failed"
                   and e.get("reason") == "device_crash"}
    served = [t for t in got if t.status == "completed"]
    # The failed requests again, under new ids: a client's retry.
    again = [s.submit(dataclasses.replace(t.request,
                                          request_id=t.request.request_id
                                          + ".retry"))
             for t in failed]
    while s.pump():
        pass
    torch.cuda.synchronize()
    ref = {t.request.request_id: t.result for t in clean}
    same, worst = results_apart(
        {t.request.request_id: t.result for t in served + again},
        {rid: ref[rid.removesuffix(".retry")]
         for rid in [t.request.request_id for t in served + again]})
    ok = (len(events) == 1 and events[0]["kind"] == "device_crash"
          and set(rungs) == {backend.RUNG_ONCHIP}
          and s.guard.fallbacks == 0 and stats["guard_fallbacks"] == 0
          and stats["backend_failures"] == 1
          and failed and len(served) + len(failed) == len(got)
          and all(t.reason == "device_crash" for t in failed)
          and failed_rows == {t.request.request_id for t in failed}
          and all(t.status == "completed" for t in again)
          and same == len(served) + len(again))
    print(f"serving (e) guard: TAT_BACKEND_FAULTS=crash@3 for one server: "
          f"{len(events)} backend_event "
          f"({[e['label'] for e in events]}, "
          f"{[e['kind'] for e in events]}); {len(failed)} requests failed "
          f"(reason device_crash, {len(failed_rows)} journaled), "
          f"{len(served)} completed; chunks by rung {rungs}, "
          f"{s.guard.fallbacks} fallbacks, {stats['backend_failures']} "
          f"failed chunk; {same} of {len(served) + len(again)} results "
          f"(the failed ones resubmitted) bitwise a clean card run, max "
          f"{worst:.3e} " + ("ok" if ok else "FAIL") + f" | {card}",
          flush=True)
    if not ok:
        fail("phase 37 (e): crash@3 did not fail exactly one chunk's "
             "requests, journaled, on the card alone")
    total = torch.cuda.get_device_properties(0).total_memory
    try:
        torch.empty(2 * total, dtype=torch.uint8, device="cuda")
        kind = None
    except torch.OutOfMemoryError as e:
        kind = backend.classify(e)
    torch.cuda.empty_cache()
    x = torch.ones(1024, device="cuda")
    usable = float(x @ x) == 1024.0
    info = {}
    t0 = time.perf_counter()
    probe_ok, detail = backend.probe_subprocess(timeout_s=120, info=info)
    probe_s = time.perf_counter() - t0
    print(f"serving (e) a real OOM ({2 * total / 2**30:.1f} GiB asked) "
          f"classified {kind!r}, the card usable after: {usable}; "
          f"probe_subprocess {probe_ok} ({detail}, {info}) in "
          f"{probe_s:.2f} s | {card}", flush=True)
    if kind != "oom" or not usable or not probe_ok or info.get(
            "n_devices") != torch.cuda.device_count():
        fail("phase 37 (e): the OOM did not classify as oom, the card was "
             "unusable after it, or the probe failed")
    return {"crash": {"events": events, "rungs": rungs, "bitwise": same,
                      "max_abs": worst}, "oom": kind, "probe": info,
            "probe_s": probe_s}


def serving_session_checks(card, server, fam):
    """Phase 37(f): SESSIONS concurrent ``cadmm4`` sessions for
    SESSION_STEPS control steps at a generous deadline, every served
    control bitwise the family's chunk on the card run offline over the
    same post-delta states (one 256-lane batch a step), no degraded step;
    then one session whose second step has a 1 us deadline: that step
    degrades to hold-last, counted, and its state and next step stay the
    offline stream's."""
    import numpy as np
    import torch

    from tpu_aerial_transport_torch.resilience.recovery import host_copy
    from tpu_aerial_transport_torch.serving import sessions
    from tpu_aerial_transport_torch.tree import leaves, tree_map

    rng = np.random.default_rng(11)
    x0 = rng.normal(0.0, 1.0, (SESSIONS, 3))
    v0 = rng.normal(0.0, 0.2, (SESSIONS, 3))
    dx = rng.normal(0.0, 0.05, (SESSION_STEPS, SESSIONS, 3))
    dv = rng.normal(0.0, 0.01, (SESSION_STEPS, SESSIONS, 3))
    s = server()
    host = sessions.SessionHost(s, lease_s=1e9, step_deadline_s=60.0)
    leases = [host.open(f"c{i}", "cadmm4", tuple(x0[i]),
                        tuple(v0[i]))["lease"] for i in range(SESSIONS)]
    served = np.empty((SESSION_STEPS, SESSIONS), object)
    t0 = time.perf_counter()
    lat = []
    for k in range(SESSION_STEPS):
        steps = [host.step(f"c{i}", leases[i], k + 1, tuple(dx[k, i]),
                           tuple(dv[k, i])) for i in range(SESSIONS)]
        while host.pump():
            pass
        for i, t in enumerate(steps):
            if t.rung != sessions.RUNG_SERVED:
                fail(f"phase 37 (f): step {k + 1} of c{i}: {t}")
            served[k, i] = t.result
            lat.append(t.latency_s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    def offline(xs, vs):
        """The family's chunk on the card over one batch of post-delta
        states (lane i = session i), per-lane results on the host."""
        tmpl = fam.batched_template_host(len(xs))
        state = tmpl[0].replace(
            xl=torch.tensor(xs, dtype=torch.float32),
            vl=torch.tensor(vs, dtype=torch.float32))
        carry = tree_map(lambda t: t.to("cuda"), (state,) + tuple(tmpl[1:]))
        new = host_copy(fam.chunk_fn(carry, 0)[0][0])
        return [fam.lane_result((new,), i) for i in range(len(xs))]

    x, v = x0.copy(), v0.copy()
    same = total = 0
    for k in range(SESSION_STEPS):
        x, v = x + dx[k], v + dv[k]
        ref = offline(x, v)
        for i in range(SESSIONS):
            total += 1
            same += all(torch.equal(a, b) for a, b in
                        zip(leaves(served[k, i]), leaves(ref[i])))
    stats = host.stats()
    ok = same == total and stats["steps_degraded"] == 0
    # One session at a 1 us deadline on its second step.
    s2 = server()
    host2 = sessions.SessionHost(s2, lease_s=1e9)
    lease = host2.open("slow", "cadmm4", tuple(x0[0]), tuple(v0[0]))["lease"]
    rungs, results = [], []
    for k in range(3):
        t = host2.step("slow", lease, k + 1, tuple(dx[k, 0]), tuple(dv[k, 0]),
                       deadline_s=(1e-6 if k == 1 else 60.0))
        while host2.pump():
            pass
        rungs.append(t.rung)
        results.append(t.result)
    want_x = x0[0] + dx[0, 0] + dx[1, 0] + dx[2, 0]
    slow_ok = (rungs == [sessions.RUNG_SERVED, sessions.RUNG_HOLD_LAST,
                         sessions.RUNG_SERVED]
               and host2.stats()["steps_degraded"] == 1
               and np.array_equal(host2.sessions["slow"].x, want_x)
               and all(torch.equal(a, b) for a, b in
                       zip(leaves(results[1]), leaves(results[0])))
               and all(torch.equal(a, b) for a, b in zip(
                   leaves(results[2]), leaves(served[2, 0]))))
    lat = np.array(lat)
    print(f"serving (f) sessions: {SESSIONS} cadmm4 sessions x "
          f"{SESSION_STEPS} steps in {wall:.3f} s "
          f"({SESSIONS * SESSION_STEPS / wall:.1f} steps/s, step latency "
          f"p50 {np.percentile(lat, 50) * 1e3:.2f} ms, p99 "
          f"{np.percentile(lat, 99) * 1e3:.2f} ms): {same} of {total} served "
          f"controls bitwise the offline chunk, steps_degraded "
          f"{stats['steps_degraded']}; the 1 us session's rungs {rungs}, "
          f"steps_degraded {host2.stats()['steps_degraded']}, state and "
          f"next step the offline stream's: {slow_ok} | {card}", flush=True)
    if not (ok and slow_ok):
        fail("phase 37 (f): the session stream is not the offline stream, "
             "or the degraded step was not honest")
    return {"steps_per_s": SESSIONS * SESSION_STEPS / wall,
            "latency_ms": {"p50": float(np.percentile(lat, 50) * 1e3),
                           "p99": float(np.percentile(lat, 99) * 1e3)},
            "bitwise": same, "of": total, "stats": stats,
            "slow_rungs": rungs}


# The K2 row layouts compared by ``--k2-chains``: (chains, the longest row
# summed in one chain). Chains 1 is one chain at every shape; (8, 64) is
# the shipped layout.
K2_VARIANTS = ((1, 128), (2, 64), (4, 64), (8, 64), (16, 64))


def have_matplotlib() -> bool:
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def run_driver(main, argv):
    """``(return value, stdout lines, wall seconds)`` of a driver's
    ``main(argv)`` run in this process, its output captured."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue().splitlines(), time.perf_counter() - t0


def lines_with(lines, *prefixes):
    return [ln for ln in lines if ln.startswith(prefixes)]


def rqp_driver_args(name: str, T: float, device: str, out: str):
    """rqp_forest's arguments in phase 38(a): C-ADMM and DD at n = 8, the
    default centralized controller at n = 3."""
    ctl = [] if name == "centralized" else ["--controller", name]
    n = 3 if name == "centralized" else DRIVER_N
    return ctl + ["-n", str(n), "-T", str(T), "--out", out,
                  "--device", device]


def driver_child(run_dir: str) -> int:
    """Phase 38's card child: the drivers run through their ``main`` on
    the card, one after another, every launch counter zeroed just before
    each and read just after. Prints one ``driver-child {json}`` line and
    never the result line."""
    import numpy as np
    import torch

    from tpu_aerial_transport_torch.examples import (
        city_forest,
        convergence_rates,
        fault_injection,
        rqp_forest,
        serve_sessions,
    )
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.resilience import faults

    os.chdir(run_dir)  # rqp_forest --plots draws into the working directory.
    t_all = time.perf_counter()
    rec = {"matplotlib": have_matplotlib()}

    def launched():
        torch.cuda.synchronize()
        return {k: v for k, v in admm_kernel.KERNEL_LAUNCHES.items() if v}

    # (a) rqp_forest, the three controllers.
    rec["rqp"] = {}
    for name in ("cadmm", "dd", "centralized"):
        argv = rqp_driver_args(name, DRIVER_T, "cuda",
                               os.path.join(run_dir, f"{name}.npz"))
        argv += (["--time-chunk", str(DRIVER_TIME_CHUNK)]
                 + (["--plots"] if rec["matplotlib"] else [])
                 if name == "cadmm" else ["--time-chunk", "0"])
        zero_launches()
        rc, lines, wall = run_driver(rqp_forest.main, argv)
        rec["rqp"][name] = {
            "rc": rc, "seconds": wall, "launches": launched(),
            "lines": lines_with(lines, "done in", "Solve time",
                                "Solver iterations", "kernel launches",
                                "figures")}
    if not rec["matplotlib"]:
        # --plots refuses up front, before any rollout, without matplotlib.
        try:
            rqp_forest.main(["--plots", "--device", "cuda"])
            rec["plots_refused"] = None
        except SystemExit as e:
            rec["plots_refused"] = str(e)
    # (b) the uninterrupted chunked run, the preempted one's reference.
    zero_launches()
    rc, lines, wall = run_driver(rqp_forest.main, [
        "--controller", "cadmm", "-n", str(DRIVER_N), "-T",
        str(DRIVER_CHUNK_T), "--chunks", str(DRIVER_CHUNKS), "--ckpt-dir",
        os.path.join(run_dir, "chunk_full"), "--out",
        os.path.join(run_dir, "chunk_full.npz"), "--time-chunk", "0"])
    rec["chunked"] = {"rc": rc, "seconds": wall, "launches": launched()}
    # (c) fault_injection: the three scenarios and the checkpointed run.
    zero_launches()
    out, lines, wall = run_driver(fault_injection.main, [
        "-n", str(DRIVER_N), "--steps", str(FAULT_STEPS), "--device",
        "cuda"])
    t_fail = FAULT_STEPS // 2
    killed = out[f"agent 0 killed @ step {t_fail}"]
    sched = fault_injection.scenarios(DRIVER_N, FAULT_STEPS, "cuda")[
        "30% consensus dropout"]
    rec["fault"] = {
        "seconds": wall, "launches": launched(),
        "killed_after_max_abs": float(killed.f_des[t_fail:, 0].abs().max()),
        "killed_before_min_norm": float(
            killed.f_des[:t_fail, 0].norm(dim=-1).min()),
        "others_min_norm": float(killed.f_des[:, 1:].norm(dim=-1).min()),
        "rungs": {name: np.bincount(lg.fallback_rung.cpu().numpy(),
                                    minlength=4).tolist()
                  for name, lg in out.items()},
        "quarantined": {name: bool(lg.quarantined[-1])
                        for name, lg in out.items()},
        "masks": [faults.fault_step(sched, t).msg_ok.cpu().tolist()
                  for t in range(FAULT_STEPS)],
        "summary": [ln for ln in lines if ln.strip()],
    }
    zero_launches()
    _, lines, wall = run_driver(fault_injection.main, [
        "-n", str(DRIVER_N), "--steps", str(FAULT_STEPS), "--chunks",
        str(DRIVER_CHUNKS), "--ckpt-dir", os.path.join(run_dir, "fi_full"),
        "--device", "cuda"])
    rec["fault_checkpointed"] = {"seconds": wall, "launches": launched(),
                                 "summary": [ln for ln in lines
                                             if ln.strip()]}
    # (d) city_forest at the example's defaults.
    zero_launches()
    out, lines, wall = run_driver(city_forest.main, [
        "--trees", str(CITY_TREES), "-n", str(CITY_N), "-T", str(CITY_T),
        "--device", "cuda"])
    lg = out["logs"]
    rec["city"] = {
        "seconds": wall, "launches": launched(),
        "env_query": out["env_query"], "grid": out["grid"],
        "lines": lines_with(lines, "world", "grid", "running", "done in",
                            "telemetry"),
        "telemetry": {k: out[k] for k in ("steps", "iters_sum",
                                          "collision_steps",
                                          "min_env_dist")},
        "recount": {"steps": int(lg.xl.shape[0]),
                    "iters_sum": int(lg.iters.sum()),
                    "collision_steps": int(lg.collision.sum()),
                    "min_env_dist": float(lg.min_env_dist.min())},
        "steps_per_s": int(lg.xl.shape[0]) / out["wall_s"],
    }
    # (e) convergence_rates: the curves, then the effort A/B.
    zero_launches()
    figure = (os.path.join(run_dir, "convergence_rates.png")
              if rec["matplotlib"] else "")
    curves, lines, wall = run_driver(convergence_rates.main, [
        "--samples", str(CONV_SAMPLES), "--iters", str(CONV_ITERS),
        "--out", figure, "--device", "cuda"])
    np.savez(os.path.join(run_dir, "conv_card.npz"), **curves)
    rec["conv"] = {"seconds": wall, "launches": launched(),
                   "figure": figure,
                   "lines": lines_with(lines, "C-ADMM", "DD")}
    zero_launches()
    ab, lines, wall = run_driver(convergence_rates.main, [
        "--samples", str(CONV_SAMPLES), "--iters", str(CONV_ITERS),
        "--effort", "ab", "--device", "cuda"])
    rec["conv_ab"] = {"seconds": wall, "launches": launched(),
                      "summary": ab}
    # (g) the session example's nominal storm with the live hub.
    zero_launches()
    metrics = os.path.join(run_dir, "sessions", "r0.metrics.jsonl")
    os.makedirs(os.path.dirname(metrics), exist_ok=True)
    rc, lines, wall = run_driver(serve_sessions.main, DRIVER_SESSION_ARGS + [
        "--metrics", metrics, "--device", "cuda"])
    rec["sessions"] = {"rc": rc, "seconds": wall, "launches": launched(),
                       "metrics": metrics,
                       "summary": json.loads(lines[-1])}
    rec["seconds"] = time.perf_counter() - t_all
    print("driver-child " + json.dumps(rec), flush=True)
    return 0


def preempted_driver(argv, run_dir, what):
    """Run a driver module as a user does (``DRIVER_CMD``) with a
    checkpointed run into ``run_dir``, send it SIGTERM once
    DRIVER_SIGTERM_AFTER chunks are journaled, and return ``(chunks
    journaled, wall seconds, stderr)``; fails the phase unless the driver
    stopped as preempted."""
    import signal

    from tpu_aerial_transport_torch.resilience import recovery

    t0 = time.perf_counter()
    proc = subprocess.Popen(DRIVER_CMD + argv, cwd=HERE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    journal = recovery.RunJournal(run_dir)
    sent = False
    try:
        while proc.poll() is None and time.perf_counter() - t0 < 300:
            if not sent and journal.exists() and sum(
                    e.get("event") == "chunk" for e in journal.read()
            ) >= DRIVER_SIGTERM_AFTER:
                proc.send_signal(signal.SIGTERM)
                sent = True
            time.sleep(0.02)
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    done = sum(e.get("event") == "chunk" for e in journal.read())
    if not sent or proc.returncode != 1 or "preempted at chunk" not in stderr:
        fail(f"{what}: SIGTERM sent {sent}, exit {proc.returncode}, "
             f"{done} chunks journaled: stdout {stdout[-1500:]!r} stderr "
             f"{stderr[-3000:]!r}")
    return done, wall, stderr.strip().splitlines()[-1]


def resumed_driver(argv, what):
    """Run the resume of a driver module (``DRIVER_CMD``) to its end:
    ``(wall seconds, stdout lines)``."""
    t0 = time.perf_counter()
    proc = subprocess.run(DRIVER_CMD + argv, cwd=HERE, capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"{what} exited {proc.returncode}: stdout "
             f"{proc.stdout[-1500:]!r} stderr {proc.stderr[-3000:]!r}")
    return time.perf_counter() - t0, proc.stdout.splitlines()


def npz_digests(path: str) -> dict:
    """The sha256 of every array of an npz, by key."""
    import hashlib

    import numpy as np

    raw = np.load(path, allow_pickle=False)
    return {k: hashlib.sha256(np.ascontiguousarray(raw[k]).tobytes()
                              ).hexdigest() for k in raw.files}


def snapshot_digests(run_dir: str) -> dict:
    """The sha256 of every leaf of a run's log snapshots and of its last
    carry snapshot, by snapshot and leaf."""
    import hashlib

    import numpy as np

    from tpu_aerial_transport_torch.harness import checkpoint
    from tpu_aerial_transport_torch.resilience import recovery

    snaps = list(checkpoint.list_snapshots(run_dir, recovery.LOGS_PREFIX))
    snaps += list(checkpoint.list_snapshots(run_dir,
                                            recovery.CARRY_PREFIX))[-1:]
    out = {}
    for _, path in snaps:
        raw = np.load(path, allow_pickle=False)
        for k in raw.files:
            if k.startswith("leaf_"):
                out[f"{os.path.basename(path)}:{k}"] = hashlib.sha256(
                    np.ascontiguousarray(raw[k]).tobytes()).hexdigest()
    return out


def first_steps_apart(card_npz: str, cpu_npz: str, steps: int) -> dict:
    """The card's log against the CPU's over the first ``steps`` MPC
    steps: max abs state and force errors, and the iteration counts."""
    import numpy as np

    a, b = np.load(card_npz), np.load(cpu_npz)
    states = {k[len("state_"):]: float(np.abs(
        a[k][:steps].astype(np.float64) - b[k][:steps]).max())
        for k in a.files if k.startswith("state_")}
    return {"state_err": states,
            "force_err": float(np.abs(a["f_des_seq"][:steps].astype(
                np.float64) - b["f_des_seq"][:steps]).max()),
            "iters_card": a["iter_seq"][:steps].tolist(),
            "iters_cpu": b["iter_seq"][:steps].tolist(),
            "same_keys": sorted(a.files) == sorted(b.files)}


def spawn_driver_child(run_dir: str):
    """Phase 38's card child: ``(wall seconds, its driver-child record)``."""
    return spawn_child(["--driver-child", run_dir], "phase 38's card child",
                       "driver-child")


def drivers_phase(card, report):
    """Phase 38, the user's drivers on the card (module docstring): (a)
    rqp_forest with each controller, held against the CPU; (b) its chunked
    run preempted by SIGTERM and resumed; (c) fault_injection, its
    checkpointed run preempted and resumed; (d) city_forest; (e)
    convergence_rates against the CPU; (f) replay on (a)'s log; (g) the
    session example's live hub and SLO pass."""
    import shutil

    import numpy as np

    from tpu_aerial_transport_torch.envs import forest as forest_mod
    from tpu_aerial_transport_torch.examples import (
        convergence_rates,
        fault_injection,
        replay,
        rqp_forest,
    )
    from tpu_aerial_transport_torch.obs import export
    from tpu_aerial_transport_torch.resilience import faults

    what = "phase 38"
    t_phase = time.perf_counter()
    out = report["drivers"] = {}
    run_dir = os.path.join(HERE, "build", "drivers")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)

    wall_c, rec = spawn_driver_child(run_dir)
    out["card_child"] = {"wall_s": wall_c, **{k: v for k, v in rec.items()
                                              if k != "fault"}}
    print(f"{what}: the card child ran every driver in {rec['seconds']:.1f} "
          f"s (wall {wall_c:.1f} s); matplotlib on this host: "
          f"{rec['matplotlib']} | {card}", flush=True)

    # (a) rqp_forest against the CPU, its first DRIVER_CPU_STEPS steps.
    body = {"cadmm": "warp_solve", "dd": "warp_solve",
            "centralized": "fused_solve_early"}
    out["rqp"] = {}
    for name, r in rec["rqp"].items():
        cpu_npz = os.path.join(run_dir, f"cpu_{name}.npz")
        _, _, cpu_s = run_driver(rqp_forest.main, rqp_driver_args(
            name, DRIVER_CPU_T, "cpu", cpu_npz) + ["--time-chunk", "0"])
        apart = first_steps_apart(os.path.join(run_dir, f"{name}.npz"),
                                  cpu_npz, DRIVER_CPU_STEPS)
        hits = {k: v for k, v in r["launches"].items()
                if k.startswith(body[name])}
        ok = (r["rc"] == 0 and hits and all(v > 0 for v in hits.values())
              and apart["same_keys"]
              and max(apart["state_err"].values()) <= CPU_STATE_ATOL
              and apart["force_err"] <= CPU_FORCE_ATOL
              and apart["iters_card"] == apart["iters_cpu"])
        out["rqp"][name] = {**r, "vs_cpu": apart, "cpu_seconds": cpu_s,
                            "ok": ok}
        print(f"{what} (a) rqp_forest {name}: " + " | ".join(r["lines"])
              + f" | launches {r['launches']} | first {DRIVER_CPU_STEPS} "
              f"steps against the CPU: max|state err| "
              f"{max(apart['state_err'].values()):.2e} (atol "
              f"{CPU_STATE_ATOL}), max|force err| {apart['force_err']:.2e} "
              f"N (atol {CPU_FORCE_ATOL}), iterations card "
              f"{apart['iters_card']} CPU {apart['iters_cpu']} "
              + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
        if not ok:
            fail(f"{what} (a): rqp_forest {name} (launches "
                 f"{r['launches']}, against the CPU {apart})")
    if rec["matplotlib"]:
        figs = [os.path.join(run_dir, f"{k}_cadmm.png")
                for k in ("tracking", "stats", "xy", "min_dist")]
        if not all(os.path.getsize(f) > 0 for f in figs):
            fail(f"{what} (a): --plots wrote {figs}")
    elif "matplotlib" not in (rec.get("plots_refused") or ""):
        fail(f"{what} (a): --plots without matplotlib was not refused up "
             f"front: {rec.get('plots_refused')!r}")

    # (b) the chunked run: SIGTERM after DRIVER_SIGTERM_AFTER chunks, then
    # --resume in a fresh process, against the uninterrupted run.
    pre_dir = os.path.join(run_dir, "chunk_pre")
    module = PKG + ".examples."
    done, wall_p, msg = preempted_driver([
        module + "rqp_forest", "--controller", "cadmm", "-n", str(DRIVER_N),
        "-T", str(DRIVER_CHUNK_T), "--chunks", str(DRIVER_CHUNKS),
        "--ckpt-dir", pre_dir, "--time-chunk", "0"], pre_dir,
        f"{what} (b) rqp_forest")
    resumed_npz = os.path.join(run_dir, "chunk_resumed.npz")
    wall_r, lines = resumed_driver([
        module + "rqp_forest", "--resume", pre_dir, "--out", resumed_npz,
        "--time-chunk", "0"], f"{what} (b) the resume")
    ref = npz_digests(os.path.join(run_dir, "chunk_full.npz"))
    same = npz_digests(resumed_npz) == ref
    resumed_from = lines_with(lines, "resumed from")
    ok = same and rec["chunked"]["rc"] == 0 and resumed_from == [
        f"resumed from chunk {done}"]
    out["chunked"] = {"chunks_before_sigterm": done, "preempt_wall_s":
                      wall_p, "resume_wall_s": wall_r, "bitwise": same,
                      "message": msg, "launches": rec["chunked"]["launches"]}
    print(f"{what} (b) rqp_forest --chunks {DRIVER_CHUNKS}: SIGTERM after "
          f"{DRIVER_SIGTERM_AFTER} chunks journaled, the driver stopped with "
          f"{msg!r} (wall {wall_p:.2f} s); --resume {resumed_from} (wall "
          f"{wall_r:.2f} s): {len(ref)} log arrays by sha256 bitwise the "
          f"uninterrupted run's: {same} " + ("ok" if ok else "FAIL")
          + f" | {card}", flush=True)
    if not ok:
        fail(f"{what} (b): the resumed chunked run (bitwise {same}, "
             f"{resumed_from})")

    # (c) fault_injection: masks against the CPU's, the killed agent's
    # forces, the checkpointed run preempted and resumed.
    fr = rec["fault"]
    sched = fault_injection.scenarios(DRIVER_N, FAULT_STEPS, "cpu")[
        "30% consensus dropout"]
    cpu_masks = [faults.fault_step(sched, t).msg_ok.tolist()
                 for t in range(FAULT_STEPS)]
    masks_same = fr["masks"] == cpu_masks
    fi_dir = os.path.join(run_dir, "fi_pre")
    done_f, wall_fp, msg_f = preempted_driver([
        module + "fault_injection", "-n", str(DRIVER_N), "--steps",
        str(FAULT_STEPS), "--chunks", str(DRIVER_CHUNKS), "--ckpt-dir",
        fi_dir], fi_dir, f"{what} (c) fault_injection")
    wall_fr, lines_f = resumed_driver([
        module + "fault_injection", "--resume", fi_dir],
        f"{what} (c) the resume")
    ref_f = snapshot_digests(os.path.join(run_dir, "fi_full"))
    same_f = snapshot_digests(fi_dir) == ref_f
    summary_same = ([ln for ln in lines_f if ln.strip()][-6:]
                    == rec["fault_checkpointed"]["summary"][-6:])
    dropped = sum(not m for row in fr["masks"] for m in row)
    ok = (masks_same and fr["killed_after_max_abs"] == 0.0
          and fr["killed_before_min_norm"] > 0 and fr["others_min_norm"] > 0
          and any(k.startswith("warp_solve") for k in fr["launches"])
          and same_f and summary_same and dropped > 0)
    out["fault"] = {k: v for k, v in fr.items() if k != "masks"}
    out["fault"].update(masks_bitwise=masks_same, dropped=dropped,
                        chunks_before_sigterm=done_f, snapshots_bitwise=same_f,
                        preempt_wall_s=wall_fp, resume_wall_s=wall_fr,
                        ok=ok)
    print(f"{what} (c) fault_injection n = {DRIVER_N}, {FAULT_STEPS} steps "
          f"({fr['seconds']:.1f} s): rungs {fr['rungs']}, quarantined "
          f"{fr['quarantined']}; the killed agent's max|f| after step "
          f"{FAULT_STEPS // 2}: {fr['killed_after_max_abs']} (its min|f| "
          f"before {fr['killed_before_min_norm']:.3f} N); dropout masks "
          f"({dropped} of {FAULT_STEPS * DRIVER_N} dropped) bitwise the "
          f"CPU's: {masks_same}; launches {fr['launches']} | checkpointed: "
          f"SIGTERM after {done_f} chunks, {msg_f!r}, resumed (wall "
          f"{wall_fr:.2f} s): {len(ref_f)} snapshot leaves by sha256 bitwise "
          f"the uninterrupted run's: {same_f}, summary equal: {summary_same} "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    if not ok:
        fail(f"{what} (c): fault_injection ({out['fault']})")

    # (d) city_forest.
    cr = rec["city"]
    ok = (cr["env_query"] == "bucketed"
          and any("-> bucketed" in ln for ln in cr["lines"])
          and cr["telemetry"] == cr["recount"]
          and any(k.startswith("warp_solve") for k in cr["launches"]))
    out["city"] = {**cr, "ok": ok}
    print(f"{what} (d) city_forest: " + " | ".join(cr["lines"])
          + f" | telemetry {cr['telemetry']} = host recount from the logs: "
          f"{cr['telemetry'] == cr['recount']} | {cr['steps_per_s']:.2f} MPC "
          f"steps/s | launches {cr['launches']} "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    if not ok:
        fail(f"{what} (d): city_forest ({cr})")

    # (e) convergence_rates: the card's curves against the CPU's.
    cpu_curves, _, cpu_s = run_driver(convergence_rates.main, [
        "--samples", str(CONV_SAMPLES), "--iters", str(CONV_ITERS),
        "--out", "", "--device", "cpu"])
    card_curves = np.load(os.path.join(run_dir, "conv_card.npz"))
    errs = {}
    for label, c in cpu_curves.items():
        g = card_curves[label]
        both = np.isfinite(g) & np.isfinite(c)
        errs[label] = (float(np.abs(g[both] - c[both]).max())
                       if (np.isfinite(g) == np.isfinite(c)).all()
                       else math.inf)
    ab = rec["conv_ab"]["summary"]
    ok = (max(errs.values()) <= CONV_BAR
          and all(any(k.startswith("warp_solve") for k in rec[r]["launches"])
                  for r in ("conv", "conv_ab"))
          and len(ab) == 4)
    out["conv"] = {"card": rec["conv"], "ab": rec["conv_ab"],
                   "max_abs_err": errs, "cpu_seconds": cpu_s, "ok": ok}
    print(f"{what} (e) convergence_rates, {CONV_SAMPLES} samples x "
          f"{CONV_ITERS} iterations ({rec['conv']['seconds']:.2f} s): "
          + " | ".join(rec["conv"]["lines"]) + f" | every sample's curve "
          f"against the CPU's, max|err| {errs} N (bar {CONV_BAR}) | effort "
          f"A/B ({rec['conv_ab']['seconds']:.2f} s): "
          + ", ".join(f"{k} iters mean {v['iters_mean']:.2f}"
                      for k, v in ab.items())
          + f" | launches {rec['conv']['launches']}, "
          f"{rec['conv_ab']['launches']} " + ("ok" if ok else "FAIL")
          + f" | {card}", flush=True)
    if not ok:
        fail(f"{what} (e): convergence_rates ({errs})")

    # (f) replay on (a)'s C-ADMM log.
    card_npz = os.path.join(run_dir, "cadmm.npz")
    log = replay.load_log(card_npz)
    world = forest_mod.forest_from_tree_pos(log["tree_pos"],
                                            log["num_trees"], device="cuda")
    seed0 = forest_mod.make_forest(seed=0, device="cuda")
    num = int(log["num_trees"])
    forest_same = bool((world.tree_pos[:num] == seed0.tree_pos[:num]).all())
    layout_same = (sorted(log) == sorted(replay.load_log(
        os.path.join(run_dir, "cpu_cadmm.npz"))) and log["n"] == DRIVER_N
        and log["state_seq"]["xl"].shape[0] == int(round(DRIVER_T * 100)))
    replay_dir = os.path.join(run_dir, "replay")
    if rec["matplotlib"]:
        res, _, replay_s = run_driver(replay.main, [
            card_npz, "--outdir", replay_dir, "--device", "cuda"])
        files = res["frames"] + [res["ghosts"]] + [
            os.path.join(replay_dir, f"{k}_cadmm.png")
            for k in ("xy", "min_dist")]
        drawn = all(os.path.getsize(f) > 0 for f in files)
        note = f"{len(res['frames'])} frames, the ghosts and the figures " \
               f"written ({replay_s:.1f} s)"
    else:
        try:
            replay.main([card_npz, "--outdir", replay_dir, "--device",
                         "cuda"])
            refused = ""
        except SystemExit as e:
            refused = str(e)
        drawn = "matplotlib" in refused
        note = ("not drawn: matplotlib is not installed on this host, and "
                f"replay refused up front ({refused!r})")
    ok = forest_same and layout_same and drawn
    out["replay"] = {"forest_bitwise": forest_same,
                     "layout_same": layout_same, "note": note, "ok": ok}
    print(f"{what} (f) replay of (a)'s C-ADMM log: read back with the CPU "
          f"log's layout: {layout_same}; the forest rebuilt from the logged "
          f"trees bitwise the seed-0 forest: {forest_same}; {note} "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    if not ok:
        fail(f"{what} (f): replay ({out['replay']})")

    # (g) the session example: the hub against a recount from the journal.
    sr = rec["sessions"]
    summary = sr["summary"]
    events = export.read_events(sr["metrics"])
    counters = summary["hub"]["counters"]

    def hub(name):
        pre = name + "{"
        return {k[len(pre):-1]: v for k, v in counters.items()
                if k.startswith(pre)}

    def recount(event, key, kind=None):
        got = {}
        for e in events:
            if e.get("event") == event and (kind is None
                                             or e.get("kind") == kind):
                got[e.get(key)] = got.get(e.get(key), 0) + 1
        return got

    checks = {
        "queue.submitted": hub("queue.submitted") == recount(
            "serving_event", "tenant", "submitted"),
        "queue.dequeued": hub("queue.dequeued") == recount(
            "serving_event", "family", "admitted"),
        "serving.events": hub("serving.events") == recount(
            "serving_event", "kind"),
        "session.events": hub("session.events") == recount(
            "session_event", "kind"),
    }
    ok = (sr["rc"] == 0 and all(checks.values())
          and summary.get("slo_firing") == [] and summary.get(
              "slo_alerts") == 0
          and not summary["offline_check"]["mismatches"]
          and any(k.startswith("warp_solve") for k in sr["launches"]))
    out["sessions"] = {"checks": checks, "slo_firing":
                       summary.get("slo_firing"), "slo_alerts":
                       summary.get("slo_alerts"), "wall_s": sr["seconds"],
                       "launches": sr["launches"], "ok": ok}
    print(f"{what} (g) serve_sessions with the live hub "
          f"({sr['seconds']:.2f} s): hub counters equal to a recount from "
          f"the journal: {checks}; queue.submitted {hub('queue.submitted')}, "
          f"per family {hub('queue.dequeued')}; SLO pass: firing "
          f"{summary.get('slo_firing')}, alerts {summary.get('slo_alerts')};"
          f" offline check {summary['offline_check']['checked']} steps, "
          f"mismatches {summary['offline_check']['mismatches']}; launches "
          f"{sr['launches']} " + ("ok" if ok else "FAIL") + f" | {card}",
          flush=True)
    if not ok:
        fail(f"{what} (g): the session example's hub ({out['sessions']})")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"{what}: {out['seconds']:.1f} s | {card}", flush=True)
    return {f"{k}": v["launches"] for k, v in rec["rqp"].items()}


def fleet_args(out_dir: str, chaos: str = ""):
    """Phase 39's harness arguments (``fleet_local.build_parser``)."""
    from tpu_aerial_transport_torch.examples.serve_fleet import DEMO_TENANTS
    from tpu_aerial_transport_torch.tools import fleet_local

    return fleet_local.build_parser().parse_args([
        "--device", "cuda", "--replicas", str(FLEET_REPLICAS),
        "--requests", str(FLEET_REQUESTS), "--seed", str(FLEET_SEED),
        "--families", FLEET_FAMILIES, "--buckets", FLEET_BUCKETS,
        "--tenants", DEMO_TENANTS,
        "--out-dir", out_dir, "--results", out_dir + ".json",
        "--timeout", "300",
    ] + (["--chaos", chaos] if chaos else []))


def fleet_run(out_dir: str, what: str, chaos: str = ""):
    """One ``run_fleet`` on the card: ``(summary, results, merged
    events)``; fails the phase unless it ended ok with every request
    resolved exactly once (completed or rejected, nothing failed)."""
    from tpu_aerial_transport_torch.obs import export
    from tpu_aerial_transport_torch.tools import fleet_local

    summary, rc = fleet_local.run_fleet(fleet_args(out_dir, chaos))
    with open(out_dir + ".json") as fh:
        results = json.load(fh)
    statuses = {}
    for row in results.values():
        statuses[row["status"]] = statuses.get(row["status"], 0) + 1
    if (rc or not summary["ok"] or summary["unresolved"]
            or len(results) != FLEET_REQUESTS
            or summary["requests"] != FLEET_REQUESTS
            or set(statuses) - {"completed", "rejected"}
            or summary.get("completed", 0) + summary.get("rejected", 0)
            != FLEET_REQUESTS):
        fail(f"phase 39 {what}: rc {rc}, statuses {statuses}, summary "
             f"{json.dumps(summary)[:3000]}")
    return summary, results, export.read_events(summary["metrics"])


def fleet_replica_checks(summary, results, what):
    """Every replica process on the card with every chunk on the card's
    rung and zero guard fallbacks and failed chunks (from its last
    heartbeat), every completed result from a replica on the card;
    returns the kernel launches the replicas counted, summed by body."""
    launches = {}
    for rid, procs in summary["processes"].items():
        for p in procs:
            if not p["heartbeats"]:
                fail(f"phase 39 {what}: r{rid} pid {p['pid']} never "
                     f"heartbeated ({summary['exits']})")
            if (p.get("device") != "cuda" or p.get("guard_fallbacks")
                    or p.get("backend_failures")
                    or set(p.get("dispatch_rungs", {})) - {"on-chip"}):
                fail(f"phase 39 {what}: r{rid} pid {p['pid']}: {p}")
            for k, v in p.get("launches", {}).items():
                launches[k] = launches.get(k, 0) + v
    off = [rid for rid, row in results.items()
           if row["status"] == "completed" and row.get("device") != "cuda"]
    if off:
        fail(f"phase 39 {what}: results not from the card: {off[:5]}")
    return launches


def fleet_chunk_ms(events):
    """Each replica's chunk dispatch ms by family from a fleet run's
    trace rows: its first chunk (the family's program built and its
    substeps captured in that process) and the p50 of the rest."""
    import numpy as np

    from tpu_aerial_transport_torch.obs import trace

    by = {}
    for r in trace.trace_rows(events):
        if r["name"] == trace.CHUNK_DISPATCH and "t1_mono" in r:
            by.setdefault(f"{r['track']}:{r['attrs']['family']}", []).append(
                (r["t0_mono"], (r["t1_mono"] - r["t0_mono"]) * 1e3))
    out = {}
    for k, v in sorted(by.items()):
        ms = [m for _, m in sorted(v)]
        out[k] = {"n": len(ms), "first": ms[0],
                  "rest_p50": float(np.median(ms[1:])) if ms[1:] else None}
    return out


def fleet_phase(card, report):
    """Phase 39, the serving fleet on the card (module docstring)."""
    import torch

    from tpu_aerial_transport_torch.examples.serve_fleet import DEMO_TENANTS
    from tpu_aerial_transport_torch.obs import export, trace
    from tpu_aerial_transport_torch.serving import batcher, fleet
    from tpu_aerial_transport_torch.serving import server as server_mod
    from tpu_aerial_transport_torch.tools import fleet_local

    t_phase = time.perf_counter()
    out = report["fleet"] = {}
    torch.cuda.empty_cache()
    root = os.path.join(HERE, "build", "fleet_run")

    # (a) Fault-free.
    base, base_res, base_ev = fleet_run(os.path.join(root, "fault_free"),
                                        "fault-free")
    launches = fleet_replica_checks(base, base_res, "fault-free")
    warp = sum(v for k, v in launches.items() if k.startswith("warp_"))
    block = sum(v for k, v in launches.items()
                if k.startswith("fused_solve"))
    if not (warp and block):
        fail(f"phase 39: the replicas' whole-solve launches {launches}: "
             "the warp body (cadmm4) and the block body (centralized4) "
             "must both launch")
    boot = {r: [p["boot_s"] for p in ps]
            for r, ps in base["processes"].items()}
    rps = base["completed"] / base["serve_s"]
    print(f"fleet (a) fault-free: {FLEET_REPLICAS} replicas on the card, "
          f"{FLEET_REQUESTS} requests ({base['completed']} completed, "
          f"{base.get('rejected', 0)} rejected by the tenants' admission) "
          f"in {base['serve_s']:.3f} s = {rps:.2f} completed requests/s, "
          f"{FLEET_REQUESTS / base['serve_s']:.2f} resolved/s; replica boot"
          f" s {boot}; whole-solve launches in the replicas {launches}; "
          f"wall {base['wall_s']:.2f} s | {card}", flush=True)
    chunks = fleet_chunk_ms(base_ev)
    print(f"  chunk dispatch ms by replica:family (first chunk, p50 of the "
          f"rest): " + "; ".join(
              f"{k} n={v['n']} {v['first']:.1f}, "
              + ("-" if v["rest_p50"] is None else f"{v['rest_p50']:.1f}")
              for k, v in chunks.items()), flush=True)
    out["fault_free"] = {
        "serve_s": base["serve_s"], "wall_s": base["wall_s"],
        "completed": base["completed"], "rejected": base.get("rejected", 0),
        "completed_per_s": rps, "boot_s": boot, "launches": launches,
        "processes": base["processes"], "chunk_ms": chunks,
    }

    # (b) The storm.
    storm_dir = os.path.join(root, "storm")
    storm, storm_res, events = fleet_run(storm_dir, "storm", FLEET_CHAOS)
    storm_launches = fleet_replica_checks(storm, storm_res, "storm")
    if set(storm_res) != set(base_res):
        fail("phase 39 (b): the storm resolved other requests")
    apart = [rid for rid in base_res
             if (base_res[rid]["status"], base_res[rid].get("digest"))
             != (storm_res[rid]["status"], storm_res[rid].get("digest"))]
    if apart:
        fail(f"phase 39 (b): {len(apart)} results differ from the "
             f"fault-free run's: {apart[:5]}")
    failed_over = {e["request_id"]: e for e in events
                   if e.get("event") == "fleet_event"
                   and e.get("kind") == "failover"}
    killed = storm["processes"]["1"]
    restarts = [e for e in events if e.get("event") == "fleet_event"
                and e.get("kind") == "restart" and e.get("replica") == 1]
    if not failed_over or any(e["from_replica"] != "1"
                              for e in failed_over.values()):
        fail(f"phase 39 (b): failovers {list(failed_over.values())[:3]}: "
             "the killed replica's requests must fail over")
    if (len(killed) < 2 or killed[0]["rc"] != -9 or not restarts
            or killed[-1]["rc"] != 0 or killed[-1]["boot_s"] is None
            or not killed[-1]["final"]):
        fail(f"phase 39 (b): r1's processes {killed}, restarts {restarts}:"
             " the killed replica must respawn, boot and exit cleanly")
    # The retry segment on each failed-over request's original trace,
    # on the timeline of the replica whose result counted.
    rows = trace.trace_rows(events)
    retry = {}
    for rid, e in sorted(failed_over.items()):
        winner = storm_res[rid].get("replica")
        if winner == 1 or storm_res[rid]["status"] != "completed":
            continue  # served by r1 before it died.
        cp = trace.critical_path(trace.stitch(
            [r for r in rows if r.get("track") in ("front", f"r{winner}")]))
        segs = [q["segments"]["retry"] for q in cp["requests"]
                if q["trace_id"] == e["trace_id"]]
        retry[rid] = segs[0] if segs else 0.0
    if not retry or min(retry.values()) <= 0:
        fail(f"phase 39 (b): retry segments {retry}")
    # Latencies: the kill to its detection (the first failover) and to
    # the last failed-over request's completion at the front.
    kill_ts = next(f["ts"] for f in storm["faults_fired"]
                   if f["fault"].startswith("sigkill"))
    done_ts = {e["request_id"]: e["ts"] for e in export.read_events(
        os.path.join(storm_dir, "front.metrics.jsonl"))
        if e.get("event") == "serving_event"
        and e.get("kind") == "completed"}
    detect_s = min(e["ts"] for e in failed_over.values()) - kill_ts
    reserve_s = max(done_ts[rid] for rid in retry) - kill_ts
    redispatch_ms = [1e3 * e["latency_s"] for e in failed_over.values()]
    sboot = {r: [p["boot_s"] for p in ps]
             for r, ps in storm["processes"].items()}
    health = sorted({(e["replica"], e["from_state"], e["to_state"])
                     for e in events if e.get("kind") == "transition"})
    print(f"fleet (b) storm {FLEET_CHAOS}: fired at "
          f"{[(f['fault'], f['t_s']) for f in storm['faults_fired']]} s "
          f"after every replica was ready; {len(failed_over)} requests "
          f"failed over off r1 on their trace ids, {len(retry)} re-served "
          f"elsewhere with a retry segment (min {min(retry.values()):.3f} "
          f"s); all {FLEET_REQUESTS} statuses and "
          f"{storm['completed']} digests equal to the fault-free run's; "
          f"{storm['duplicates_dropped']} duplicate results dropped; "
          f"kill -> detection {detect_s:.3f} s, re-dispatch "
          f"{max(redispatch_ms):.3f} ms at most, kill -> last re-served "
          f"completion {reserve_s:.3f} s; served in {storm['serve_s']:.3f}"
          f" s ({storm['completed'] / storm['serve_s']:.2f} completed "
          f"requests/s); r1 respawned, boot s {sboot}; transitions "
          f"{health}; 0 guard fallbacks; launches {storm_launches} | "
          f"{card}", flush=True)
    storm_chunks = fleet_chunk_ms(events)
    print(f"  chunk dispatch ms by replica:family (first chunk, p50 of the "
          f"rest): " + "; ".join(
              f"{k} n={v['n']} {v['first']:.1f}, "
              + ("-" if v["rest_p50"] is None else f"{v['rest_p50']:.1f}")
              for k, v in storm_chunks.items()), flush=True)
    out["storm"] = {
        "chaos": FLEET_CHAOS, "fired": storm["faults_fired"],
        "failed_over": len(failed_over), "retry_s": retry,
        "duplicates_dropped": storm["duplicates_dropped"],
        "detect_s": detect_s, "reserve_s": reserve_s,
        "redispatch_ms": redispatch_ms, "serve_s": storm["serve_s"],
        "wall_s": storm["wall_s"], "boot_s": sboot,
        "launches": storm_launches, "processes": storm["processes"],
        "transitions": health, "chunk_ms": storm_chunks,
    }

    # (c) FLEET_CPU_SAMPLES completed requests again, on the card in this
    # process (the fleet's digests) and on the CPU (states 1e-4).
    fams = FLEET_FAMILIES.split(",")
    stream = {r.request_id: r for r in fleet_local.make_fleet_stream(
        FLEET_REQUESTS, fams,
        {f: batcher.CANONICAL_FAMILIES[f].chunk_len for f in fams},
        sorted(fleet_local.parse_tenants(DEMO_TENANTS)), FLEET_SEED)}
    done = sorted(rid for rid, row in base_res.items()
                  if row["status"] == "completed")
    by_fam = {f: [rid for rid in done if stream[rid].family == f]
              for f in fams}
    sample = sorted(by_fam[fams[0]][:FLEET_CPU_SAMPLES // 2]
                    + by_fam[fams[1]][:FLEET_CPU_SAMPLES // 2])
    if len(sample) != FLEET_CPU_SAMPLES:
        fail(f"phase 39 (c): completed requests by family {by_fam}")
    served = {}
    for dev in ("cuda", "cpu"):
        srv = server_mod.ScenarioServer(
            families=fams, buckets=(FLEET_CPU_SAMPLES,), device=dev)
        _, ts = serve_drain(srv, [stream[rid] for rid in sample])
        if any(t.status != "completed" for t in ts):
            fail(f"phase 39 (c): on {dev}: {[t.status for t in ts]}")
        served[dev] = {t.request.request_id: t.result for t in ts}
    digests_equal = sum(fleet.result_digest(served["cuda"][rid])
                        == base_res[rid]["digest"] for rid in sample)
    same, worst = results_apart(served["cuda"], served["cpu"])
    ok = digests_equal == len(sample) and worst <= CPU_STATE_ATOL
    print(f"fleet (c) {len(sample)} sampled requests {sample}: served on "
          f"the card in this process, {digests_equal} digests equal to "
          f"the fleet's; against the CPU max |state diff| {worst:.3e} "
          f"(bar {CPU_STATE_ATOL}), {same} bitwise "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    out["cpu"] = {"sample": sample, "digests_equal": digests_equal,
                  "max_abs": worst, "bitwise": same, "ok": ok}
    if not ok:
        fail("phase 39 (c): sampled requests disagree")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"fleet: phase 39 took {out['phase_s']:.1f} s | {card}",
          flush=True)
    return launches


def pods_args(argv):
    """Phase 40's harness arguments (``pods_local.build_parser``)."""
    from tpu_aerial_transport_torch.tools import pods_local

    return pods_local.build_parser().parse_args(argv + PODS_WORKLOAD)


def pods_spawn(argv, what):
    """One pod through the harness (``pods_local.spawn_pod``): its result,
    every worker ok and on the card; fails the phase otherwise."""
    from tpu_aerial_transport_torch.tools import pods_local

    result, rc, tail = pods_local.spawn_pod(pods_args(argv))
    if rc or not all(w.get("ok") and w["device"] == "cuda"
                     for w in result["workers"]):
        fail(f"phase 40 {what}: rc {rc}: {tail or result}")
    return result


def pods_phase(card, report):
    """Phase 40, scenario sharding across processes on the card (module
    docstring). Returns the workers' launches of the two kernels."""
    import shutil

    import numpy as np

    from tpu_aerial_transport_torch.parallel import pods
    from tpu_aerial_transport_torch.serving import server as server_mod
    from tpu_aerial_transport_torch.serving.queue import ScenarioRequest
    from tpu_aerial_transport_torch.tools import pods_local

    t_phase = time.perf_counter()
    out = report["pods"] = {}
    root = os.path.join(HERE, "build", "pods_run")
    shutil.rmtree(root, ignore_errors=True)

    # (a) Parity: 2 worker processes x 128 scenarios against 1 x 256.
    row = pods_local.parity_report(pods_args([
        "--mode", "parity", "--processes", "2", "--local-devices", "2",
        "--steps", str(PODS_STEPS), "--out-dir",
        os.path.join(root, "parity")]))
    if "error" in row or not (row["parity_ok"] and row["residuals_equal"]):
        fail(f"phase 40 (a): {json.dumps(row)[:3000]}")
    workers = row["workers"]["multi"]
    per_worker = [{k: w["launches"].get(k, 0)
                   for k in ("warp_solve_kernel", "ring_sum")}
                  for w in workers]
    if len(per_worker) != 2 or any(v <= 0 for w in per_worker
                                   for v in w.values()):
        fail(f"phase 40 (a): the workers' launches {per_worker}: each must "
             "launch warp_solve_kernel and ring_sum")
    if any(w["device"] != "cuda" for w in workers + row["workers"]["single"]):
        fail(f"phase 40 (a): a worker off the card: {row['workers']}")
    launches = {k: sum(w[k] for w in per_worker)
                for k in ("warp_solve_kernel", "ring_sum")}
    print(f"pods (a) parity: 2 processes x {N_SCENARIOS // 2} scenarios "
          f"(mesh {row['multi']}) against 1 x {N_SCENARIOS} (mesh "
          f"{row['single']}), {PODS_STEPS} steps + the masked step: max "
          f"diffs {row['max_diffs']} (bar {row['atol']}), residuals equal "
          f"exactly; launches by worker {per_worker}, the single process "
          f"{row['workers']['single'][0]['launches']}; boot s "
          f"{[w['boot_s'] for w in workers]}, spawn to result s "
          f"{row['spawn_to_result_s']} | {card}", flush=True)
    out["parity"] = {k: row[k] for k in (
        "max_diffs", "residuals_equal", "multi", "single",
        "spawn_to_result_s")}
    out["parity"]["launches"] = per_worker

    # (b) The first PODS_CPU scenarios' masked step against the CPU.
    dig = np.load(os.path.join(row["out_dirs"]["multi"], "parity.npz"))
    f_c, stats_c, _ = pods.masked_step(
        pods.make_pods_mesh(pods.PodsSpec(2, 2, 1), device="cpu"),
        n=N_AGENTS, n_scenarios=PODS_CPU, max_iter=20, inner_iters=20,
        consensus_impl="pallas_ring")
    f_err = float(np.abs(dig["f_masked"][:PODS_CPU] - f_c.numpy()).max())
    counts_equal = bool(np.array_equal(dig["iters_masked"][:PODS_CPU],
                                       stats_c.iters.numpy()))
    ok = f_err <= CPU_FORCE_ATOL and counts_equal
    print(f"pods (b) the masked step's first {PODS_CPU} scenarios against "
          f"the CPU: max |f diff| {f_err:.3e} N (bar {CPU_FORCE_ATOL}), "
          f"consensus counts equal {counts_equal} "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    out["cpu"] = {"max_abs_force": f_err, "counts_equal": counts_equal}
    if not ok:
        fail("phase 40 (b): the card and the CPU disagree")

    # (c) Preempted at boundary 1, resumed with the trace, against the
    # uninterrupted run, by per-leaf sha256 of each process's slab.
    resume = ["--mode", "resume", "--processes", "2", "--local-devices",
              "2", "--steps", str(PODS_RESUME_STEPS), "--chunks",
              str(PODS_CHUNKS)]
    run_dir = os.path.join(root, "resume")
    trace_path = os.path.join(root, "resume.trace.json")
    pre = pods_spawn(resume + ["--out-dir", run_dir, "--stop-after-chunk",
                               "1"], "(c) preempt")
    res = pods_spawn(resume + ["--out-dir", run_dir, "--resume", "--trace",
                               trace_path], "(c) resume")
    trace = pods_local.stitch_trace(run_dir, trace_path)
    ref = pods_spawn(resume + ["--out-dir", os.path.join(root, "ref")],
                     "(c) uninterrupted")
    slabs_equal = [a["leaf_sha256"] == b["leaf_sha256"]
                   for a, b in zip(res["workers"], ref["workers"])]
    ok = (all(w["status"] == "preempted" and w["chunks_done"] == 1
              for w in pre["workers"])
          and all(w["status"] == "done" and w["resumed_from_chunk"] == 1
                  for w in res["workers"])
          and all(w["status"] == "done" for w in ref["workers"])
          and slabs_equal == [True, True]
          and trace["tracks"] == ["p0of2", "p1of2"])
    print(f"pods (c) resume: 2 processes x {N_SCENARIOS // 2} scenarios, "
          f"{PODS_RESUME_STEPS} steps in {PODS_CHUNKS} chunks, preempted "
          f"at boundary 1 and resumed: slabs bitwise the uninterrupted "
          f"run's by sha256 {slabs_equal}; trace {trace['spans']} spans on "
          f"tracks {trace['tracks']}; spawn to result s "
          f"{pre['spawn_to_result_s']:.2f}, {res['spawn_to_result_s']:.2f},"
          f" {ref['spawn_to_result_s']:.2f} "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    out["resume"] = {"slabs_equal": slabs_equal, "trace": trace}
    if not ok:
        fail(f"phase 40 (c): {pre['workers']} {res['workers']} "
             f"{ref['workers']} {trace}")

    # (d) Rate: 2 processes x 128 against 1 x 256, in turns (2, 1, 1, 2).
    arms = {2: ["--processes", "2", "--local-devices", "2"],
            1: ["--processes", "1", "--local-devices", "4"]}
    rates, boots, walls = {2: [], 1: []}, {2: [], 1: []}, {2: [], 1: []}
    for procs in (2, 1, 1, 2):
        r = pods_spawn(["--mode", "bench", "--mesh", "2x2", "--steps",
                        str(PODS_BENCH_STEPS), "--reps",
                        str(PODS_BENCH_REPS)] + arms[procs],
                       f"(d) {procs} processes")
        rates[procs].append(r["scenario_mpc_steps_per_sec"])
        boots[procs].append([w["boot_s"] for w in r["workers"]])
        walls[procs].append(r["spawn_to_result_s"])
    print(f"pods (d) rate, {N_SCENARIOS} scenarios x {PODS_BENCH_STEPS} "
          f"steps (median of {PODS_BENCH_REPS}, after a warm-up), in turns "
          f"2, 1, 1, 2: scenario-MPC-steps/s 2 x {N_SCENARIOS // 2} "
          f"{rates[2]}, 1 x {N_SCENARIOS} {rates[1]}; worker boot s "
          f"{boots}; spawn to result s {walls} | {card}", flush=True)
    out["rate"] = {"scenario_mpc_steps_per_s": rates, "boot_s": boots,
                   "spawn_to_result_s": walls}

    # (e) Serving on a 1-process 2x2 mesh, bitwise the meshless server.
    rng = np.random.default_rng(0)
    stream = [ScenarioRequest(
        family="cadmm4", horizon=2 * int(rng.integers(1, 4)),
        x0=tuple(float(v) for v in rng.normal(0.0, 1.0, 3)),
        v0=tuple(float(v) for v in rng.normal(0.0, 0.2, 3)),
        request_id=f"p{i:02d}") for i in range(PODS_SERVE_REQUESTS)]
    served = {}
    for name, mesh in (("meshless", None), ("mesh", pods.make_pods_mesh(
            pods.PodsSpec(2, 2, 1), device="cuda"))):
        srv = server_mod.ScenarioServer(
            families=("cadmm4",), buckets=(4, 8), mesh=mesh, device="cuda")
        wall, ts = serve_drain(srv, stream)
        if (any(t.status != "completed" for t in ts)
                or set(srv.stats()["dispatch_rungs"]) != {"on-chip"}):
            fail(f"phase 40 (e) {name}: {[t.status for t in ts]}, "
                 f"{srv.stats()}")
        served[name] = {t.request.request_id: t.result for t in ts}
        out.setdefault("serve_s", {})[name] = wall
    same, worst = results_apart(served["mesh"], served["meshless"])
    print(f"pods (e) ScenarioServer(mesh=1-process 2x2) on the card: "
          f"{same} of {PODS_SERVE_REQUESTS} results bitwise the meshless "
          f"server's (max |diff| {worst:.3e}); served in "
          f"{out['serve_s']['mesh']:.3f} s and "
          f"{out['serve_s']['meshless']:.3f} s | {card}", flush=True)
    out["serve_bitwise"] = same
    if same != PODS_SERVE_REQUESTS:
        fail("phase 40 (e): the mesh server's results differ")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"pods: phase 40 took {out['phase_s']:.1f} s | {card}", flush=True)
    return launches


def run_module(module: str, argv: list, what: str, build_dir=None,
               expect_rc: int = 0):
    """``python -m <module> argv`` in a fresh process from the repo root,
    with ``TAT_TORCH_BUILD_DIR=build_dir`` when given: ``(wall seconds,
    its last stdout line as JSON, stderr)``. Fails the phase on another
    exit code, or on a result line."""
    env = dict(os.environ)
    if build_dir is not None:
        env["TAT_TORCH_BUILD_DIR"] = build_dir
    t0 = time.perf_counter()
    proc = subprocess.run(DRIVER_CMD + [module] + argv, capture_output=True,
                          text=True, timeout=300, cwd=HERE, env=env)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != expect_rc or not lines or any(
            '"ok"' in line for line in lines):
        fail(f"{what}: exited {proc.returncode}: stdout "
             f"{proc.stdout[-2000:]!r} stderr {proc.stderr[-4000:]!r}")
    return wall, json.loads(lines[-1]), proc.stderr


def aot_rows(path):
    """The ``aot_serve`` rows of a metrics file."""
    from tpu_aerial_transport_torch.obs import export

    return [e for e in export.read_events(path) if e["event"] == "aot_serve"]


def bundle_phase(card, report):
    """Phase 41, bundled serving (module docstring). Returns the launches
    of the bundled path's kernels, counted by the processes that made
    them (each starts at 0): the serving child's and the probe child's."""
    import shutil

    import torch

    from tpu_aerial_transport_torch.aot import bundle as bundle_mod
    from tpu_aerial_transport_torch.examples import serve_scenarios
    from tpu_aerial_transport_torch.ops import _build
    from tpu_aerial_transport_torch.resilience import backend
    from tpu_aerial_transport_torch.serving import batcher
    from tpu_aerial_transport_torch.serving import server as server_mod
    from tpu_aerial_transport_torch.serving.fleet import result_digest

    t_phase = time.perf_counter()
    out = report["bundle"] = {}
    root = os.path.join(HERE, "build", "aot_run")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def empty_dir(name):
        path = os.path.join(root, name)
        os.makedirs(path)
        return path

    # (a) The bundle, built on the card.
    bdir = os.path.join(root, "bundle")
    t0 = time.perf_counter()
    manifest = bundle_mod.build_bundle(bdir, names=list(BUNDLE_ENTRIES),
                                       batch_buckets=BUNDLE_BUCKETS,
                                       device="cuda")
    build_s = time.perf_counter() - t0
    libs = {n: k["digest"] for n, k in manifest["kernels"].items()}
    recorded = {name: sorted({lib for v in e["variants"]
                              for lib in v["kernels"]})
                for name, e in manifest["entries"].items()}
    want = {n: ["fused_solve"] for n in BUNDLE_ENTRIES[:2]}
    want.update({n: [] for n in BUNDLE_ENTRIES[2:]})
    want[bundle_mod.PROBE_ENTRY] = ["ring_sum"]
    ok = (libs == {n: _build.source_digest(n) for n in _build.KERNELS}
          and recorded == want and manifest["platform"] == "cuda"
          and manifest["fingerprint"]["capability"] is not None)
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _, fs in os.walk(bdir) for f in fs)
    print(f"bundle (a) built on the card in {build_s:.3f} s: "
          f"{len(manifest['entries'])} entries, "
          f"{sum(len(e['variants']) for e in manifest['entries'].values())} "
          f"variants at buckets {BUNDLE_BUCKETS}, libraries {libs}, "
          f"{size} B; kernels by entry {recorded}; fingerprint "
          f"{manifest['fingerprint']}, nvcc {manifest['nvcc']!r} "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    out["build"] = {"build_s": build_s, "bytes": size, "kernels": recorded,
                    "fingerprint": manifest["fingerprint"]}
    if not ok:
        fail(f"phase 41 (a): libraries {libs}, kernels {recorded}")

    # (b) A fresh process with an empty build directory serves the stream
    # from the bundle; the same stream served eagerly here.
    example = PKG + ".examples.serve_scenarios"
    families = ["cadmm4", "centralized4"]
    metrics = os.path.join(root, "bundled.jsonl")
    results = os.path.join(root, "bundled.json")
    b_build = empty_dir("build_b")
    wall, summary, _ = run_module(example, [
        "--requests", str(BUNDLE_REQUESTS), "--families", ",".join(families),
        "--buckets", ",".join(map(str, BUNDLE_BUCKETS)), "--seed",
        str(BUNDLE_SEED), "--bundle", bdir, "--require-bundle",
        "--expect-zero-compile", "--device", "cuda", "--metrics", metrics,
        "--results", results], "phase 41 (b) the bundled child", b_build)
    with open(results) as fh:
        served = json.load(fh)
    rungs = sorted({r["rung"] for r in aot_rows(metrics)})
    launches = summary["kernel_launches"]
    installed = sorted(os.listdir(b_build))
    stream = serve_scenarios.make_stream(
        BUNDLE_REQUESTS, families,
        {f: batcher.CANONICAL_FAMILIES[f].chunk_len for f in families},
        BUNDLE_SEED, None)
    eager_srv = server_mod.ScenarioServer(
        families=families, buckets=BUNDLE_BUCKETS, device="cuda")
    eager_s, tickets = serve_drain(eager_srv, stream)
    eager = {t.request.request_id: t for t in tickets}
    same = sum(served[rid].get("digest") == result_digest(t.result)
               for rid, t in eager.items() if t.result is not None)

    # (c) and (d), two children at once (nothing of theirs is timed),
    # while this process serves (b)'s samples on the CPU.
    stale = os.path.join(root, "stale")
    shutil.copytree(bdir, stale)
    path = os.path.join(stale, bundle_mod.MANIFEST_NAME)
    with open(path) as fh:
        m = json.load(fh)
    m["fingerprint"]["torch"] = "0.0.0+stale"
    with open(path, "w") as fh:
        json.dump(m, fh)
    d_metrics = os.path.join(root, "stale.jsonl")
    notes, info = [], {}
    c_env = {**os.environ, "TAT_TORCH_BUILD_DIR": empty_dir("build_c")}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        c_job = pool.submit(backend.probe_subprocess, timeout_s=120,
                            bundle_dir=bdir, notes=notes, info=info,
                            device="cuda", env=c_env)
        d_job = pool.submit(run_module, example, [
            "--requests", str(BUNDLE_STALE_REQUESTS), "--families",
            "cadmm4", "--buckets", ",".join(map(str, BUNDLE_BUCKETS)),
            "--seed", str(BUNDLE_SEED), "--bundle", stale, "--device",
            "cuda", "--metrics", d_metrics],
            "phase 41 (d) the stale child", _build.build_dir())
        sample = sorted(eager)[:BUNDLE_CPU_SAMPLES]
        cpu_srv = server_mod.ScenarioServer(
            families=families, buckets=BUNDLE_BUCKETS, device="cpu")
        _, cpu_tickets = serve_drain(cpu_srv, [r for r in stream
                                               if r.request_id in sample])
        n_same, worst = results_apart(
            {rid: eager[rid].result for rid in sample},
            {t.request.request_id: t.result for t in cpu_tickets})
        ok_probe, detail = c_job.result()
        _, d_summary, _ = d_job.result()
    ok = (summary["completed"] == BUNDLE_REQUESTS
          and summary["nvcc_builds"] == 0 and rungs == ["bundle_exec"]
          and launches.get("warp_solve_kernel", 0) > 0
          and launches.get("fused_solve_early_kernel", 0) > 0
          and installed == sorted(os.path.basename(_build.library_path(n))
                                  for n in _build.KERNELS)
          and same == BUNDLE_REQUESTS and worst <= CPU_STATE_ATOL
          and all(t.status == "completed" for t in cpu_tickets))
    print(f"bundle (b) a fresh process, empty build directory: "
          f"{summary['completed']} of {BUNDLE_REQUESTS} requests served "
          f"from the bundle in {summary['wall_s']} s ({wall:.2f} s spawn to "
          f"exit), nvcc builds {summary['nvcc_builds']}, aot_serve rungs "
          f"{rungs}, kernel launches {launches}, graph captures "
          f"{summary['graph_captures']} ({summary['graph_capture_s']:.3f} s),"
          f" installed {installed}; {same} of {BUNDLE_REQUESTS} digests "
          f"equal to the eager serve here ({eager_s:.3f} s); {sample} "
          f"against the CPU: max |state diff| {worst:.3e} (bar "
          f"{CPU_STATE_ATOL}), {n_same} bitwise "
          + ("ok" if ok else "FAIL") + f" | {card}", flush=True)
    out["serve"] = {"summary": summary, "wall_s": wall, "rungs": rungs,
                    "digests_equal": same, "eager_s": eager_s,
                    "cpu_max_abs": worst, "installed": installed}
    if not ok:
        fail(f"phase 41 (b): {json.dumps(summary)[:3000]}")

    probe = info.get("probe", {})
    ok = (ok_probe and notes == ["bundle"] and probe.get("ring_sum") == 1
          and probe.get("nvcc_builds") == 0)
    print(f"bundle (c) probe_subprocess(bundle_dir=), empty build "
          f"directory: {ok_probe} {detail}, notes {notes}, child {probe} "
          f"(its ring sum equal to x.sum(0) in every row, or the probe "
          f"would fail) " + ("ok" if ok else "FAIL")
          + f" | {card}", flush=True)
    out["probe"] = {"detail": detail, "notes": notes, "child": probe}
    if not ok:
        fail(f"phase 41 (c): {ok_probe} {detail} {notes} {info}")

    d_rows = aot_rows(d_metrics)
    d_rungs = sorted({r["rung"] for r in d_rows})
    d_tried = sorted({tuple(r.get("tried", ())) for r in d_rows})
    try:
        server_mod.ScenarioServer(families=["cadmm4"], device="cuda",
                                  bundle=stale, require_bundle=True)
        refusal = None
    except bundle_mod.BundleError as e:
        refusal = e
    ok = (d_summary["completed"] == BUNDLE_STALE_REQUESTS
          and d_rungs == ["eager_cached"]
          and d_tried == [("bundle[bundle_stale]",)]
          and d_summary["nvcc_builds"] == 0 and refusal is not None
          and refusal.kind == "bundle_stale"
          and "rebuild hint" in str(refusal))
    print(f"bundle (d) a copy fingerprinted for torch 0.0.0+stale: "
          f"{d_summary['completed']} of {BUNDLE_STALE_REQUESTS} requests on "
          f"rungs {d_rungs}, tried {d_tried}, nvcc builds "
          f"{d_summary['nvcc_builds']}; require_bundle refused: "
          f"{str(refusal)[:400]!r} " + ("ok" if ok else "FAIL")
          + f" | {card}", flush=True)
    out["stale"] = {"rungs": d_rungs, "tried": d_tried,
                    "refusal": str(refusal)}
    if not ok:
        fail(f"phase 41 (d): {d_summary} {d_rows[:2]} {refusal}")

    # (e) Time to the first served chunk in a fresh process, by rung.
    tool = PKG + ".tools.aot_bundle"
    arms = {}
    for mode, build_dir, rung in (
            ("bundled", empty_dir("build_e"), "bundle_exec"),
            ("cold", None, "eager_cold"),
            ("cached", _build.build_dir(), "eager_cached")):
        argv = ["serve", "--entry", BUNDLE_ENTRIES[0], "--mode", mode,
                "--device", "cuda"]
        if mode == "bundled":
            argv += ["--bundle", bdir, "--expect-zero-compile"]
        wall, row, _ = run_module(tool, argv, f"phase 41 (e) {mode}",
                                  build_dir)
        row["process_s"] = wall
        arms[mode] = row
        if row["rung"] != rung or (mode == "cold") != bool(
                row["nvcc_builds"]):
            fail(f"phase 41 (e) {mode}: {row}")
    print("bundle (e) time to the first served chunk (cadmm4, 8 lanes) in "
          "a fresh process, after the imports: "
          + "; ".join(f"{m} {r['rung']} {r['ttfs_s']:.3f} s (set-up "
                      f"{r['setup_s']:.3f} s, the call {r['serve_s']:.3f} "
                      f"s, of it the install {r['install_s']:.3f} s and "
                      f"the graph capture {r['graph_capture_s']:.3f} s; "
                      f"nvcc builds "
                      f"{r['nvcc_builds']}; spawn to exit "
                      f"{r['process_s']:.2f} s)" for m, r in arms.items())
          + f" | {card}", flush=True)
    out["first_result"] = arms
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"bundle: phase 41 took {out['phase_s']:.1f} s | {card}",
          flush=True)
    torch.cuda.synchronize()
    return {"warp_solve_kernel": launches["warp_solve_kernel"],
            "fused_solve_early_kernel": launches["fused_solve_early_kernel"],
            "ring_sum": probe["ring_sum"]}


def k2_cases():
    """The shared-memory body's inputs at every shape it takes on a path,
    captured from the path's first launch: the entry step (d = 67, B = 1),
    the centralized steps at n = 3 and 4 (d = 67 and 79, 256 lanes, 120
    iterations, early exit), C-ADMM with the full agent QP (d = 72, 2048
    lanes, 20 fixed), a served ``centralized4`` chunk (d = 79, 256 lanes, 4
    iterations, early exit; and at 4 lanes, as ``tests/test_torch_card.py``
    serves it), the RP centralized step (d = 111, 256 lanes,
    150 fixed) and the PMRL step (d = 111, 256 lanes, at most 150, early
    exit decided by rounding). ``{name: (args, kw)}`` on the card."""
    import numpy as np
    import torch

    from tpu_aerial_transport_torch import entry
    from tpu_aerial_transport_torch.control import (
        pmrl_centralized,
        rp_centralized,
    )
    from tpu_aerial_transport_torch.harness import rollout, setup
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.serving import batcher
    from tpu_aerial_transport_torch.serving import server as server_mod
    from tpu_aerial_transport_torch.serving.queue import ScenarioRequest

    cases = {}

    def grab(name, fn):
        args = []
        with capturing(admm_kernel, "fused_solve_lanes", args):
            fn()
        torch.cuda.synchronize()
        cases[name] = args[0]

    step_e, (cs0, st0, acc) = entry.entry()
    grab("entry_d67_B1", lambda: step_e(cs0, st0, acc))
    for n, d in ((3, 67), (4, 79)):
        step_n, css0, st0_n = workload("centralized", n, N_SCENARIOS)
        grab(f"central_d{d}_B256", lambda: step_n(css0, st0_n))
    step, css0, st0 = workload("cadmm", N_AGENTS, N_SCENARIOS,
                               reduced_qp=False, pad_operators=True,
                               effort="fixed")
    grab("full_qp_d72_B2048", lambda: step(css0, st0))
    rng = np.random.default_rng(0)
    srv = server_mod.ScenarioServer(
        families=[batcher.make_family("centralized4", "cuda")],
        buckets=(N_SCENARIOS,), capacity=N_SCENARIOS, device="cuda")
    reqs = [ScenarioRequest(
        family="centralized4", horizon=2,
        x0=tuple(float(v) for v in rng.normal(0.0, 1.0, 3)),
        v0=tuple(float(v) for v in rng.normal(0.0, 0.2, 3)),
        request_id=f"k{i}") for i in range(N_SCENARIOS)]
    grab("served_central4_d79_B256", lambda: serve_drain(srv, reqs))
    srv4 = server_mod.ScenarioServer(
        families=[batcher.make_family("centralized4", "cuda")],
        buckets=(4,), device="cuda")
    grab("served_central4_d79_B4", lambda: serve_drain(srv4, [
        ScenarioRequest(family="centralized4", horizon=2,
                        x0=(0.2 * i, 0.1, 1.0), request_id=f"q{i}")
        for i in range(4)]))
    params, _, state0 = setup.rp_setup(N_AGENTS, device="cuda")
    f_eq = rp_centralized.equilibrium_forces(params)
    cfg = rp_centralized.make_config(params)
    cs = rollout.stack_scenarios(rp_centralized.init_ctrl_state(params, cfg),
                                 N_SCENARIOS)
    states, phase = rp_starts(state0, N_SCENARIOS)
    grab("rp_central_d111_B256", lambda: rp_centralized.control(
        params, cfg, f_eq, cs, states, circle_acc(0, states, phase)))
    params, _, state0 = setup.pmrl_setup(N_AGENTS, device="cuda")
    cfg = pmrl_centralized.make_config(params)
    cs = rollout.stack_scenarios(
        pmrl_centralized.init_ctrl_state(params, cfg, state0), N_SCENARIOS)
    states, target = pmrl_starts(state0, N_SCENARIOS)
    grab("pmrl_d111_B256", lambda: pmrl_steps(params, cfg, cs, states,
                                              target, 1))
    return cases


def sass_counts(lib: str, kernel: str) -> dict | None:
    """Instructions of ``kernel`` in the built library ``lib`` by opcode
    (``cuobjdump -sass``), or None without cuobjdump."""
    import re
    import shutil

    tool = (shutil.which("cuobjdump")
            or ("/usr/local/cuda/bin/cuobjdump"
                if os.path.exists("/usr/local/cuda/bin/cuobjdump") else None))
    if tool is None:
        return None
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300).stdout
    counts, on = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            on = line.split("Function :")[1].strip() == kernel
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if on and m:
            op = m.group(1).split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    return counts or None


def k2_variant(chains: int, one_max: int, inputs: str, build_only: bool):
    """One K2 row layout, built with -D into its own library: with
    ``build_only`` the build alone; else each captured case through it,
    held against the plain version (the smoke's kernel bar; early-exit
    cases also in their fixed form) and timed (CUDA graph, 50 calls), and
    the fixed-iteration block body's instructions counted. Prints one JSON
    line."""
    import torch

    from tpu_aerial_transport_torch.ops import _build, admm_kernel

    _build.NVCC_FLAGS = _build.NVCC_FLAGS + (
        f"-DK2_CHAINS={chains}", f"-DK2_ONE_CHAIN_MAX_D={one_max}")
    t0 = time.perf_counter()
    _build.build(("fused_solve",))
    if build_only:
        print(json.dumps({"built_s": time.perf_counter() - t0}), flush=True)
        return 0
    cases = torch.load(inputs, weights_only=False)
    names = ("x", "y", "z", "prim_res", "dual_res")
    out = {"chains": chains, "one_chain_max_d": one_max, "cases": {}}
    for case, (a, k) in cases.items():
        a = [None if t is None else t.cuda() for t in a]
        forms = [("", a, k)]
        if admm_kernel._early(k.get("check_every", 0), k.get("tol", 0.0)):
            forms.append(("_fixed", *fixed_form(a, k)))
        for suffix, fa, fk in forms:
            got = admm_kernel.fused_solve_lanes(*fa, **fk)
            ref = admm_kernel.fused_solve_lanes_reference(*fa, **fk)
            ref64 = plain64(fa, fk)
            lanes = None
            row = {}
            if len(got) > 5:
                same = got[5] == ref[5]
                row["eff_equal_share"] = float(same.float().mean())
                lanes = same & (ref64[5] == ref[5])
            errs, noise, ok = agreement(names, got[:5], ref[:5], ref64[:5],
                                        lanes)
            ratio = {}
            for nm, r in zip(names, ref[:5]):
                r = r if lanes is None else r[lanes]
                if not r.numel():
                    ratio[nm] = 0.0
                    continue
                bar = max(KERNEL_ATOL * max(1.0, float(r.abs().max())),
                          ROUNDING_FACTOR * noise[nm])
                ratio[nm] = errs[nm] / bar
            row["lanes_compared"] = (int(got[0].shape[0]) if lanes is None
                                     else int(lanes.sum()))
            if case.startswith("pmrl") and not suffix:
                # Rounding decides PMRL's stops: phase 35's rule.
                share64 = float((ref[5] != ref64[5]).float().mean())
                row["eff_differ_bar"] = flip_bar(share64, got[5].shape[0])
                ok = (ok and stopped_within_tol(got, fa, fk)
                      and 1.0 - row["eff_equal_share"]
                      <= row["eff_differ_bar"])
            elif "eff_equal_share" in row:
                ok = ok and row["eff_equal_share"] >= EFF_EQUAL_SHARE
            row.update(ok=ok, err_over_bar=max(ratio.values()),
                       worst=max(ratio, key=ratio.get),
                       ms=cuda_ms(lambda: admm_kernel.fused_solve_lanes(
                           *fa, **fk), 50))
            out["cases"][case + suffix] = row
    out["sass_fused_solve_kernel"] = sass_counts(
        _build.library_path("fused_solve"),
        "_Z18fused_solve_kernelPKfS0_S0_S0_S0_S0_S0_S0_S0_S0_S0_S0_S0_"
        "PfS1_S1_S1_Piiiiiififf7SocDimsi")
    print(json.dumps(out), flush=True)
    return 0


def k2_chains(card) -> int:
    """``--k2-chains``: the shared-memory body's K2 row layouts
    (K2_VARIANTS) on the captured inputs of every shape it takes, each
    layout's build in a child of its own (all built at once, then run one
    at a time): per case the error over the kernel bar and ms a launch;
    the table to standard output and ``chiprun_out/k2_chains.json``."""
    import torch

    from tpu_aerial_transport_torch.ops import _build

    _build.build()
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    inputs = os.path.join(HERE, "build", "k2_inputs.pt")
    os.makedirs(os.path.dirname(inputs), exist_ok=True)
    cases = k2_cases()
    torch.save({c: ([None if t is None else t.cpu() for t in a], k)
                for c, (a, k) in cases.items()}, inputs)
    print(f"k2 layouts: cases {sorted(cases)} | {card}", flush=True)

    def child(v, build_only):
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--k2-variant",
             *map(str, v), inputs] + (["--build-only"]
                                              if build_only else []),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=HERE)

    t0 = time.perf_counter()
    builds = [child(v, True) for v in K2_VARIANTS]
    for v, p in zip(K2_VARIANTS, builds):
        so, se = p.communicate(timeout=900)
        if p.returncode:
            fail(f"k2 layout {v}: build exited {p.returncode}: {se[-2000:]}")
    print(f"k2 layouts: {len(K2_VARIANTS)} builds at once in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = []
    for v in K2_VARIANTS:
        p = child(v, False)
        so, se = p.communicate(timeout=900)
        if p.returncode:
            fail(f"k2 layout {v}: exited {p.returncode}: {se[-2000:]}")
        row = json.loads(so.strip().splitlines()[-1])
        rows.append(row)
        print(f"k2 layout {v[0]} chains (one chain up to d = {v[1]}): "
              + "; ".join(f"{c} {r['ms']:.4f} ms, err/bar "
                          f"{r['err_over_bar']:.3f} ({r['worst']})"
                          + ("" if r["ok"] else " FAIL")
                          for c, r in row["cases"].items())
              + f" | sass {row['sass_fused_solve_kernel']} | {card}",
              flush=True)
    with open(os.path.join(out_dir, "k2_chains.json"), "w") as fh:
        json.dump({"card": card, "variants": rows}, fh, indent=1)
    return 0


# Phase 42: the float64 oracle (native/) against the whole-solve kernel on
# the headline's agent QPs, the registry's contracts on the card, and the
# lint tiers. The oracle and the float64 plain version are two float64
# implementations of the same iterations: ORACLE_RTOL x max(1, |ref|).
ORACLE_RTOL = 1e-9
LINT = os.path.join(PKG, "tools", "lint.py")


def oracle_check(card, report, args, kw, kernel_ms) -> float:
    """42(a): build the float64 oracle with g++, solve the captured agent
    QPs (``args``/``kw``, the headline's first ``fused_solve_lanes`` call:
    every lane's P, q, A, bounds, shift and warm start) in float64 at the
    kernel's iteration count, and hold the kernel's fixed form on the card
    against it (PERF.md section 2's kernel bar, the oracle in place of the
    float64 plain version) and the oracle against the float64 plain
    version on the card. Returns the kernel's largest error against the
    oracle."""
    import numpy as np
    import torch

    from tpu_aerial_transport_torch import native
    from tpu_aerial_transport_torch.ops import admm_kernel, socp

    t0 = time.perf_counter()
    lib = native.build()
    native._load()
    build_s = time.perf_counter() - t0
    x, y, z, K2, Minv, A, P, q, rho_vec, lb, ub, shift = args
    nv, n_box, soc = kw["nv"], kw["n_box"], tuple(kw["soc_dims"])
    B, m = A.shape[0], A.shape[1]
    # The penalty the oracle derives from the bounds must be the kernel's.
    rho = float(rho_vec[0, -1])
    if not torch.equal(socp.make_rho_vec(m, n_box, lb, ub, rho), rho_vec):
        fail("phase 42 (a): the captured penalties are not make_rho_vec's")
    host = [None if t is None else t.double().cpu().numpy()
            for t in (x, y, z, A, P, q, lb, ub, shift)]
    hx, hy, hz, hA, hP, hq, hlb, hub, hshift = host
    # The QPs are warm-started (the batch entry point starts cold), so each
    # lane is one solve_socp_native call from its own start.
    t0 = time.perf_counter()
    outs = [native.solve_socp_native(
        hP[b], hq[b], hA[b], hlb[b], hub[b], n_box=n_box, soc_dims=soc,
        iters=kw["iters"], rho=rho, alpha=kw["alpha"],
        shift=None if hshift is None else hshift[b],
        warm=(hx[b], hy[b], hz[b])) for b in range(B)]
    oracle_s = time.perf_counter() - t0
    ref = [np.stack([o[i] for o in outs]) for i in range(5)]
    got = admm_kernel.fused_solve_lanes(*args, **kw)
    plain = admm_kernel.fused_solve_lanes_reference(*args, **kw)
    a64 = [None if t is None else t.double()
           for t in (x, y, z, A, P, q, rho_vec, lb, ub, shift)]
    x64, y64, z64, A64, P64, q64, r64, lb64, ub64, s64 = a64
    op64 = socp.kkt_operator(P64, A64, r64)
    plain64 = admm_kernel.fused_solve_lanes_reference(
        x64, y64, z64, op64.K2, op64.Minv, A64, P64, q64, r64, lb64, ub64,
        s64, **kw)
    torch.cuda.synchronize()
    names = ("x", "y", "z", "prim_res", "dual_res")
    rows, ok = {}, True
    for nm, g, p32, p64, r in zip(names, got, plain, plain64, ref):
        g, p32, p64 = (t.double().cpu().numpy() for t in (g, p32, p64))
        scale = max(1.0, float(np.abs(r).max()))
        err = float(np.abs(g - r).max())
        noise = float(np.abs(p32 - r).max())
        bar = max(KERNEL_ATOL * scale, ROUNDING_FACTOR * noise)
        f64_err = float(np.abs(p64 - r).max())
        good = (err <= bar and f64_err <= ORACLE_RTOL * scale
                and bool(np.isfinite(g).all()))
        ok = ok and good
        rows[nm] = {"kernel_err": err, "bar": bar, "plain32_err": noise,
                    "plain64_err": f64_err, "ok": good}
    print(f"native oracle: g++ build {build_s:.2f} s ({os.path.basename(lib)}"
          f"); {B} agent QPs (nv={nv}, m={m}, d={nv + m}, "
          f"iters={kw['iters']}, warm-started) in float64 on the host in "
          f"{oracle_s:.3f} s ({oracle_s / B * 1e6:.1f} us a QP) against "
          f"{entry_name(args, kw)} {kernel_ms:.4f} ms/launch for all {B} | "
          f"{card}", flush=True)
    for nm, r in rows.items():
        print(f"  {nm}: kernel - oracle {r['kernel_err']:.3e} (bar "
              f"{r['bar']:.3e}), plain float32 - oracle "
              f"{r['plain32_err']:.3e}, plain float64 - oracle "
              f"{r['plain64_err']:.3e} (bar {ORACLE_RTOL} x max(1, |ref|)) "
              + ("ok" if r["ok"] else "FAIL"), flush=True)
    report["oracle"] = {"build_s": build_s, "lanes": B, "d": nv + m,
                        "iters": kw["iters"], "host_s": oracle_s,
                        "kernel_ms": kernel_ms, "outputs": rows}
    if not ok:
        fail("phase 42 (a): the kernel or the float64 plain version "
             "disagrees with the float64 oracle")
    return max(r["kernel_err"] for r in rows.values())


def contracts_check(card, report) -> dict:
    """42(b): ``run_contracts(device="cuda")`` over every registry entry
    whose ``needs`` is "" or "cuda" (the ``process_group`` entry is phase
    40's); one line an entry with its host syncs (the dispatch count, the
    card's own ``set_sync_debug_mode`` count, the dispatched and card-only
    budgets), what the second
    call rebuilt and the kernels it launched. Any finding or skip fails.
    Returns the launches by kernel over the second calls."""
    from tpu_aerial_transport_torch.analysis import contracts

    names = sorted(n for n, c in contracts.REGISTRY.items()
                   if c.needs in ("", "cuda"))
    reports: dict = {}
    t0 = time.perf_counter()
    findings = contracts.run_contracts(names, device="cuda",
                                       reports=reports)
    total_s = time.perf_counter() - t0
    launches: dict = {}
    for name in names:
        rep = reports[name]
        if "skipped" in rep:
            fail(f"phase 42 (b): {name} skipped on the card: "
                 f"{rep['skipped']}")
        for k, v in rep["launches"].items():
            launches[k] = launches.get(k, 0) + v
        print(f"contract {name}: host syncs {rep['syncs_total']} "
              f"{rep['syncs']} (dispatch), {rep['sync_debug_warnings']} "
              f"(set_sync_debug_mode) at {rep['sync_sites']}, budget "
              f"{rep['budget']} dispatched, {rep['card_only']} card only "
              f"| second call "
              f"rebuilt {rep['rebuilds']} | launches {rep['launches']} | "
              f"{rep['seconds']:.2f} s | {card}", flush=True)
    print(f"contracts on the card: {len(names)} entries in {total_s:.1f} s, "
          f"{len(findings)} findings, launches {launches} | {card}",
          flush=True)
    report["contracts"] = {"entries": reports, "seconds": total_s,
                           "findings": [f.render() for f in findings]}
    if findings:
        fail("phase 42 (b): " + "; ".join(f.render() for f in findings))
    return launches


def lint_check(report) -> None:
    """42(c): Tiers A and C of the lint over the port's tree, by file path
    (no torch, no jax imported), exit 0."""
    rows = {}
    for tier in ([], ["--host"]):
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, LINT), *tier,
             "--assert-no-torch"], capture_output=True, text=True,
            timeout=300)
        what = "C (hostlint)" if tier else "A (torchlint)"
        last = (proc.stdout.strip().splitlines() or [""])[-1]
        print(f"lint tier {what}: rc {proc.returncode}, {last}", flush=True)
        rows[what] = {"rc": proc.returncode, "last": last}
        if proc.returncode != 0:
            fail(f"phase 42 (c): lint tier {what}: {proc.stdout[-2000:]}"
                 f"{proc.stderr[-2000:]}")
    report["lint"] = rows


def analysis_phase(card, report, args, kw, kernel_ms):
    """Phase 42: (a) the float64 oracle, (b) the contracts on the card,
    (c) the lint tiers. Returns ``(kernel - oracle error, launches by
    kernel in (b))``."""
    t0 = time.perf_counter()
    err = oracle_check(card, report, args, kw, kernel_ms)
    launches = contracts_check(card, report)
    lint_check(report)
    report["phase42_s"] = time.perf_counter() - t0
    print(f"phase 42: {report['phase42_s']:.1f} s | {card}", flush=True)
    return err, launches


# Phase 43, the operator's tools on the card: the fixed headline steps each
# profiled capture holds, the JAX tool's attribution bar
# (tests/test_op_profile.py:242), and how far the tool's device time per
# phase may be from phase_breakdown's on the same capture.
TOOL_STEPS = 3
ATTRIBUTION_BAR = 0.80
PHASE_AGREEMENT = 0.01
# The metrics and trace files earlier phases leave under build/, by phase.
TOOL_METRICS = {
    "33": ("recovery_run/*.metrics.jsonl",),
    "37": ("serving_guard/" + SERVING_METRICS,),
    "38": ("drivers/sessions/*.metrics.jsonl",),
    "39": ("fleet_run/**/*.metrics.jsonl",),
    "40": ("pods_run/**/*.metrics.jsonl",),
    "41": ("aot_run/bundled.jsonl", "aot_run/stale.jsonl"),
}
TOOL_TRACES = ("pods_run/**/*.trace.json", "fleet_run/**/*.trace.json")
# Row kind -> (run_health summary key, the header its section renders).
HEALTH_SECTIONS = {
    "chunk": ("chunks", "## chunk wall-times"),
    "resume": ("interruptions", "## resume / retry / preemption events"),
    "retry": ("interruptions", "## resume / retry / preemption events"),
    "preempted": ("interruptions", "## resume / retry / preemption events"),
    "backend_event": ("backend", "## backend health"),
    "serving_event": ("serving", "## serving SLO"),
    "session_event": ("sessions", "## closed-loop sessions"),
    "fleet_event": ("fleet", "## serving fleet"),
    "alert": ("alerts", "## slo alerts"),
    "aot_serve": ("aot", "## AOT serve ladder"),
}
# The sections the earlier phases' files must render between them.
HEALTH_REQUIRED = {"chunks", "interruptions", "backend", "serving",
                   "sessions", "fleet", "aot", "critical_path"}


def phases_apart(tool_us: dict, pb: dict) -> dict:
    """Per phase, the tool's device microseconds against
    ``phase_breakdown``'s on the same capture, relative: the tool's
    ``(unattributed)`` against the kernels ``phase_breakdown`` finds
    outside every ``tat.*`` range ("other") or in no host range."""
    from tpu_aerial_transport_torch.tools.op_profile import UNATTRIBUTED

    dev = pb["device_us"]
    ref = {k: v for k, v in dev.items()
           if k not in ("other", "unattributed") and v}
    ref[UNATTRIBUTED] = dev.get("other", 0.0) + dev.get("unattributed", 0.0)
    out = {}
    for k in set(ref) | {k for k, v in tool_us.items() if v}:
        a, b = tool_us.get(k, 0.0), ref.get(k, 0.0)
        out[k] = abs(a - b) / max(abs(b), 1e-9)
    return out


def tools_profile(card, root) -> dict:
    """Phase 43(a): ``op_profile --by-phase`` over a ``torch.profiler``
    trace of TOOL_STEPS fixed-headline steps, with the graph on and off."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_aerial_transport_torch.harness import rollout
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.tools import op_profile

    out = {}
    for arm, graph in (("off", False), ("on", True)):
        run, css0, states0 = rollout.build(
            n=N_AGENTS, n_scenarios=N_SCENARIOS, max_iter=20,
            inner_iters=20, device="cuda", cuda_graph=graph)
        run(css0, states0, 1)  # warm-up: kernel loads, the graph capture.
        torch.cuda.synchronize()
        zero_launches()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(css0, states0, TOOL_STEPS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        counted = {k: v for k, v in admm_kernel.KERNEL_LAUNCHES.items() if v}
        path = os.path.join(root, f"headline_graph_{arm}.json")
        prof.export_chrome_trace(path)
        # Graph on, phase_breakdown finds the replayed graph's kernels in
        # no host range, where the tool finds them under their
        # cudaGraphLaunch in tat.dynamics; the graph-off capture, which both
        # read alike, is the one compared (prof.events() takes seconds).
        pb = phase_breakdown(prof) if not graph else None
        jpath = path[:-5] + ".phases.json"
        rc, table, _ = run_driver(op_profile.main, [path, "--by-phase",
                                                    "--json", jpath])
        with open(jpath) as fh:
            got = json.load(fh)
        tool_us = {r["phase"]: r["total_ms"] * 1e3 for r in got["phases"]}
        apart = phases_apart(tool_us, pb) if pb else {}
        busy = got["op_total_ms"] / wall_ms
        print(f"phase 43 (a) op_profile --by-phase over {TOOL_STEPS} "
              f"fixed-headline steps ({N_SCENARIOS} x {N_AGENTS}), graph "
              f"{arm}: wall {wall_ms:.2f} ms (profiler on), device busy "
              f"{got['op_total_ms']:.3f} ms = {100 * busy:.1f}%, "
              f"{100 * got['attributed_frac']:.2f}% of device time in tat.* "
              f"phases; own kernels {got['own_kernel_launches']} (counters "
              f"{counted}) | {card}", flush=True)
        print("\n".join(table), flush=True)
        for name in sorted(tool_us, key=lambda p: -tool_us[p]):
            print(f"  {name}: device {tool_us[name] / 1e3:.3f} ms"
                  + (f" (phase_breakdown {100 * apart[name]:.4f}% apart)"
                     if name in apart else "")
                  + f", host {got['host_ms_by_phase'].get(name, 0.0):.3f} ms",
                  flush=True)
        out[arm] = {"wall_ms": wall_ms, "tool": got, "counters": counted,
                    "phase_breakdown": pb, "apart": apart}
        warp = got["own_kernel_launches"].get("warp_solve_kernel", 0)
        if rc or counted != {"warp_solve_kernel": 21 * TOOL_STEPS} \
                or warp != 21 * TOOL_STEPS:
            fail(f"phase 43 (a), graph {arm}: op_profile rc {rc}, "
                 f"{warp} whole-solve launches in the trace, counters "
                 f"{counted}; expected 21 a step")
        if not {"local_solve", "consensus"} <= set(tool_us):
            fail(f"phase 43 (a), graph {arm}: phases {sorted(tool_us)}")
    off = out["off"]
    if off["tool"]["attributed_frac"] < ATTRIBUTION_BAR:
        fail(f"phase 43 (a): {off['tool']['attributed_frac']:.4f} of the "
             f"graph-off device time in tat.* phases < {ATTRIBUTION_BAR}")
    worst = max(off["apart"].values())
    print(f"phase 43 (a): the tool's device time per phase against "
          f"phase_breakdown's on the graph-off capture: at most "
          f"{100 * worst:.4f}% apart | {card}", flush=True)
    if worst > PHASE_AGREEMENT:
        fail(f"phase 43 (a): tool and phase_breakdown {off['apart']}")
    return out


def tools_dd64(card) -> dict:
    """Phase 43(b): ``profile_dd64`` at its defaults (n = 64, batch 64) with
    one rep, each variant's launches counted."""
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.tools import profile_dd64

    variants = []
    timed = profile_dd64.timed

    def counting(*args, **kw):
        zero_launches()
        ms = timed(*args, **kw)
        variants.append({"ms": ms, **{
            k: v for k, v in {**admm_kernel.KERNEL_LAUNCHES,
                              **admm_kernel.CHUNK_LAUNCHES}.items() if v}})
        return ms

    profile_dd64.timed = counting
    try:
        res, printed, _ = run_driver(profile_dd64.main, ["--reps", "1"])
    finally:
        profile_dd64.timed = timed
    line = json.loads("\n".join(printed))
    print("phase 43 (b) profile_dd64 (n = 64, batch 64, 1 rep): "
          + json.dumps(line) + f" | {card}", flush=True)
    print(f"  launches by variant (8x40, 8x20, 16x20, adaptive, adaptive "
          f"inner_tol; warm-up step included): {json.dumps(variants)}",
          flush=True)
    nums = [v for v in line.values() if isinstance(v, float)]
    if (res or line["platform"] != "cuda" or len(variants) != 5
            or not all(math.isfinite(v) for v in nums)
            or not all(len(v) > 1 for v in variants)):
        fail(f"phase 43 (b): rc {res}, {line}, launches {variants}")
    return {"split": line, "variants": variants}


def tools_health(card, root) -> dict:
    """Phase 43(c): ``run_health`` and ``trace_view`` over the metrics and
    trace files phases 33 and 37-41 left under build/."""
    import glob

    from tpu_aerial_transport_torch.obs import export
    from tpu_aerial_transport_torch.tools import run_health, trace_view

    build = os.path.join(HERE, "build")
    files, rendered = {}, set()
    for phase, patterns in TOOL_METRICS.items():
        found = sorted({p for pat in patterns for p in glob.glob(
            os.path.join(build, pat), recursive=True)})
        if not found:
            fail(f"phase 43 (c): phase {phase} left no {patterns}")
        for path in found:
            rc, _, _ = run_driver(run_health.main, ["--validate", path])
            events = export.read_events(path)
            summary = run_health.summarize(events)
            _, lines, _ = run_driver(run_health.render, summary)
            text = "\n".join(lines)
            want = {HEALTH_SECTIONS[e["event"]]
                    for e in events if e.get("event") in HEALTH_SECTIONS}
            if any(e.get("event") == "trace_event" and e.get("name")
                   == "request" for e in events):
                want.add(("critical_path", "## critical path"))
            missing = sorted(k for k, head in want
                             if not summary.get(k) or head not in text)
            files[os.path.relpath(path, build)] = {
                "phase": phase, "validate_rc": rc, "rows": len(events),
                "sections": sorted(k for k, _ in want), "missing": missing}
            if rc or missing:
                fail(f"phase 43 (c): {path}: --validate rc {rc}, sections "
                     f"with no rows {missing}")
            rendered |= {k for k, _ in want}
    if not HEALTH_REQUIRED <= rendered:
        fail(f"phase 43 (c): no file rendered "
             f"{sorted(HEALTH_REQUIRED - rendered)}")
    traces = sorted({p for pat in TOOL_TRACES for p in glob.glob(
        os.path.join(build, pat), recursive=True)})
    stitched = os.path.join(root, "stitched.trace.json")
    sources = sorted({os.path.dirname(p) for p in glob.glob(
        os.path.join(build, "pods_run", "**", "trace.*.metrics.jsonl"),
        recursive=True)}) + [os.path.join(build, "serving_guard",
                                          SERVING_METRICS)]
    rc_out, summary, _ = run_driver(trace_view.main, sources + [
        "--out", stitched, "--critical-path"])
    rc_val, _, _ = run_driver(trace_view.main, ["--validate", stitched]
                              + traces)
    view = json.loads("\n".join(summary)) if not rc_out else {}
    print(f"phase 43 (c) run_health --validate and render over "
          f"{len(files)} files of phases {sorted(TOOL_METRICS)}: every "
          f"row kind rendered its section; sections "
          f"{sorted(rendered)}; trace_view --out of {len(sources)} sources: "
          f"{view.get('rows')} rows on tracks {view.get('tracks')}, "
          f"--validate rc {rc_val} over it and {len(traces)} trace files "
          f"| {card}", flush=True)
    if rc_out or rc_val or not traces:
        fail(f"phase 43 (c): trace_view --out rc {rc_out}, --validate rc "
             f"{rc_val}, {len(traces)} trace files")
    return {"files": files, "trace_files": traces, "stitched": view}


def tools_phase(card, report) -> dict:
    """Phase 43, the operator's tools on the card: (a) ``op_profile`` over
    ``torch.profiler`` traces of the fixed headline, graph on and off,
    against the launch counters and ``phase_breakdown``; (b)
    ``profile_dd64`` at n = 64; (c) ``run_health`` and ``trace_view`` over
    the files of earlier phases; (d) ``probe_chip`` once."""
    import shutil

    from tpu_aerial_transport_torch.tools import probe_chip

    t_phase = time.perf_counter()
    root = os.path.join(HERE, "build", "tools_run")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = report["tools"] = {}
    part_s = out["part_s"] = {}
    for part, key, run in (("a", "op_profile", lambda: tools_profile(card,
                                                                     root)),
                           ("b", "profile_dd64", lambda: tools_dd64(card)),
                           ("c", "health", lambda: tools_health(card,
                                                                root))):
        t0 = time.perf_counter()
        out[key] = run()
        part_s[part] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log = os.path.join(root, "probe_chip.log")
    rc, printed, _ = run_driver(probe_chip.main, ["--log", log])
    with open(log) as fh:
        logged = fh.read().splitlines()
    print(f"phase 43 (d) probe_chip: rc {rc}, logged {logged} | {card}",
          flush=True)
    if rc or len(logged) != 1 or "ALIVE" not in logged[0]:
        fail(f"phase 43 (d): probe_chip rc {rc}: {printed}")
    out["probe_chip"] = logged[0]
    part_s["d"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 43: {out['seconds']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in part_s.items())
          + f") | {card}", flush=True)
    return {"profile": 21 * TOOL_STEPS * 2, "profile_dd64": sum(
        v for var in out["profile_dd64"]["variants"]
        for k, v in var.items() if k != "ms")}


def main() -> int:
    child = sys.argv[1:2] in (["--recovery-child"], ["--serving-child"])
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
    if sys.argv[1:2] == ["--serving-child"]:
        return serving_child(*sys.argv[2:4])
    if sys.argv[1:2] == ["--driver-child"]:
        return driver_child(sys.argv[2])
    if sys.argv[1:2] == ["--k2-variant"]:
        return k2_variant(*map(int, sys.argv[2:4]), sys.argv[4],
                          "--build-only" in sys.argv)
    if sys.argv[1:2] == ["--k2-chains"]:
        return k2_chains(card_line())
    if child:
        mode, run_dir, S = sys.argv[2:5]
        return recovery_child(mode, run_dir, int(S))
    if os.environ.get("TAT_BACKEND_FAULTS"):
        # An injected fault would degrade work the phases hold to the card:
        # phase 37 sets it for one server run only.
        print("chip_smoke: TAT_BACKEND_FAULTS is set "
              f"({os.environ['TAT_BACKEND_FAULTS']!r}); unset it",
              file=sys.stderr)
        return 1

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
    # 34-35. The RP and PMRL models through the shared-memory body.
    phase_at["34"] = time.perf_counter() - t_start
    rp_rows = rp_phase(card, report)
    phase_at["35"] = time.perf_counter() - t_start
    pmrl_rows = pmrl_phase(card, report)
    # 36. The differentiable simulation: no kernel on its path.
    phase_at["36"] = time.perf_counter() - t_start
    diff_phase(card, report)
    # 37. The serving tier through the whole-solve kernel's two bodies.
    phase_at["37"] = time.perf_counter() - t_start
    serving_launches = serving_phase(card, report)
    # 38. The user's drivers through the whole-solve kernel's two bodies.
    phase_at["38"] = time.perf_counter() - t_start
    driver_launches = drivers_phase(card, report)
    # 39. The serving fleet: replica processes on the card.
    phase_at["39"] = time.perf_counter() - t_start
    fleet_launches = fleet_phase(card, report)
    # 40. Scenario sharding across processes: worker processes on the card.
    phase_at["40"] = time.perf_counter() - t_start
    pods_launches = pods_phase(card, report)
    # 41. Bundled serving: kernel libraries from an AOT bundle, no nvcc.
    phase_at["41"] = time.perf_counter() - t_start
    bundle_launches = bundle_phase(card, report)
    # 42. The float64 oracle, the registry's contracts on the card, the
    # lint tiers.
    phase_at["42"] = time.perf_counter() - t_start
    oracle_err, contract_launches = analysis_phase(card, report, args, kw,
                                                   kernel_ms)
    # 43. The operator's tools: op_profile, profile_dd64, run_health,
    # trace_view and probe_chip on the card.
    phase_at["43"] = time.perf_counter() - t_start
    tool_launches = tools_phase(card, report)

    kernels = [
        solve_row(main_timing, launches["fused_solve"],
                  max(max(c["max_abs_err"].values())
                      for c in checks.values()), plain_ms, bound_by),
        solve_row(e_timing, launches_a["fused_solve_early"], e_err, e_plain,
                  e_by),
    ] + bf16_rows + central_rows + chunk_rows + [ring_row] + rp_rows \
        + pmrl_rows
    for row in kernels:
        row["contract_launches"] = contract_launches.get(row["name"], 0)
        if row["name"] == main_name:
            row["oracle_max_abs_err"] = oracle_err
    report["kernels"] = kernels
    report["launches_elsewhere"] = {
        "fused_solve_cadmm_options": option_launches,
        "fused_solve_serving_stream": serving_launches,
        "fused_solve_rqp_forest_driver": driver_launches,
        "fused_solve_fleet_replicas": fleet_launches,
        "pods_workers": pods_launches,
        "bundled_serving": bundle_launches,
        "operator_tools": tool_launches,
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
