"""Localhost pods harness: a parent and N group-killable worker processes
driving the scenario tier across processes (``parallel/pods.py``), each
worker one process of the pods mesh, all joined by one gloo group.

The port's counterpart of the JAX package's ``tools/pods_local.py``. Each
worker computes on ``--device``: ``cuda`` (the default) puts every
worker's slab on the card (the workers share it, each with its own CUDA
context); ``cpu`` runs the plain PyTorch path. ``--local-devices`` is the
logical shard count of each process. There is no fallback: a worker on
``cuda`` that finds no card exits non-zero and the parent reports its
exit and the tail of its stderr; a parent asked for ``cuda`` on a host
without a card raises before it starts any worker. On ``cuda`` the
parent builds the kernels once before spawning, so the workers load them.

Modes (the parent prints ONE final JSON line):

- ``parity``: ``pods.parity_digest`` (a deterministic rollout and one
  alive-masked control step); rank 0 writes the host-global digest to
  ``--out-dir/parity.npz``. ``--check-parity`` also runs the
  single-process pod on the same ``SxA`` mesh and compares the two
  digests leaf by leaf to ``PARITY_ATOL`` (exit 1 on a mismatch), and
  says whether the residuals are equal exactly.
- ``bench``: a timed cell -- one warm-up rollout, then the median of
  ``--reps`` rollouts: ``scenario_mpc_steps_per_sec`` and the topology.
- ``resume``: a chunked run with per-process snapshot shards;
  ``--stop-after-chunk K`` simulates preemption at boundary K,
  ``--resume`` completes it; each worker reports a sha256 of every leaf
  of its final slab. ``--trace PATH`` stitches the workers' spans
  (track ``p{pid}ofN`` each) into one Chrome/Perfetto trace.

Every worker prints its own result line (its boot seconds from spawn to
its mesh built, its kernel launches); the parent's line carries worker
0's with every worker's under ``workers`` and the spawn-to-result wall
time.

Process discipline: each worker leads its own process group
(``start_new_session=True``) and is signalled only through it; both
pipes of every worker are drained in threads at once; each worker
watches its parent's pid and exits when orphaned; every worker started
is reaped when the run ends, normally or by an exception. Hosts with one
core skip with a written reason on the CPU (an error on the card).

Usage:
  python -m tpu_aerial_transport_torch.tools.pods_local --mode parity \\
      --check-parity --device cpu --processes 2 --local-devices 2 --n 4 \\
      --scenarios 4 --steps 1 --max-iter 2
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WORKER_MODULE = "tpu_aerial_transport_torch.tools.pods_local"
RESULT_TAG = "PODS_RESULT "
SPAWN_TS_ENV = "TAT_PODS_SPAWN_TS"

# Parity bar: the two topologies run the SAME program over the SAME mesh
# shape; only the batch a process holds differs (the JAX test_ring
# full-control-step tolerance).
PARITY_ATOL = 2e-3


# ----------------------------------------------------------------------
# Worker side.
# ----------------------------------------------------------------------

def _orphan_watchdog() -> None:
    """Workers run in their own sessions (group-killability), so a parent
    crash does not reap them -- a worker holding the rendezvous port would
    outlive its run. Watch the parent pid and exit on reparent. Runs only
    inside a worker (:func:`run_worker`)."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(2.0)
            if os.getppid() != parent:
                os._exit(17)

    threading.Thread(target=watch, daemon=True).start()


def _simulated_preemption(plan, stop_after: int):
    """An ``interrupt`` for ``recovery.run_chunks`` that trips once the
    per-process journal shows ``stop_after`` completed chunks, so the
    "crash" lands at the same boundary on every process and every run."""
    from tpu_aerial_transport_torch.resilience.recovery import RunJournal

    journal = RunJournal(plan.run_dir, filename=plan.journal_filename)

    class _Trip:
        @property
        def triggered(self):
            done = len(journal.completed_chunks())
            return "SIMULATED_PREEMPT" if done >= stop_after else None

    return _Trip()


def _launches() -> dict:
    """The kernel launches counted in this process since the last reset:
    the whole-solve kernel's entry points and the ring sum."""
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.parallel import ring

    out = {k: v for k, v in admm_kernel.KERNEL_LAUNCHES.items() if v}
    out.update({k: v for k, v in ring.LAUNCHES.items() if v})
    return out


def _zero_launches() -> None:
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.parallel import ring

    for counts in (admm_kernel.LAUNCHES, admm_kernel.KERNEL_LAUNCHES,
                   admm_kernel.CHUNK_LAUNCHES, ring.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def leaf_sha256(tree) -> list[str]:
    """A sha256 of every leaf of a host tree, in ``tree.leaves`` order."""
    from tpu_aerial_transport_torch.tree import leaves

    return [hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()
            for t in leaves(tree)]


def run_worker(args) -> int:
    """One process of the pod: bootstrap the group, build the mesh, run
    ``args.mode``, print this process's result line."""
    _orphan_watchdog()
    import numpy as np

    from tpu_aerial_transport_torch import resolve_device
    from tpu_aerial_transport_torch.parallel import mesh as mesh_mod
    from tpu_aerial_transport_torch.parallel import pods

    device = resolve_device(args.device)
    if device.type == "cpu":
        import torch

        # The workers share the host's cores: each its share, or their
        # intra-op thread pools oversubscribe them.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.processes))
    group = pods.initialize()  # TAT_PODS_* env from the parent.
    spec = pods.resolve_pods_spec(
        args.n, args.mesh or "auto",
        n_devices=args.processes * args.local_devices,
        n_processes=args.processes,
    )
    mesh = pods.make_pods_mesh(spec, group, device)
    if device.type == "cuda":
        import torch

        torch.zeros(1, device=device)  # the CUDA context, in the boot.
    spawned = float(os.environ.get(SPAWN_TS_ENV) or time.time())
    out: dict = {
        "mode": args.mode,
        "process": mesh.rank,
        "pid": os.getpid(),
        "device": device.type,
        "boot_s": time.time() - spawned,
        "n_processes": spec.n_processes,
        "n_devices": spec.n_devices,
        "mesh": {"scenario": spec.scenario_shards,
                 "agent": spec.agent_shards},
        "n": args.n,
        "n_scenarios": args.scenarios,
        "agents_total": args.n * args.scenarios,
    }

    if args.mode == "parity":
        _zero_launches()
        digest = pods.parity_digest(
            mesh, n=args.n, n_scenarios=args.scenarios,
            n_steps=args.steps, max_iter=args.max_iter,
            inner_iters=8 if args.inner_iters is None else args.inner_iters,
            controller=args.controller, masked=args.masked,
            consensus_impl=args.consensus_impl,
        )
        _sync(device)
        out["launches"] = _launches()
        if mesh.rank == 0 and args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            np.savez(os.path.join(args.out_dir, "parity.npz"), **digest)
        out["digest_sums"] = {
            k: float(np.abs(v).sum()) for k, v in digest.items()
        }
        out["ok"] = bool(all(np.isfinite(v).all() for v in digest.values()))

    elif args.mode == "bench":
        roll, init_batch = pods.make_pods_workload(
            args.n, mesh, controller=args.controller,
            max_iter=args.max_iter, inner_iters=args.inner_iters,
            consensus_impl=args.consensus_impl,
        )
        css, states = init_batch(args.scenarios)
        css = mesh_mod.shard_scenarios(mesh, css)
        states = mesh_mod.shard_scenarios(mesh, states)
        t0 = time.perf_counter()
        o = roll(css, states, args.steps)
        _sync(device)
        warmup_s = time.perf_counter() - t0
        _zero_launches()
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            o = roll(css, states, args.steps)
            _sync(device)
            times.append(time.perf_counter() - t0)
        wall = float(np.median(times))
        out.update(
            scenario_mpc_steps_per_sec=args.scenarios * args.steps / wall,
            agent_mpc_steps_per_sec=(
                args.scenarios * args.steps / wall * args.n
            ),
            warmup_wall_s=warmup_s, rep_wall_s=times,
            steps=args.steps, launches=_launches(),
            ok=bool(np.isfinite(o[2].cpu().numpy()).all()),
        )

    elif args.mode == "resume":
        from tpu_aerial_transport_torch.harness import rollout as h_rollout

        # The resumable tier is scenario-data-parallel (the chunked
        # rollout on each process's slab); each process feeds its LOCAL
        # slab and snapshots only it.
        params, cfg, f_eq, llc, hl, acc_des_fn = _centralized_bits(
            args.n, device)
        runner = h_rollout.make_chunked_rollout(
            hl, llc.control, params, n_hl_steps=args.steps,
            n_chunks=args.chunks, hl_rel_freq=2, acc_des_fn=acc_des_fn,
        )
        run = pods.pods_rollout_resumable(
            runner.chunk_fn, mesh,
            n_hl_steps=args.steps, n_chunks=args.chunks,
            run_dir=args.out_dir, seed=0,
            tracer=(True if args.trace else None),
        )
        local = _local_resume_carry(args, mesh, params, cfg, f_eq, runner)
        interrupt = None
        if args.stop_after_chunk is not None:
            interrupt = _simulated_preemption(
                run.plan, args.stop_after_chunk
            )
        _zero_launches()
        result = run(local, resume=args.resume, interrupt=interrupt)
        _sync(device)
        final_local = pods.local_host_shard(result.carry)
        out.update(
            status=result.status, chunks_done=result.chunks_done,
            resumed_from_chunk=result.resumed_from_chunk,
            digest=float(np.abs(final_local[0].xl.numpy()).sum()),
            xl0=[float(v) for v in final_local[0].xl.reshape(-1)[:3]],
            leaf_sha256=leaf_sha256(final_local),
            launches=_launches(),
            ok=result.status in ("done", "preempted"),
        )

    else:
        raise SystemExit(f"unknown mode {args.mode}")

    print(RESULT_TAG + json.dumps(out), flush=True)
    return 0


def _centralized_bits(n: int, device):
    """The centralized controller's chunked-rollout pieces for the resume
    mode (a cheap program a lane: what is under test is the multi-process
    machinery)."""
    import torch

    from tpu_aerial_transport_torch.control import centralized, lowlevel
    from tpu_aerial_transport_torch.harness import setup

    params, col, _state = setup.rqp_setup(n, device=device)
    cfg = centralized.make_config(
        params, col.collision_radius, col.max_deceleration, solver_iters=8
    )
    f_eq = centralized.equilibrium_forces(params)
    llc = lowlevel.make_lowlevel_controller("pd", params)
    anchor = torch.tensor([5.0, 0.0, 2.0], device=device)
    zero = torch.zeros(3, device=device)

    def hl(cs, s, a):
        return centralized.control(params, cfg, f_eq, cs, s, a)

    def acc_des_fn(state, t):
        # A fixed global anchor (the batch centre): offset-invariant, so
        # chunked == unchunked stays bitwise.
        del t
        dvl = -1.0 * state.vl - 1.0 * (state.xl - anchor)
        return (dvl, torch.zeros_like(dvl)), anchor, zero

    return params, cfg, f_eq, llc, hl, acc_des_fn


def _local_resume_carry(args, mesh, params, cfg, f_eq, runner):
    """This process's slab of the deterministic global initial carry, on
    the host."""
    from tpu_aerial_transport_torch.control import centralized
    from tpu_aerial_transport_torch.harness import setup
    from tpu_aerial_transport_torch.harness.rollout import stack_scenarios
    from tpu_aerial_transport_torch.parallel import pods
    from tpu_aerial_transport_torch.tree import tree_map

    _p, _c, state0 = setup.rqp_setup(args.n, device=mesh.device)
    states = pods.scenario_batch(state0, args.scenarios)
    css = stack_scenarios(
        centralized.init_ctrl_state(params, cfg, f_eq), args.scenarios)
    rows = mesh.rows(args.scenarios)
    return pods.local_host_shard(
        tree_map(lambda t: t[rows], runner.init_carry(states, css)))


# ----------------------------------------------------------------------
# Parent side.
# ----------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _signal_group(proc: subprocess.Popen, sig) -> None:
    """Signal the process group that ``proc`` leads: every worker is
    started with ``start_new_session=True``, so its pid is its group's."""
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError):
        proc.kill()


def _worker_cmd(args) -> list[str]:
    return [
        sys.executable, "-m", WORKER_MODULE, "--worker",
        "--mode", args.mode, "--processes", str(args.processes),
        "--local-devices", str(args.local_devices),
        "--n", str(args.n), "--scenarios", str(args.scenarios),
        "--steps", str(args.steps), "--max-iter", str(args.max_iter),
        "--reps", str(args.reps), "--chunks", str(args.chunks),
        "--controller", args.controller, "--device", args.device,
        "--consensus-impl", args.consensus_impl,
    ] + (["--inner-iters", str(args.inner_iters)]
         if args.inner_iters is not None else []) \
      + (["--mesh", args.mesh] if args.mesh else []) \
      + (["--out-dir", args.out_dir] if args.out_dir else []) \
      + (["--trace", args.trace] if args.trace else []) \
      + (["--resume"] if args.resume else []) \
      + ([] if args.masked else ["--no-masked"]) \
      + (["--stop-after-chunk", str(args.stop_after_chunk)]
         if args.stop_after_chunk is not None else [])


def spawn_pod(args):
    """Spawn the N workers (each in its own session) and babysit them
    under one deadline. Returns ``(result | None, rc, tail)``: the result
    is worker 0's line with every worker's under ``workers`` and
    ``spawn_to_result_s``, the parent's wall time from the first spawn to
    the last worker's exit."""
    port = _free_port()
    base_env = dict(os.environ)
    base_env.update({
        "TAT_PODS_COORDINATOR": f"127.0.0.1:{port}",
        "TAT_PODS_NUM_PROCESSES": str(args.processes),
    })
    cmd = _worker_cmd(args)
    workers: list[subprocess.Popen] = []
    outs: list = [("", "")] * args.processes
    t_spawn = time.perf_counter()
    try:
        for pid in range(args.processes):
            env = dict(base_env, TAT_PODS_PROCESS_ID=str(pid))
            env[SPAWN_TS_ENV] = repr(time.time())
            workers.append(subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env, start_new_session=True, cwd=_REPO,
            ))

        # Drain every worker's pipes AT ONCE: draining worker 0 first
        # would deadlock the pod if another worker fills its pipe while
        # worker 0 waits on it in a collective, and on a timeout the
        # sequential path would drop the very output that says why.
        def _drain(i, w):
            outs[i] = w.communicate()

        threads = [threading.Thread(target=_drain, args=(i, w), daemon=True)
                   for i, w in enumerate(workers)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + args.timeout
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in threads):
            for w in workers:
                _signal_group(w, signal.SIGKILL)
            for t in threads:
                t.join(10.0)  # the kill ends communicate(); keep the tails.
            tails = " ;; ".join(
                f"worker{i}: " + " | ".join(
                    (e or o or "").strip().splitlines()[-2:])
                for i, (o, e) in enumerate(outs))
            return None, 124, (
                f"deadline {args.timeout:g}s exceeded (pod group-killed; "
                f"gloo rendezvous wedged?) ;; {tails}")
        wall = time.perf_counter() - t_spawn
    finally:
        for w in workers:
            if w.poll() is None:
                _signal_group(w, signal.SIGKILL)
        for w in workers:
            with contextlib.suppress(subprocess.TimeoutExpired):
                w.wait(10.0)

    rcs = [w.returncode for w in workers]
    rows = []
    for o, _e in outs:
        row = None
        for line in (o or "").splitlines():
            if line.startswith(RESULT_TAG):
                with contextlib.suppress(ValueError):
                    row = json.loads(line[len(RESULT_TAG):])
        rows.append(row)
    if any(rcs) or any(r is None for r in rows):
        tails = []
        for i, (o, e) in enumerate(outs):
            tail = (e or o or "").strip().splitlines()[-4:]
            tails.append(f"worker{i} rc={rcs[i]}: " + " | ".join(tail))
        return rows[0], max(rcs) or 1, " ;; ".join(tails)
    result = dict(rows[0], workers=rows, spawn_to_result_s=wall)
    return result, 0, ""


def stitch_trace(run_dir: str, out_path: str) -> dict:
    """Every worker's trace rows in the shared run dir on one clock,
    written as Chrome/Perfetto trace JSON. The run dir's shard manifest
    names how many process tracks make the trace complete: a partial
    stitch raises (``obs.trace.stitch_run_dir``)."""
    from tpu_aerial_transport_torch.obs import trace as trace_mod

    rows = trace_mod.stitch_run_dir(run_dir)
    obj = trace_mod.write_chrome_trace(out_path, rows)
    return {
        "path": out_path,
        "spans": len(rows),
        "tracks": sorted({r.get("track") for r in rows}),
        "events": len(obj["traceEvents"]),
    }


def parity_report(args) -> dict:
    """Run the multi-process pod AND the single-process pod on the same
    ``SxA`` mesh (all its logical devices in one process), then compare
    their digests leaf by leaf: ``parity_ok`` when every leaf is within
    ``PARITY_ATOL``, and ``residuals_equal`` when the residuals
    (``res_trace``, ``res_masked``) are equal exactly. A failed arm gives
    its ``error``, ``rc`` and ``processes`` instead."""
    import numpy as np

    root = args.out_dir or "artifacts/pods-torch-smoke"
    out_multi = os.path.join(root, "multi")
    out_single = os.path.join(root, "single")
    runs = []
    for procs, local, out in (
        (args.processes, args.local_devices, out_multi),
        (1, args.processes * args.local_devices, out_single),
    ):
        sub = argparse.Namespace(**vars(args))
        sub.processes, sub.local_devices, sub.out_dir = procs, local, out
        if not sub.mesh:
            # The SAME mesh shape on both arms (auto would resolve
            # differently for different process counts).
            a = _agents_div(args)
            sub.mesh = f"{args.processes * args.local_devices // a}x{a}"
        result, rc, tail = spawn_pod(sub)
        if rc:
            return {"error": tail, "rc": rc, "mode": "parity-check",
                    "processes": procs}
        runs.append(result)

    a = np.load(os.path.join(out_multi, "parity.npz"))
    b = np.load(os.path.join(out_single, "parity.npz"))
    diffs = {k: float(np.abs(a[k].astype(np.float64)
                             - b[k].astype(np.float64)).max())
             for k in a.files if k in b.files}
    return {
        "mode": "parity-check", "atol": PARITY_ATOL,
        "parity_ok": set(a.files) == set(b.files) and all(
            d <= PARITY_ATOL for d in diffs.values()),
        "max_diffs": diffs,
        "residuals_equal": all(
            np.array_equal(a[k], b[k])
            for k in ("res_trace", "res_masked") if k in a.files),
        "multi": runs[0].get("mesh"), "single": runs[1].get("mesh"),
        "n_processes": args.processes, "device": args.device,
        "out_dirs": {"multi": out_multi, "single": out_single},
        "workers": {"multi": runs[0]["workers"],
                    "single": runs[1]["workers"]},
        "spawn_to_result_s": {"multi": runs[0]["spawn_to_result_s"],
                              "single": runs[1]["spawn_to_result_s"]},
    }


def check_parity(args) -> int:
    """:func:`parity_report` as one printed JSON line; exit 1 on a
    mismatch, the failed arm's code when one failed."""
    row = parity_report(args)
    print(json.dumps(row), flush=True)
    if "error" in row:
        return row["rc"]
    return 0 if row["parity_ok"] else 1


def _agents_div(args) -> int:
    """Largest agent-shard count dividing both n and the per-process
    device count (the pods auto rule, parent-side)."""
    return max(
        d for d in range(1, min(args.local_devices, args.n) + 1)
        if args.n % d == 0 and args.local_devices % d == 0
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", action="store_true",
                    help=argparse.SUPPRESS)  # internal: one pod process.
    ap.add_argument("--mode", default="parity",
                    choices=["parity", "bench", "resume"])
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4,
                    help="logical shards of each process")
    ap.add_argument("--mesh", default="",
                    help="SxA force (default: pods auto resolution / "
                         "TAT_PODS_MESH)")
    ap.add_argument("--n", type=int, default=8, help="agents per scenario")
    ap.add_argument("--scenarios", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--max-iter", type=int, default=4)
    ap.add_argument("--inner-iters", type=int, default=None,
                    help="inner ADMM iterations (default: parity 8, "
                         "bench the controller's bench default)")
    ap.add_argument("--consensus-impl", default="auto",
                    help="the agent shards' exchange (parallel.ring: "
                         "allreduce, ring, pallas_ring or auto)")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=4,
                    help="resume mode: chunk count")
    ap.add_argument("--controller", default="cadmm",
                    choices=["cadmm", "dd"])
    ap.add_argument("--device", default="cuda",
                    help="where every worker computes: cuda (default) or "
                         "cpu")
    ap.add_argument("--out-dir", default="")
    ap.add_argument("--trace", default="",
                    help="resume mode: write a stitched cross-process "
                         "Chrome/Perfetto trace to this path (each "
                         "worker records spans on its own p{pid}ofN "
                         "track into the shared run dir)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--resume", action="store_true",
                    help="resume mode: continue a preempted run_dir")
    ap.add_argument("--stop-after-chunk", type=int, default=None,
                    help="resume mode: simulate preemption at boundary K")
    ap.add_argument("--masked", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="parity mode: include the alive-masked, fault-"
                         "injected control step (--no-masked: cheaper)")
    ap.add_argument("--check-parity", action="store_true",
                    help="parity mode: ALSO run the single-process pod "
                         "and compare the two digests (exit 1 on a "
                         "mismatch)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.worker:
        return run_worker(args)

    if (os.cpu_count() or 1) < 2 and args.processes > 1:
        # N gloo workers time-slicing ONE core wedge the rendezvous more
        # often than they finish.
        why = (f"1-core host (os.cpu_count()={os.cpu_count()}): cannot run "
               f"{args.processes} pod workers reliably")
        if args.device != "cpu":
            # On the card a skip would read as a pass: it is an error.
            print(json.dumps({"error": why}), file=sys.stderr, flush=True)
            return 2
        print(json.dumps({"skipped": why}), flush=True)
        return 0
    if args.trace and (args.mode != "resume" or not args.out_dir):
        raise SystemExit("--trace needs --mode resume and --out-dir (the "
                         "traced chunk driver and the shared run dir the "
                         "stitcher reads)")

    from tpu_aerial_transport_torch import resolve_device

    if resolve_device(args.device).type == "cuda":
        # One build before any worker starts: N cold workers would
        # otherwise each start every nvcc at once.
        from tpu_aerial_transport_torch.ops import _build

        _build.build()

    if args.mode == "parity" and args.check_parity:
        return check_parity(args)
    result, rc, tail = spawn_pod(args)
    if rc:
        print(json.dumps({
            "error": tail, "rc": rc, "mode": args.mode,
        }), flush=True)
        return rc
    if args.trace:
        result["trace"] = stitch_trace(args.out_dir, args.trace)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
