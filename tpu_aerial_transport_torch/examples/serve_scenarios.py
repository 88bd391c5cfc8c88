"""Scenario-serving demo and acceptance script on the card: a mixed-shape
request stream through the continuous-batching tier
(``tpu_aerial_transport_torch/serving``).

The port's counterpart of ``examples/serve_scenarios.py``. It generates a
deterministic (seeded) stream of heterogeneous ``ScenarioRequest``s --
mixed families (controllers), horizons, initial conditions, deadlines --
feeds them to a ``ScenarioServer`` on a Poisson arrival clock (or in
waves), and prints per-request outcomes and SLO stats as one JSON line.
With ``--run-dir D`` a SIGTERM (or ``--sigterm-after N``) completes at the
chunk boundary and journals the remainder; a second run with ``--resume``
completes it, and the per-request result digests (``--results``) are
bitwise an uninterrupted run's.

It takes the JAX example's flags and ``--device`` (default ``cuda``;
``cpu`` runs the plain PyTorch path). ``--bundle DIR --require-bundle
--expect-zero-compile`` serves the stream from an AOT bundle
(``tpu_aerial_transport_torch/aot``): the kernel libraries installed from
the bundle, the template carries from its ``args_sample``, and exit 3 when
this process ran any ``nvcc`` build (the summary's ``nvcc_builds``, beside
the CUDA graph captures, which no bundle carries).

Usage:
  python3 -m tpu_aerial_transport_torch.examples.serve_scenarios \\
      --requests 64 --buckets 8,16,32
  python3 -m tpu_aerial_transport_torch.examples.serve_scenarios \\
      --bundle build/aot/cuda --require-bundle --expect-zero-compile
  python3 -m tpu_aerial_transport_torch.examples.serve_scenarios \\
      --run-dir runs/serve --resume
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.serving.fleet import result_digest


def make_stream(n_requests: int, families: list[str], chunk_lens: dict,
                seed: int, deadline_s: float | None):
    """The JAX example's deterministic mixed request stream: the same seed
    gives the same stream, so an interrupted and resumed run and an
    uninterrupted one serve identical work."""
    from tpu_aerial_transport_torch.serving.queue import ScenarioRequest

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        fam = families[int(rng.integers(len(families)))]
        horizon = int(rng.integers(1, 4)) * chunk_lens[fam]
        out.append(ScenarioRequest(
            family=fam, horizon=horizon,
            x0=tuple(float(v) for v in rng.normal(0, 1.0, 3)),
            v0=(0.1, 0.0, 0.0),
            deadline_s=deadline_s,
            request_id=f"req{i:05d}",
        ))
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--families", default="cadmm4,centralized4")
    ap.add_argument("--buckets", default="8,16,32")
    ap.add_argument("--capacity", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--poisson-rate", type=float, default=0.0,
                    help="mean arrivals/s (0 = submit everything up "
                         "front); late arrivals join at chunk boundaries")
    ap.add_argument("--waves", type=int, default=1,
                    help="submit the stream in N deterministic bursts: a "
                         "big first wave (oversubscribes the largest "
                         "bucket) then smaller idle-separated waves")
    ap.add_argument("--waves-spec", default="",
                    help="explicit comma-separated wave sizes (overrides "
                         "--waves); must sum to <= --requests")
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--surgery", default="",
                    help="boundary lane-surgery impl: host|device "
                         "(default host)")
    ap.add_argument("--dispatch", default="",
                    help="chunk dispatch mode: sync|pipelined (pipelined "
                         "enqueues chunk k+1 early and forces device "
                         "surgery)")
    ap.add_argument("--cache", type=int, default=0,
                    help="content-addressed result cache size (0 = off)")
    ap.add_argument("--run-dir", default="")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--metrics", default="")
    ap.add_argument("--trace", default="",
                    help="write a Chrome/Perfetto trace of the stream to "
                         "this path")
    ap.add_argument("--results", default="",
                    help="write per-request {id: {status, digest}} JSON")
    ap.add_argument("--sigterm-after", type=int, default=0,
                    help="test hook: raise SIGTERM in-process after N "
                         "pump rounds (graceful boundary preemption)")
    ap.add_argument("--bundle", default="",
                    help="serve from this AOT bundle directory")
    ap.add_argument("--require-bundle", action="store_true",
                    help="admit only families and buckets the bundle "
                         "covers, with no eager fallback")
    ap.add_argument("--expect-zero-compile", action="store_true",
                    help="exit 3 when this process ran any nvcc build")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def process_counters() -> dict:
    """What this process paid and launched: its ``nvcc`` builds, its CUDA
    graph captures (count and host seconds) and its kernel launches by
    kernel name."""
    from tpu_aerial_transport_torch.harness import cuda_graph
    from tpu_aerial_transport_torch.ops import _build, admm_kernel
    from tpu_aerial_transport_torch.parallel import ring

    launches = {**admm_kernel.KERNEL_LAUNCHES,
                **admm_kernel.CHUNK_LAUNCHES, **ring.LAUNCHES}
    return {"nvcc_builds": _build.nvcc_builds(),
            "graph_captures": cuda_graph.PROCESS_CAPTURES["captures"],
            "graph_capture_s": cuda_graph.PROCESS_CAPTURES["capture_s"],
            "kernel_launches": {k: v for k, v in launches.items() if v}}


def zero_compile_exit(tool: str, counters: dict) -> int:
    """``--expect-zero-compile``'s verdict: 3 (and a line on stderr) when
    the process ran ``nvcc``, else 0."""
    if counters["nvcc_builds"]:
        print(f"{tool}: NOT zero-compile: {counters['nvcc_builds']} nvcc "
              "builds", file=sys.stderr)
        return 3
    return 0


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)

    from tpu_aerial_transport_torch.obs import export as export_mod
    from tpu_aerial_transport_torch.obs import trace as trace_lib
    from tpu_aerial_transport_torch.resilience.recovery import (
        GracefulInterrupt,
    )
    from tpu_aerial_transport_torch.serving import batcher
    from tpu_aerial_transport_torch.serving import server as server_mod

    t0 = time.perf_counter()
    family_names = [f for f in args.families.split(",") if f]
    buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    chunk_lens = {name: batcher.CANONICAL_FAMILIES[name].chunk_len
                  for name in family_names}
    tracer = None
    if args.trace:
        # Spans also land as trace_event rows in the metrics jsonl when
        # one is configured (one durable record, two renderings).
        sink = (export_mod.MetricsWriter(args.metrics)
                if args.metrics else None)
        tracer = trace_lib.Tracer(sink, track="server")
    kw = dict(
        families=family_names, buckets=buckets, capacity=args.capacity,
        run_dir=args.run_dir or None,
        metrics=(tracer.sink if tracer is not None and tracer.sink
                 else args.metrics or None),
        tracer=tracer,
        surgery=args.surgery or None, dispatch=args.dispatch or None,
        cache=(args.cache or None), device=device,
        bundle=args.bundle or None, require_bundle=args.require_bundle,
    )

    with GracefulInterrupt() as interrupt:
        if args.resume:
            server = server_mod.ScenarioServer.resume(
                args.run_dir, **{k: v for k, v in kw.items()
                                 if k != "run_dir"})
            server.interrupt = interrupt
            # Replay the (seed-deterministic) stream, deduped against the
            # journal: requests the preempted run never submitted are
            # served now; restored/completed ones are not resubmitted.
            stream = [
                r for r in make_stream(args.requests, family_names,
                                       chunk_lens, args.seed,
                                       args.deadline_s)
                if r.request_id not in server.tickets
                and r.request_id not in server.done_requests
            ]
        else:
            server = server_mod.ScenarioServer(interrupt=interrupt, **kw)
            stream = make_stream(args.requests, family_names, chunk_lens,
                                 args.seed, args.deadline_s)

        rng_wait = (1.0 / args.poisson_rate) if args.poisson_rate else 0.0
        arrival_rng = np.random.default_rng(args.seed + 1)
        next_due = t0
        wave_sizes = []
        if args.resume:
            pass  # the replayed tail submits up front.
        elif args.waves_spec and stream:
            wave_sizes = [int(w) for w in args.waves_spec.split(",") if w]
            if sum(wave_sizes) > len(stream):
                raise SystemExit("--waves-spec sums past --requests")
            wave_sizes[-1] += len(stream) - sum(wave_sizes)
        elif args.waves > 1 and stream:
            left = len(stream)
            first = max(1, (3 * left) // 4)
            wave_sizes.append(first)
            left -= first
            for w in range(args.waves - 1):
                take = ((left + 1) // 2 if w < args.waves - 2 else left)
                if take:
                    wave_sizes.append(take)
                left -= take
        rounds = 0
        while stream or server.has_work():
            if wave_sizes:
                if not server.has_work() and stream:
                    for _ in range(wave_sizes.pop(0)):
                        server.submit(stream.pop(0))
            else:
                while stream and (not rng_wait
                                  or time.perf_counter() >= next_due):
                    server.submit(stream.pop(0))
                    if rng_wait:
                        next_due += arrival_rng.exponential(rng_wait)
            more = server.pump()
            rounds += 1
            if args.sigterm_after and rounds == args.sigterm_after:
                os.kill(os.getpid(), 15)  # handled by GracefulInterrupt.
            if server.preempted:
                break
            if not more and stream and rng_wait:
                time.sleep(min(0.01, rng_wait))
    if device.type == "cuda":
        torch.cuda.synchronize()

    wall_s = time.perf_counter() - t0
    stats = server.stats()
    results = {
        rid: {
            "status": t.status,
            **({"reason": t.reason} if t.reason else {}),
            **({"digest": result_digest(t.result)}
               if t.result is not None else {}),
        }
        for rid, t in sorted(server.tickets.items())
    }
    if args.results:
        with open(args.results, "w") as fh:
            json.dump(results, fh, indent=1)
    trace_summary = {}
    if tracer is not None and tracer.rows:
        trace_lib.write_chrome_trace(args.trace,
                                     trace_lib.stitch(tracer.rows))
        cp = trace_lib.critical_path(tracer.rows)
        trace_summary = {
            "trace": args.trace,
            "trace_spans": len(tracer.rows),
            "critical_path_p99": {
                seg: round(st["p99"], 4)
                for seg, st in cp["per_segment"].items()
            },
        }
    summary = {
        "mode": ("resume" if args.resume
                 else "bundled" if args.bundle else "eager"),
        "wall_s": round(wall_s, 3),
        "rounds": rounds,
        **trace_summary,
        "scenario_mpc_steps_per_sec": (
            round(stats["scenario_steps"] / wall_s, 2) if wall_s else None
        ),
        **stats,
        **({"card": torch.cuda.get_device_name(device)}
           if device.type == "cuda" else {}),
        **process_counters(),
    }
    print(json.dumps(summary), flush=True)
    if args.expect_zero_compile:
        return zero_compile_exit("serve_scenarios", summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
