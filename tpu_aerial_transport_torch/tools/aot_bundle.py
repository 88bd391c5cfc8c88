"""AOT bundle CLI: build, check, diff and serve the entry-point registry's
bundles (``tpu_aerial_transport_torch/aot/``).

The port's counterpart of the JAX package's ``tools/aot_bundle.py``.

Usage::

    python3 -m tpu_aerial_transport_torch.tools.aot_bundle build \\
        --out build/aot/cuda [--device cuda|cpu] [--entry NAME ...] \\
        [--manifest-only] [--batch-buckets 8,16]
    python3 -m tpu_aerial_transport_torch.tools.aot_bundle check BUNDLE_DIR
    python3 -m tpu_aerial_transport_torch.tools.aot_bundle diff BUNDLE_DIR
    python3 -m tpu_aerial_transport_torch.tools.aot_bundle serve \\
        --entry NAME --mode bundled|cached|cold [--bundle DIR] \\
        [--device cuda|cpu] [--expect-zero-compile]

``build`` runs each entry once on the device (the card by default) and
writes the bundle: on the card it carries every kernel library of
``csrc/`` (built first when missing). ``check`` diffs the bundle's
coverage (entry names and shape signatures) against the LIVE registry and
exits 1 on drift; ``diff`` prints the same as JSON.

``serve`` is the cold-start driver: a fresh process serves one registered
entry and prints one JSON line with the time to the first result from
after the imports (``ttfs_s``), of it the inputs' set-up (``setup_s``:
the device, the bundle's sample or the registry's arguments) and the serve
call (``serve_s``: in ``bundled`` mode the registry's callable built and
the libraries installed, ``install_s``, inside it), the rung,
``nvcc_builds`` (the kernel libraries this process compiled, the port's
counterpart of the JAX traces, lowerings and backend compiles) and the
CUDA graph captures beside them (which no bundle carries). Modes:
``bundled`` serves from ``--bundle`` on its recorded sample arguments;
``cached`` serves the registry's callable with the build directory as it
is; ``cold`` does so with a new, empty build directory, so that the
process compiles every library it launches. ``--expect-zero-compile``
exits 3 unless ``nvcc_builds == 0``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time


def cmd_build(args) -> int:
    from tpu_aerial_transport_torch.aot import bundle as bundle_mod

    buckets = [int(b) for b in args.batch_buckets.split(",") if b]
    t0 = time.perf_counter()
    manifest = bundle_mod.build_bundle(
        args.out, names=args.entry or None, device=args.device or None,
        manifest_only=args.manifest_only, batch_buckets=buckets,
        progress=lambda name: print(f"# building {name}", flush=True))
    print(json.dumps({
        "bundle": args.out,
        "platform": manifest["platform"],
        "entries": len(manifest["entries"]),
        "skipped": len(manifest["skipped"]),
        "kernels": sorted(manifest["kernels"]),
        "variants": sum(len(e["variants"])
                        for e in manifest["entries"].values()),
        "manifest_only": manifest["manifest_only"],
        "build_s": round(time.perf_counter() - t0, 3),
    }))
    return 0


def _diff(bundle_dir: str, device: str | None) -> dict:
    from tpu_aerial_transport_torch.aot import bundle as bundle_mod

    return bundle_mod.coverage_diff(bundle_mod.read_manifest(bundle_dir),
                                    device=device)


def cmd_check(args) -> int:
    diff = _diff(args.bundle, args.device or None)
    if diff["ok"]:
        print(f"aot_bundle check: OK ({args.bundle} covers the registry)")
        return 0
    for kind in ("missing", "stale", "changed", "uncovered_skips"):
        for item in diff[kind]:
            print(f"aot_bundle check [{kind}]: {item}")
    print("aot_bundle check: DRIFT -- the entry-point registry and the "
          "bundle disagree; rebuild with: python3 -m "
          "tpu_aerial_transport_torch.tools.aot_bundle build --out "
          f"{args.bundle}" + (" --manifest-only" if args.manifest_hint
                              else ""))
    return 1


def cmd_diff(args) -> int:
    print(json.dumps(_diff(args.bundle, args.device or None), indent=1))
    return 0


def cmd_serve(args) -> int:
    if args.mode != "cold":
        return _serve(args)
    # Before anything can load a library: this process builds its own, in
    # a build directory that is gone (and no longer named) afterwards.
    key = "TAT_TORCH_BUILD_DIR"
    saved = os.environ.get(key)
    cold_dir = tempfile.mkdtemp(prefix="tat-cold-build-")
    os.environ[key] = cold_dir
    try:
        return _serve(args)
    finally:
        if saved is None:
            os.environ.pop(key, None)
        else:
            os.environ[key] = saved
        shutil.rmtree(cold_dir, ignore_errors=True)


def _serve(args) -> int:
    import torch

    from tpu_aerial_transport_torch import resolve_device
    from tpu_aerial_transport_torch.aot import bundle as bundle_mod
    from tpu_aerial_transport_torch.aot import loader as loader_mod
    from tpu_aerial_transport_torch.harness import cuda_graph
    from tpu_aerial_transport_torch.ops import _build

    # The clock starts after the imports (a replica pays them once at
    # deploy) and before the device, the bundle, the inputs and the call.
    t0 = time.perf_counter()
    dev = resolve_device(args.device)
    bundle = loader_mod.load_bundle(args.bundle) if args.bundle else None
    if args.mode == "bundled":
        if bundle is None:
            raise SystemExit("--mode bundled needs --bundle")
        call_args = bundle.sample_args(args.entry, device=dev)
        fn = None
    else:
        from tpu_aerial_transport_torch.analysis import contracts

        fn, make_args = contracts.REGISTRY[args.entry].build(dev)
        call_args = make_args()
    t_serve = time.perf_counter()
    _, rung = loader_mod.serve_entry(
        bundle if args.mode == "bundled" else None, args.entry, call_args,
        fn=fn, jit_fallback=fn)
    now = time.perf_counter()
    out = {"entry": args.entry, "mode": args.mode, "device": dev.type,
           "ttfs_s": now - t0, "setup_s": t_serve - t0,
           "serve_s": now - t_serve, "rung": rung,
           "install_s": bundle.install_s if bundle is not None else 0.0,
           "nvcc_builds": _build.nvcc_builds(),
           "graph_captures": cuda_graph.PROCESS_CAPTURES["captures"],
           "graph_capture_s": cuda_graph.PROCESS_CAPTURES["capture_s"],
           "launches": {k: v for k, v in
                        bundle_mod.library_launches().items() if v}}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
    print(json.dumps(out), flush=True)
    if args.expect_zero_compile and out["nvcc_builds"]:
        print(f"aot_bundle serve: NOT zero-compile: {out['nvcc_builds']} "
              "nvcc builds", file=sys.stderr)
        return 3
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build a bundle from the registry")
    b.add_argument("--out", required=True)
    b.add_argument("--device", default="",
                   help="cuda or cpu (default: the card when one is "
                        "visible)")
    b.add_argument("--entry", action="append", default=[],
                   help="restrict to these registry entries (repeatable)")
    b.add_argument("--manifest-only", action="store_true",
                   help="record coverage (names and signatures) without "
                        "running anything")
    b.add_argument("--batch-buckets", default="",
                   help="comma-separated scenario-batch bucket sizes for "
                        "the batched entries (bucket_dim grid)")
    b.set_defaults(fn=cmd_build)

    for name, fn, hlp in (("check", cmd_check, "fail on registry drift"),
                          ("diff", cmd_diff, "report drift as JSON")):
        c = sub.add_parser(name, help=hlp)
        c.add_argument("bundle")
        c.add_argument("--device", default="",
                       help="the device the live signatures are taken on "
                            "(default: the card when one is visible)")
        if name == "check":
            c.add_argument("--manifest-hint", action="store_true",
                           help="phrase the rebuild hint for a "
                                "manifest-only bundle")
        c.set_defaults(fn=fn)

    s = sub.add_parser("serve", help="cold-start measurement driver")
    s.add_argument("--entry", required=True)
    s.add_argument("--mode", required=True,
                   choices=["bundled", "cached", "cold"])
    s.add_argument("--bundle", default="")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.add_argument("--expect-zero-compile", action="store_true",
                   help="exit 3 unless nvcc_builds == 0")
    s.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
