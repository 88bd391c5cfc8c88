#!/usr/bin/env python3
"""CI gate: the port's own checks chained in one process; exit 1 if any
fails.

The port's counterpart of the JAX package's ``tools/ci_check.sh``:

1. lint Tier A (the TL rules) over the paths given (default: the port
   package and ``chip_smoke.py``), and Tier C (the HL rules) over the
   port's host tier;
2. ``run_health --validate`` over ``<artifacts>/*.metrics.jsonl``;
3. ``trace_view --validate`` over ``<artifacts>/*.trace.json``;
4. ``black --check`` and ``isort --check-only`` over the paths, each
   skipped with a notice when the formatter is not installed.

Every step runs in this process (no child is started) and reads files
only: nothing runs on a device. The JAX script's pods, fleet, session and
AOT smokes start processes on the accelerator; their port runs are phases
39 (the fleet), 40 (pods), 38 and 37 (the session storm) and 41 (bundled
serving) of ``chip_smoke.py`` on the card, which this gate names and does
not start.

Usage:
  python -m tpu_aerial_transport_torch.tools.ci_check [paths...] \\
      [--artifacts artifacts]
"""

from __future__ import annotations

import argparse
import glob
import importlib.util
import os
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
DEFAULT_PATHS = (_PKG, os.path.join(_REPO, "chip_smoke.py"))
# The JAX script's process smokes and where the port runs them instead.
CARD_SMOKES = {
    "pods 2-process parity smoke": "chip_smoke.py phase 40",
    "serving fleet 2-replica smoke": "chip_smoke.py phase 39",
    "closed-loop session smoke": "chip_smoke.py phases 37 and 38",
    "aot bundle coverage": "chip_smoke.py phase 41",
}


def _formatter(module: str, argv: list[str]) -> int | None:
    """Exit status of ``module``'s command line run in this process, or
    None when it is not installed."""
    if importlib.util.find_spec(module) is None:
        return None
    if module == "black":
        import black

        runner = black.main
    else:
        from isort import main as isort_main

        runner = isort_main.main
    try:
        runner(argv)
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else int(bool(e.code))
    return 0


def _gate(name: str, fn, *args) -> bool:
    print(f"== {name} ==", flush=True)
    return fn(*args) == 0


def check(paths: list[str], artifacts: str) -> int:
    """Every gate in turn; 1 if any failed."""
    from tpu_aerial_transport_torch.tools import lint, run_health, trace_view

    ok = True
    ok &= _gate("lint Tier A", lint.main, list(paths))
    ok &= _gate("lint --host (Tier C)", lint.main, ["--host"])
    metrics = sorted(glob.glob(os.path.join(artifacts, "*.metrics.jsonl")))
    if metrics:
        ok &= _gate("metrics jsonl schema (run_health --validate)",
                    run_health.main, ["--validate", *metrics])
    else:
        print(f"== metrics jsonl schema: no {artifacts}/*.metrics.jsonl, "
              "skipped ==")
    traces = sorted(glob.glob(os.path.join(artifacts, "*.trace.json")))
    if traces:
        ok &= _gate("trace-event json (trace_view --validate)",
                    trace_view.main, ["--validate", *traces])
    else:
        print(f"== trace-event json: no {artifacts}/*.trace.json, "
              "skipped ==")
    for module, argv in (("black", ["--check", "--quiet", *paths]),
                         ("isort", ["--check-only", "--quiet", *paths])):
        rc = _formatter(module, argv)
        if rc is None:
            print(f"== {module}: not installed, skipped ==")
        else:
            print(f"== {module} ==")
            ok &= rc == 0
    for smoke, where in CARD_SMOKES.items():
        print(f"== {smoke}: runs on the card in {where} ==")
    print("ci_check: OK" if ok else "ci_check: FAILED", flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="*",
                    help="paths to lint and format-check (default: the "
                         "port package and chip_smoke.py)")
    ap.add_argument("--artifacts", default="artifacts",
                    help="directory whose *.metrics.jsonl and *.trace.json "
                         "files are validated (default: artifacts)")
    args = ap.parse_args(argv)
    return check(args.paths or list(DEFAULT_PATHS), args.artifacts)


if __name__ == "__main__":
    sys.exit(main())
