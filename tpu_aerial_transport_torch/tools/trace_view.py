#!/usr/bin/env python3
"""Trace viewer/exporter: stitch ``trace_event`` rows into one
Chrome/Perfetto trace, and validate emitted trace files (the ci gate).

The port's counterpart of the JAX package's ``tools/trace_view.py``: a
thin CLI over the port's ``obs/trace.py`` (the span layer, stitcher,
Chrome converter and critical-path accountant all live there), loaded by
FILE PATH, so a run imports neither torch nor jax. It reads the rows
either package writes.

Usage:
  # One or more metrics jsonl files, or run DIRECTORIES (every *.jsonl
  # inside is read; a pods run dir's shard manifest names how many
  # process tracks make the trace complete):
  python tpu_aerial_transport_torch/tools/trace_view.py \\
      RUN_DIR_OR_JSONL... --out out.trace.json

  # Critical-path accounting (per-request queue/batch/device/harvest/
  # retry segments) as JSON:
  python tpu_aerial_transport_torch/tools/trace_view.py \\
      RUN.metrics.jsonl --critical-path

  # CI gate: structural validation of emitted trace files (well-formed
  # trace-event JSON, per-track monotone non-overlapping slices, every
  # span's parent present); exit 1 on any violation:
  python tpu_aerial_transport_torch/tools/trace_view.py \\
      --validate artifacts/*.trace.json

(``python -m tpu_aerial_transport_torch.tools.trace_view`` runs the same,
but imports the package, and so torch, first.) Load the emitted file at
https://ui.perfetto.dev (or chrome://tracing): one process row per track
(server process / pods process), one thread row per span name.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

# The port's own name for the by-path module, so a process that also loads
# the JAX package's viewer (which registers ``tat_obs_trace``) keeps both.
_TRACE_MODULE = "tat_torch_obs_trace"


def _trace_module():
    """The port's ``obs/trace.py``, loaded by file path (stdlib only), so
    the package ``__init__`` -- which imports torch -- never runs."""
    if _TRACE_MODULE in sys.modules:
        return sys.modules[_TRACE_MODULE]
    spec = importlib.util.spec_from_file_location(
        _TRACE_MODULE,
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "obs", "trace.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    # Registered BEFORE exec: dataclass processing under `from __future__
    # import annotations` resolves the defining module via sys.modules.
    sys.modules[_TRACE_MODULE] = mod
    spec.loader.exec_module(mod)
    return mod


trace_mod = _trace_module()


def collect_rows(paths: list[str]) -> list[dict]:
    """Stitched trace rows from a mix of jsonl files and run dirs."""
    rows: list[dict] = []
    for path in paths:
        if os.path.isdir(path):
            rows.extend(trace_mod.stitch_run_dir(path))
        else:
            rows.extend(
                trace_mod.trace_rows(trace_mod._read_jsonl(path))
            )
    # stitch() is idempotent on already-stitched rows (the t0/t1 fields
    # are recomputed from the same anchors), so one final pass unifies
    # the mixed-source case.
    return trace_mod.stitch(rows)


def validate(paths: list[str]) -> int:
    """``--validate``: 1 if any file breaks the trace-event contract."""
    failed = False
    for path in paths:
        errs = trace_mod.validate_trace_file(path)
        if errs:
            failed = True
            print(f"{path}: {len(errs)} violation(s)", file=sys.stderr)
            for e in errs[:20]:
                print(f"  {e}", file=sys.stderr)
        else:
            print(f"{path}: OK")
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("paths", nargs="+",
                    metavar="RUN_DIR_OR_JSONL_OR_TRACE")
    ap.add_argument("--out", default="",
                    help="write Chrome/Perfetto trace-event JSON here")
    ap.add_argument("--critical-path", action="store_true",
                    help="print the per-request critical-path "
                         "decomposition as JSON")
    ap.add_argument("--validate", action="store_true",
                    help="paths are emitted *.trace.json files: "
                         "structural validation only (ci gate), exit 1 "
                         "on any violation")
    args = ap.parse_args(argv)

    if args.validate:
        return validate(args.paths)

    rows = collect_rows(args.paths)
    if not rows:
        print("no trace_event rows found (tracing off, or wrong files?)",
              file=sys.stderr)
        return 1
    summary = {
        "rows": len(rows),
        "tracks": sorted({r.get("track", "?") for r in rows}),
        "traces": len({r["trace_id"] for r in rows}),
    }
    if args.out:
        obj = trace_mod.write_chrome_trace(args.out, rows)
        errs = trace_mod.validate_chrome_trace(obj)
        if errs:  # never publish a trace the ci gate would reject.
            for e in errs[:20]:
                print(f"  {e}", file=sys.stderr)
            return 1
        summary["out"] = args.out
        summary["events"] = len(obj["traceEvents"])
    if args.critical_path:
        summary["critical_path"] = trace_mod.critical_path(rows)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
