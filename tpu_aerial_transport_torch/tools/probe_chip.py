#!/usr/bin/env python3
"""Probe the card's liveness under a watchdog and append one timestamped
attempt record to a log: when the card is wedged, the run carries an
explicit attempt log instead of a silent absence of numbers. Exit 0 only
if the card answered (a probe that ran on the CPU is a failure).

The port's counterpart of the JAX package's ``tools/probe_chip.py``. The
probe body is the port's ``resilience.backend.probe_subprocess``, loaded
by FILE PATH (the module is stdlib-only at module scope), so this process
never initialises CUDA itself: a child process runs cold CUDA
initialisation, a matmul and a bfloat16 round trip, under the
``--timeout`` watchdog.

The log is ``build/probe_chip.log`` beside the package (the gitignored
build directory); ``--log`` overrides it. ``--device cpu`` probes the
host, and then the CPU is the answer asked for.

Usage:
  python -m tpu_aerial_transport_torch.tools.probe_chip [--timeout 60] \\
      [--bundle-dir DIR] [--log PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import datetime
import importlib.util
import os
import sys

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG = os.path.join(os.path.dirname(_PKG), "build", "probe_chip.log")
_BACKEND_PY = os.path.join(_PKG, "resilience", "backend.py")
_BACKEND_MODULE = "_tat_torch_backend_pathload"


def _backend_mod():
    """``resilience/backend.py`` loaded without importing the package
    (whose ``__init__`` imports torch)."""
    if _BACKEND_MODULE in sys.modules:
        return sys.modules[_BACKEND_MODULE]
    spec = importlib.util.spec_from_file_location(_BACKEND_MODULE,
                                                  _BACKEND_PY)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_BACKEND_MODULE] = mod
    spec.loader.exec_module(mod)
    return mod


def probe(timeout_s: float = 60, bundle_dir: str | None = None,
          notes: list | None = None,
          device: str = "cuda") -> tuple[bool, str]:
    """``(ok, detail)`` of one watchdogged probe. ``bundle_dir`` (or the
    ``TAT_AOT_BUNDLE_DIR`` env var) makes the probe prefer the AOT bundle's
    libraries, so a cold probe cannot spend its deadline in ``nvcc``; a
    bundle problem falls back to the plain probe and shows in ``notes``."""
    ok, detail = _backend_mod().probe_subprocess(
        timeout_s=timeout_s, bundle_dir=bundle_dir, notes=notes,
        device=device,
    )
    if ok and device != "cpu" and detail == "cpu":
        return False, "silent CPU fallback (platform=cpu)"
    return ok, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--timeout", type=float, default=60)
    ap.add_argument("--bundle-dir", default=None,
                    help="AOT bundle whose libraries the probe prefers "
                         "(default: TAT_AOT_BUNDLE_DIR)")
    ap.add_argument("--log", default=LOG,
                    help=f"attempt log to append to (default {LOG})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    notes: list = []
    ok, detail = probe(timeout_s=args.timeout, bundle_dir=args.bundle_dir,
                       notes=notes, device=args.device)
    stamp = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%d %H:%M:%S UTC"
    )
    note_s = ("  " + " ".join(notes)) if notes else ""
    line = f"{stamp}  {'ALIVE' if ok else 'DOWN'}  {detail}{note_s}"
    os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
    with open(args.log, "a") as fh:
        fh.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
