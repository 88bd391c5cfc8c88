#!/usr/bin/env python3
"""torchlint CLI: the port's static analysis and its registry contracts.

Usage:
    python tpu_aerial_transport_torch/tools/lint.py [paths...]   # Tier A
    python tpu_aerial_transport_torch/tools/lint.py --host       # Tier C
    python tpu_aerial_transport_torch/tools/lint.py --list-rules
    python tpu_aerial_transport_torch/tools/lint.py --format json [paths]
    python tpu_aerial_transport_torch/tools/lint.py --disable TL003 [paths]
    python tpu_aerial_transport_torch/tools/lint.py --contracts \\
        [--device cpu|cuda] [--only NAME,...]                   # + Tier B

Tier A (the TL rules, ``analysis/rules.py``) lints the port package (or
the paths given); Tier C (the HL rules, ``analysis/hostrules.py``) lints
its host tier. Both are loaded here by FILE PATH, with the modules they
need (``rules``, ``entrypoints``, ``hostflow``, ``knobs``, ``hostrules``,
``linter``), so a run imports neither torch nor jax: run by path as above
on a host with no stack at all. (``python -m
tpu_aerial_transport_torch.tools.lint`` runs the same, but imports the
package, and so torch, first.) Tier B (``--contracts``) imports the
package and runs ``analysis.contracts.run_contracts`` on ``--device``.

Exit status: 0 clean, 1 error findings (warnings too with
``--strict-warn``), 2 when ``--assert-no-torch`` finds torch or jax
imported by a Tier A or C run.
"""

import importlib.util
import os
import sys

_ANALYSIS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "analysis"
)


def _load_by_path(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_ANALYSIS, f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    # Siblings first, so linter's and hostrules' path-loaded imports
    # resolve to these modules.
    for name in ("rules", "entrypoints", "hostflow", "knobs", "hostrules"):
        _load_by_path(name)
    return _load_by_path("linter").main(argv)


if __name__ == "__main__":
    sys.exit(main())
