"""The port's environment-knob registry: every ``TAT_*`` / ``TPU_AERIAL_*``
variable the port package, its tools and ``chip_smoke.py`` read, with the
file that resolves it and its documented default.

Pure data, stdlib-only: it imports neither torch nor jax (the lint CLI
loads it by file path). Tier C's HL008 flags any ``os.environ`` read of a
``TAT_*``/``TPU_AERIAL_*`` name in the host tier that is not registered
here, and ``tests/test_torch_lint.py`` greps the port for knob names, so
a knob cannot be added (or retired) without this table.

``resolver`` is the file whose code owns parsing the variable (other files
consume the resolver's output, not the environment); ``default`` is the
behaviour when it is unset. The README's table of the port's knobs is
generated by :func:`readme_table`:
``python -c "import tpu_aerial_transport_torch.analysis.knobs as k; print(k.readme_table())"``.
"""

from __future__ import annotations

KNOBS: dict[str, dict[str, str]] = {
    "TAT_TORCH_BUILD_DIR": {
        "resolver": "tpu_aerial_transport_torch/ops/_build.py",
        "default": "build/kernels beside the package",
        "doc": "Where the CUDA kernels (csrc/*.cu) are built and looked "
               "up; an AOT bundle's libraries are installed there.",
    },
    "TAT_EFFORT": {
        "resolver": "tpu_aerial_transport_torch/ops/socp.py",
        "default": "auto (fixed)",
        "doc": "The controllers' solver effort when the config says "
               "'auto': fixed|adaptive (socp.resolve_effort).",
    },
    "TPU_AERIAL_PRECISION": {
        "resolver": "tpu_aerial_transport_torch/ops/socp.py",
        "default": "auto (f32)",
        "doc": "Operator storage of the whole-solve kernel when the "
               "config says 'auto': f32|bf16 (socp.resolve_precision).",
    },
    "TPU_AERIAL_CONSENSUS": {
        "resolver": "tpu_aerial_transport_torch/parallel/ring.py",
        "default": "auto (allreduce on the CPU, ring on the card)",
        "doc": "Consensus exchange of the agent-sharded controllers: "
               "allreduce|ring|pallas_ring (ring.resolve_consensus).",
    },
    "TAT_ENV_QUERY": {
        "resolver": "tpu_aerial_transport_torch/envs/spatial.py",
        "default": "auto (bucketed above 200 tree slots)",
        "doc": "Environment obstacle-query tier at config build: "
               "dense|bucketed.",
    },
    "TAT_BACKEND_FAULTS": {
        "resolver": "tpu_aerial_transport_torch/resilience/backend.py",
        "default": "empty (no injected faults)",
        "doc": "Fault-injection spec of the backend guard "
               "(FaultInjector.from_env: crash@N, wedge=S, "
               "init_unavailable).",
    },
    "TAT_BACKEND_DEADLINE_S": {
        "resolver": "tpu_aerial_transport_torch/resilience/backend.py",
        "default": "backend.DEFAULT_DEADLINE_S (600 s)",
        "doc": "The guard's watchdog deadline on a primary dispatch.",
    },
    "TAT_EXPECTED_DEVICES": {
        "resolver": "tpu_aerial_transport_torch/resilience/backend.py",
        "default": "unset (no topology expectation)",
        "doc": "Probe gate: the visible device count required.",
    },
    "TAT_EXPECTED_PROCESSES": {
        "resolver": "tpu_aerial_transport_torch/resilience/backend.py",
        "default": "unset (no topology expectation)",
        "doc": "Probe gate: the process count required.",
    },
    "TAT_AOT_BUNDLE_DIR": {
        "resolver": "tpu_aerial_transport_torch/resilience/backend.py",
        "default": "unset (the probe builds its own kernels)",
        "doc": "AOT bundle whose probe entry and kernel libraries the "
               "probe uses.",
    },
    "TAT_FLEET_FAULTS": {
        "resolver": "tpu_aerial_transport_torch/serving/fleet.py",
        "default": "empty (no chaos)",
        "doc": "Fleet chaos-storm plan (FleetFaultPlan.from_env).",
    },
    "TAT_SESSION_LEASE_S": {
        "resolver": "tpu_aerial_transport_torch/serving/sessions.py",
        "default": "30 (seconds)",
        "doc": "Closed-loop session lease: a session with no heartbeat "
               "or step for this long is evicted and its token fenced.",
    },
    "TAT_SLO_BURN_RATES": {
        "resolver": "tpu_aerial_transport_torch/obs/live.py",
        "default": "14.4:6 (fast:slow page/warn thresholds)",
        "doc": "Burn-rate alert thresholds of the live SLO engine, "
               "FAST:SLOW multiples of steady budget spend.",
    },
    "TAT_CONSOLE_REFRESH_S": {
        "resolver": "tpu_aerial_transport_torch/obs/live.py",
        "default": "1.0 (seconds)",
        "doc": "Poll interval of the live followers "
               "(tools/fleet_console.py).",
    },
    "TAT_PODS_MESH": {
        "resolver": "tpu_aerial_transport_torch/parallel/pods.py",
        "default": "auto (from the process count)",
        "doc": "Force an SxA scenario-by-agent pods mesh, e.g. 2x4.",
    },
    "TAT_PODS_COORDINATOR": {
        "resolver": "tpu_aerial_transport_torch/parallel/pods.py",
        "default": "unset (single process)",
        "doc": "Multi-process bootstrap: the process group's address.",
    },
    "TAT_PODS_NUM_PROCESSES": {
        "resolver": "tpu_aerial_transport_torch/parallel/pods.py",
        "default": "unset (single process)",
        "doc": "Multi-process bootstrap: the world size.",
    },
    "TAT_PODS_PROCESS_ID": {
        "resolver": "tpu_aerial_transport_torch/parallel/pods.py",
        "default": "unset (single process)",
        "doc": "Multi-process bootstrap: this process's rank.",
    },
    "TAT_PODS_SPAWN_TS": {
        "resolver": "tpu_aerial_transport_torch/tools/pods_local.py",
        "default": "unset (no boot time reported)",
        "doc": "The harness's spawn time, passed to each worker so it "
               "reports its boot seconds.",
    },
    "TAT_SMOKE_REPORT": {
        "resolver": "chip_smoke.py",
        "default": "build/chip_smoke.json",
        "doc": "Where the chip smoke writes its full JSON report.",
    },
}

# Literal prefixes that appear in environment-filtering code (the
# ``TAT_PODS_`` passthrough into pod workers): they name a family, not a
# knob, and the drift test skips them.
PREFIX_PASSTHROUGHS: frozenset[str] = frozenset({"TAT_PODS_"})


def readme_table() -> str:
    """The README's table of the port's knobs, generated so the docs
    cannot drift from the registry."""
    rows = ["| Knob | Resolver | Default | What it does |",
            "| --- | --- | --- | --- |"]
    for name in sorted(KNOBS):
        k = KNOBS[name]
        rows.append(
            f"| `{name}` | `{k['resolver']}` | {k['default']} "
            f"| {k['doc']} |"
        )
    return "\n".join(rows)
