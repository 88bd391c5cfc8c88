"""The per-layer metric readers on a small synthetic Chrome trace, and the
frozen trace arithmetic against the port's ``tools/op_profile.py``."""

from __future__ import annotations

import pytest

from port_bench import harness
from port_bench import trace as tr
from port_bench import yardstick


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    if cat in tr.DEVICE_CATS:
        e["pid"], e["tid"] = 0, 7
    return e


def synthetic():
    """Two profiled steps of 1000 us: in each, an environment kernel of
    100 us launched under ``tat.env_query``, a graph of two kernels (100 us
    each) under ``tat.dynamics``, and one warp solve of 50 us under
    ``tat.fused_solve`` in ``tat.local_solve``."""
    out = []
    for k in range(2):
        t = 1000.0 * k
        c = 10 * k
        out += [
            ev("user_annotation", "bench.step", t, 1000),
            ev("user_annotation", "tat.env_query", t + 100, 200),
            ev("cpu_op", "aten::mul", t + 110, 40),
            ev("cuda_runtime", "cudaLaunchKernel", t + 120, 10, c + 1),
            ev("kernel", "elementwise_kernel", t + 150, 100, c + 1),
            ev("user_annotation", "tat.dynamics", t + 400, 200),
            ev("cuda_runtime", "cudaGraphLaunch", t + 410, 20, c + 2),
            ev("kernel", "graph_a", t + 450, 100, c + 2),
            ev("kernel", "graph_b", t + 550, 100, c + 2),
            ev("user_annotation", "tat.local_solve", t + 700, 250),
            ev("user_annotation", "tat.fused_solve", t + 720, 100),
            ev("cpu_op", "aten::cat", t + 705, 10),
            ev("cuda_runtime", "cudaLaunchKernel", t + 730, 10, c + 3),
            ev("kernel", "void warp_solve_kernel<48>(float*)", t + 800, 50,
               c + 3),
        ]
    return {"traceEvents": out}


def view(record=None):
    return harness.TraceView(synthetic(), 2, record or {})


def read(name, v):
    return harness.load_module(
        f"{harness.HERE}/metrics/{name}.py", "m_" + name).read(v)


def test_device_idle_pct():
    # Busy 100 + 200 + 50 of each 1000 us step.
    assert read("device_idle_pct", view()) == pytest.approx(65.0)


def test_env_query_and_dynamics_ms_per_step():
    assert read("env_query_ms_per_step", view()) == pytest.approx(0.1)
    assert read("dynamics_ms_per_step", view()) == pytest.approx(0.2)


def test_host_metrics():
    v = view()
    # The three phase ranges hold every host event but the step range,
    # whose own time is left out: 200 + 200 + 250 us a step.
    assert read("host_ms_per_step", v) == pytest.approx(0.65)
    # local_solve's own 250 - 100 - 10 us, fused_solve's 100 - 10, the
    # cat's 10 and the launch's 10, a step.
    assert read("solver_host_ms_per_step", v) == pytest.approx(0.25)


def test_consensus_iters_per_step():
    assert read("consensus_iters_per_step", view()) is None
    assert read("consensus_iters_per_step",
                view({"consensus_iters_per_step": 20.5})) == 20.5


def test_roofline_readers():
    assert read("warp_solve_roofline_pct", view()) is None
    work = {"warp_solve_kernel": {"bytes_per_launch": 33.5e6,
                                  "flops_per_launch": 1e6}}
    # 33.5 MB at 3.35 TB/s is 10 us of each 50 us launch.
    assert read("warp_solve_roofline_pct",
                view({"solve_work": work})) == pytest.approx(20.0)
    assert read("block_solve_roofline_pct",
                view({"solve_work": work})) is None
    early = {"fused_solve_early_kernel": {"bytes": 0, "flops": 67e6,
                                          "launches": 2}}
    assert read("block_solve_roofline_pct",
                view({"solve_work": early})) is None


def test_readers_without_a_trace():
    v = harness.TraceView(None, 3, {})
    for name in ("host_ms_per_step", "solver_host_ms_per_step",
                 "env_query_ms_per_step", "dynamics_ms_per_step",
                 "device_idle_pct", "warp_solve_roofline_pct"):
        assert read(name, v) is None


def test_idle_gaps_label_the_host():
    gaps = tr.idle_gaps(synthetic(), 0.0, 2000.0, top=3)
    assert [round(g[1]) for g in gaps] == [300, 200, 200]
    # Between the steps the host is in the benchmark's step range only.
    assert gaps[0][0] == "bench.step"
    mid = tr.idle_gaps(synthetic(), 640.0, 800.0, top=1)
    assert mid[0][0] == "tat.fused_solve" and round(mid[0][1]) == 150
    ops = harness.breakdown(view())["device_ops"]
    assert ops[0][1] == pytest.approx(2e-4) and len(ops) == 4


def test_frozen_arithmetic_is_the_ports():
    from tpu_aerial_transport_torch.tools import op_profile

    t = [synthetic()]
    assert tr.device_aggregate(t) == op_profile.device_aggregate(t)
    for cats in (("cpu_op",), tr.HOST_CATS):
        assert tr.host_aggregate(t, cats) == op_profile.host_aggregate(
            t, cats)
    agg = tr.device_aggregate(t)
    assert tr.rollup_phases(agg) == op_profile.rollup_phases(agg)
    assert tr.OWN_KERNELS == op_profile.OWN_KERNELS


def test_bound():
    assert yardstick.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.bound_s(0, 67e12) == pytest.approx(1.0)
