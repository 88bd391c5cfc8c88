"""The benchmark's files against its contract: names and units, keys,
files found by name, and cells, mixes and metrics added as files."""

from __future__ import annotations

import json
import os
import re

import pytest

from port_bench.tests.conftest import CELLS, REPO, SMALL_S, run_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json"), encoding="utf-8") as fh:
        return json.load(fh)


def test_keys_and_characters():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert len(b["command"]) <= 32 and all(LINE.match(w) for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["why"])
        assert LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_has_its_file():
    b = bench()
    for path in b["paths"]:
        assert os.path.isdir(os.path.join(REPO, path))
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        with open(os.path.join(REPO, c["file"]), encoding="utf-8") as fh:
            cfg = json.load(fh)
        assert cfg["reduced"] == c["reduced"] and cfg["source"]
        names = set(cfg["limits"])
        assert names <= {"count_flip_share", "force_gap_N", "force_gap_q99_N",
                         "force_gap_ok_N", "carry_gap", "carry_gap_q99",
                         "carry_gap_ok", "env_gap_m", "env_gap_q99_m",
                         "state_gap"}
        assert {"count_flip_share", "env_gap_m", "state_gap"} <= names
        assert any(k.startswith("force_gap") for k in names)
        assert any(k.startswith("carry_gap") for k in names)
        assert os.path.isfile(os.path.join(
            REPO, "port_bench", "drivers", cfg["driver"] + ".py"))
    for w in b["workloads"]:
        assert w["config"] in configs
        assert os.path.isfile(os.path.join(
            REPO, "port_bench", "traffic", w["traffic"] + ".json"))
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(
            REPO, "port_bench", "metrics", m["name"] + ".py"))
    assert {w["name"] for w in b["workloads"]} == set(CELLS)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_keys(small_bench, trace):
    root, bench_dir = small_bench
    rc, res, err = run_cell(root, bench_dir, CELLS[0], trace=trace)
    assert rc == 0
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(res["metrics"]) == {"host_ms_per_step",
                                       "solver_host_ms_per_step",
                                       "consensus_iters_per_step",
                                       "consensus_iters_mean"}
    else:
        assert set(res["metrics"]) == {"scenario_steps_per_s",
                                       "step_ms_p95", "setup_s"}
    for name, c in res["checks"].items():
        assert f"check {name} " in err


def test_added_files_are_found(small_bench):
    """A configuration, a mix and a per-layer metric added as files and
    entries alone run as a new cell."""
    root, bench_dir = small_bench
    with open(os.path.join(bench_dir, "configs", "rqp-cadmm-n8.json"),
              encoding="utf-8") as fh:
        cfg = json.load(fh)
    cfg["n"] = 4
    with open(os.path.join(bench_dir, "configs", "rqp-cadmm-n4.json"), "w",
              encoding="utf-8") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench_dir, "traffic", "forest-mc.json"),
              encoding="utf-8") as fh:
        mix = json.load(fh)
    mix.update(episode_steps=3)
    mix["starts"] = {"mean": [9.0, 0.0, 2.0], "std": 1.0,
                     "velocity": [0.4, 0.0, 0.0]}
    with open(os.path.join(bench_dir, "traffic", "near-short.json"), "w",
              encoding="utf-8") as fh:
        json.dump(mix, fh)
    with open(os.path.join(bench_dir, "metrics", "steps_seen.py"), "w",
              encoding="utf-8") as fh:
        fh.write("def read(view):\n    return float(view.record['steps'])\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, encoding="utf-8") as fh:
        b = json.load(fh)
    b["configs"].append({"name": "rqp-cadmm-n4", "source": "s",
                         "file": "port_bench/configs/rqp-cadmm-n4.json",
                         "reduced": ["max_iter"], "why": "w"})
    b["workloads"].append({"name": "rqp-cadmm-n4.near-short",
                           "config": "rqp-cadmm-n4", "traffic": "near-short",
                           "chips": 1, "why": "w"})
    b["per_layer"].append({"name": "steps_seen", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "step driver",
                           "moves": "scenario_steps_per_s",
                           "workloads": ["rqp-cadmm-n4.near-short"]})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(b, fh)
    rc, res, _ = run_cell(root, bench_dir, "rqp-cadmm-n4.near-short",
                          trace=True, seconds=0.2)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["steps_seen"]["value"] >= 5
    assert res["attempted"] % SMALL_S == 0


def test_a_cells_own_bound_repeats_the_metric(small_bench):
    """``<name>.<cells>`` reports ``<name>`` in the cells it lists."""
    root, bench_dir = small_bench
    rc, res, _ = run_cell(root, bench_dir, CELLS[1])
    assert rc == 0
    m = res["metrics"]
    for name in ("scenario_steps_per_s", "step_ms_p95"):
        assert m[name + ".centralized"] == m[name]


@pytest.mark.parametrize("workload,key,value", [
    (CELLS[0], "res_tol", 0.02),
    (CELLS[0], "rho", 2.0),
    (CELLS[0], "tau_incr", 1.1),
    (CELLS[0], "env_query", "bucketed"),
    (CELLS[1], "solver_iters", 60),
    (CELLS[1], "solver_tol", 1e-3),
    (CELLS[0], "low_level", "so3"),
    (CELLS[1], "tf32", True),
    (CELLS[1], "max_iter", 20),
    (CELLS[0], "inner_tol", 1e-3),
])
def test_a_key_the_program_cannot_honour_is_refused(small_bench, workload,
                                                    key, value):
    """Every key of a configuration reaches the program or is refused:
    none reaches the reference alone."""
    from port_bench import harness

    _, bench_dir = small_bench
    cell = harness.Cell(workload, os.path.dirname(bench_dir), bench_dir)
    with pytest.raises(ValueError):
        cell.driver.build(dict(cell.config, **{key: value}), cell.traffic,
                          3, "cpu")


def test_a_mix_brings_its_own_generator(small_bench):
    """``traffic/<mix>.py`` beside ``traffic/<mix>.json`` is the mix's
    generator: these starts on a ring are a key the shared one lacks."""
    root, bench_dir = small_bench
    with open(os.path.join(bench_dir, "traffic", "forest-mc.json"),
              encoding="utf-8") as fh:
        mix = json.load(fh)
    mix.update(episode_steps=3, starts={"radius": 2.0, "height": 2.0,
                                        "velocity": [0.5, 0.0, 0.0]})
    with open(os.path.join(bench_dir, "traffic", "ring-short.json"), "w",
              encoding="utf-8") as fh:
        json.dump(mix, fh)
    with open(os.path.join(bench_dir, "traffic", "ring-short.py"), "w",
              encoding="utf-8") as fh:
        fh.write(
            "import numpy as np\n"
            "from port_bench.traffic.generator import (make_command,\n"
            "    make_world, seed_words)\n\n\n"
            "def episode_starts(starts, seed, episode, S):\n"
            "    rng = np.random.default_rng(seed_words(seed) + [episode])\n"
            "    a = rng.random(S) * 2 * np.pi\n"
            "    r = starts['radius']\n"
            "    xl = np.stack([5 + r * np.cos(a), r * np.sin(a),\n"
            "                   np.full(S, starts['height'])], axis=1)\n"
            "    vl = np.tile(np.asarray(starts['velocity'], float), (S, 1))\n"
            "    return xl, vl\n")
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, encoding="utf-8") as fh:
        b = json.load(fh)
    b["workloads"].append({"name": "rqp-cadmm-n8.ring-short",
                           "config": "rqp-cadmm-n8", "traffic": "ring-short",
                           "chips": 1, "why": "w"})
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(b, fh)
    rc, res, _ = run_cell(root, bench_dir, "rqp-cadmm-n8.ring-short",
                          seconds=0.2)
    assert rc == 0 and res["correct"] is True
