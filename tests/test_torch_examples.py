"""PyTorch port vs the JAX package: the user's drivers
(``tpu_aerial_transport_torch/examples``: ``rqp_forest``,
``fault_injection``, ``city_forest``, ``convergence_rates``, ``replay``)
against the JAX package's ``examples/`` on the CPU, at small sizes.

The JAX examples are loaded by path and run with their ``sys.argv``
patched, each once a module (``--time-chunk 0``); the port's run through
their ``main(argv)`` with ``--device cpu``. Tolerances, and why: the two
packages' float32 inverses, products and reductions round apart by ~1e-6
relative, so a 3-step C-ADMM rollout's states agree within 1e-4 and its
forces within 1e-3 N (the bars of ``tests/test_torch_rollout.py``), and
the consensus iteration counts are equal. The npz logs share keys, shapes
and dtypes, so either package's ``replay`` reads either package's log.
Within the port, bitwise: the chunked run, its SIGTERM-preempted and
resumed twin, and the unchunked run. Random bits: the dropout masks and
the convergence samples' keys are Threefry words, equal bitwise; the
normal draws go through ``erf^-1``, whose ``log1p`` rounds an ulp apart
between libraries, so the accelerations (``0.5 * normal``) agree within
half of ``tests/test_torch_prng.py``'s 2e-6 and the residual curves within
1e-3 N.
"""

import importlib.util
import json
import os
import signal
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from tpu_aerial_transport_torch.envs import spatial
from tpu_aerial_transport_torch.examples import (
    city_forest,
    convergence_rates,
    fault_injection,
    replay,
    rqp_forest,
)
from tpu_aerial_transport_torch.harness import rollout as ro
from tpu_aerial_transport_torch.resilience import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 3 MPC steps (int(0.035 / 0.01)) of C-ADMM. Against the JAX example at
# the driver's default n = 3 (the full agent QP): at n = 4 the JAX
# package's Schur plan alone compiles ~200 small programs, 9 s of this
# host's time. The port's n = 4 Schur path runs in the chunked test.
RQP_ARGS = ["--controller", "cadmm", "-n", "3", "-T", "0.035",
            "--time-chunk", "0"]
RQP4_ARGS = ["--controller", "cadmm", "-n", "4", "-T", "0.035",
             "--time-chunk", "0", "--device", "cpu"]
STATE_BAR = 1e-4
FORCE_BAR = 1e-3
CURVE_BAR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The drivers' many small ops on one intra-op thread: the suite runs
    under several workers, and a worker's default pool (one thread a
    core) oversubscribes the host; on one thread these runs take the
    same time alone and no longer stall under load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_example(name):
    """The JAX package's ``examples/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv):
    mod = _jax_example(name)
    with mock.patch.object(sys, "argv", [name] + argv):
        mod.main()


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    """The JAX example's and the port's npz logs of the same run."""
    d = tmp_path_factory.mktemp("rqp")
    paths = {"jax": str(d / "jax.npz"), "port": str(d / "port.npz")}
    _run_jax("rqp_forest", RQP_ARGS + ["--out", paths["jax"]])
    assert rqp_forest.main(RQP_ARGS + ["--device", "cpu", "--out",
                                       paths["port"]]) == 0
    return paths


def test_rqp_forest_log_matches_jax(logs):
    """The npz layouts are one (keys, shapes, dtypes, the scalars
    ``replay`` reads); states within 1e-4, forces within 1e-3 N,
    iteration counts equal."""
    j, t = np.load(logs["jax"]), np.load(logs["port"])
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        assert j[k].shape == t[k].shape and j[k].dtype == t[k].dtype, k
    for k in ("n", "dt", "T", "hl_rel_freq", "log_freq", "num_trees",
              "tree_pos", "iter_seq", "collision_seq", "fallback_rung_seq",
              "quarantined_seq"):
        assert np.array_equal(j[k], t[k]), k
    assert t["iter_seq"].shape == (3,) and t["iter_seq"].min() >= 1
    for k in j.files:
        if k.startswith("state_"):
            np.testing.assert_allclose(t[k], j[k], atol=STATE_BAR, rtol=0,
                                       err_msg=k)
    np.testing.assert_allclose(t["f_des_seq"], j["f_des_seq"],
                               atol=FORCE_BAR, rtol=0)


def _stop_in_chunk_one(monkeypatch):
    """Make ``make_chunked_rollout``'s chunk SIGTERM its own process
    during chunk 1 (the run then stops at that chunk's boundary)."""
    make = ro.make_chunked_rollout

    def stopping(*a, **kw):
        run = make(*a, **kw)
        chunk = run.chunk_jit

        def chunk_jit(carry, i0):
            out = chunk(carry, i0)
            if i0 == run.chunk_len:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        chunk_jit.logs_spec = chunk.logs_spec
        run.chunk_jit = chunk_jit
        return run

    monkeypatch.setattr(ro, "make_chunked_rollout", stopping)
    return make


def test_rqp_forest_chunked_preempt_resume_bitwise(tmp_path, monkeypatch,
                                                   capsys):
    """C-ADMM at n = 4 (the Schur-reduced agent QPs), ``--chunks 3
    --ckpt-dir``: uninterrupted, bitwise the unchunked run; SIGTERM during
    chunk 1 stops it at that boundary (``preempted``), and ``--resume``
    finishes bitwise the uninterrupted chunked run, its settings restored
    from the journal."""
    plain, full = str(tmp_path / "plain.npz"), str(tmp_path / "full.npz")
    assert rqp_forest.main(RQP4_ARGS + ["--out", plain]) == 0
    args = RQP4_ARGS + ["--chunks", "3"]
    assert rqp_forest.main(args + ["--ckpt-dir", str(tmp_path / "a"),
                                   "--out", full]) == 0
    ref = np.load(plain)
    got = np.load(full)
    assert int(ref["n"]) == 4
    for k in ref.files:
        assert np.array_equal(ref[k], got[k]), k

    run_dir = str(tmp_path / "b")
    make = _stop_in_chunk_one(monkeypatch)
    with pytest.raises(SystemExit, match="preempted at chunk 2/3"):
        rqp_forest.main(args + ["--ckpt-dir", run_dir])
    monkeypatch.setattr(ro, "make_chunked_rollout", make)
    resumed = str(tmp_path / "resumed.npz")
    assert rqp_forest.main(["--resume", run_dir, "--device", "cpu",
                            "--time-chunk", "0", "--out", resumed]) == 0
    assert "resumed from chunk 2" in capsys.readouterr().out
    res = np.load(resumed)
    for k in ref.files:
        assert np.array_equal(res[k], got[k]), k
    assert os.path.getsize(os.path.join(run_dir, "run.metrics.jsonl")) > 0


def test_rqp_forest_resume_refuses_another_carry_structure(logs, tmp_path,
                                                          monkeypatch):
    """A ``--telemetry`` run preempted in chunk 1, its journal then made
    to say no telemetry: the resumed program's carry has no accumulator,
    so the checkpoint's per-leaf check refuses every carry snapshot
    (``structure_mismatch``) and the run starts again from chunk 0, never
    from a snapshot of the other program; its log is the plain run's."""
    from tpu_aerial_transport_torch.resilience import recovery

    run_dir = str(tmp_path / "tel")
    make = _stop_in_chunk_one(monkeypatch)
    with pytest.raises(SystemExit, match="preempted"):
        rqp_forest.main(RQP_ARGS + ["--device", "cpu", "--chunks", "3",
                                    "--telemetry", "--ckpt-dir", run_dir])
    monkeypatch.setattr(ro, "make_chunked_rollout", make)
    journal = recovery.RunJournal(run_dir)
    events = journal.read()
    assert events[0]["meta"]["telemetry"] is True
    events[0]["meta"]["telemetry"] = False
    with open(os.path.join(run_dir, "journal.jsonl"), "w") as fh:
        fh.writelines(json.dumps(e) + "\n" for e in events)
    out = str(tmp_path / "resumed.npz")
    assert rqp_forest.main(["--resume", run_dir, "--device", "cpu",
                            "--time-chunk", "0", "--out", out]) == 0
    resume = [e for e in journal.read() if e["event"] == "resume"]
    assert resume[0]["start_chunk"] == 0 and resume[0]["skipped"]
    assert all("structure_mismatch" in k for k in resume[0]["skipped"])
    ref, got = np.load(logs["port"]), np.load(out)
    for k in ref.files:
        assert np.array_equal(ref[k], got[k]), k


def test_fault_injection_masks_and_killed_forces_match_jax(tmp_path):
    """The dropout schedule under ``PRNGKey(7)``: its delivery masks over
    40 steps bitwise the JAX schedule's. The killed-agent run: agent 0's
    forces exactly 0 from the step the JAX schedule marks it dead, the
    others' not; the checkpointed run of the same scenario bitwise the
    unchunked one."""
    from tpu_aerial_transport.resilience import faults as jfaults

    sched = fault_injection.scenarios(4, 6, "cpu")["30% consensus dropout"]
    jsched = jfaults.make_schedule(4, drop_rate=0.3, drop_hold=5,
                                   key=jax.random.PRNGKey(7))
    masks = np.stack([faults.fault_step(sched, t).msg_ok.numpy()
                      for t in range(40)])
    jmasks = np.stack([np.asarray(jfaults.fault_step(jsched, t).msg_ok)
                       for t in range(40)])
    assert np.array_equal(masks, jmasks) and not masks.all()

    out = fault_injection.main(["--steps", "6", "--device", "cpu"])
    name = "agent 0 killed @ step 3"
    f = out[name].f_des.numpy()
    jkill = jfaults.make_schedule(4, t_fail={0: 3})
    alive = np.stack([np.asarray(jfaults.fault_step(jkill, t).alive)
                      for t in range(6)])
    assert (f[~alive[:, 0], 0] == 0.0).all()
    assert (np.abs(f[alive[:, 0], 0]).sum(-1) > 0).all()
    assert (np.abs(f[:, 1:]).sum(-1) > 0).all()
    assert out["nominal"].fallback_rung.numpy().tolist() == [0] * 6
    ck = fault_injection.main(["--steps", "6", "--chunks", "3",
                               "--ckpt-dir", str(tmp_path / "fi"),
                               "--device", "cpu"])["checkpointed"]
    for k in ("xl", "f_des", "iters", "fallback_rung", "quarantined"):
        assert torch.equal(getattr(ck, k), getattr(out[name], k)), k


def test_convergence_rates_samples_and_curves_match_jax(tmp_path):
    """``--samples 8``: the sample keys bitwise ``split(PRNGKey(0), 8)``,
    the accelerations within 1e-6 of the JAX example's, both solvers'
    residual curves (median, min, max) within 1e-3 N of the JAX
    example's; the effort A/B runs both arms."""
    keys = convergence_rates.sample_keys(8, "cpu").numpy()
    jkeys = np.asarray(jax.random.split(jax.random.PRNGKey(0), 8))
    assert np.array_equal(keys, jkeys.astype(np.int64))
    acc = convergence_rates.sample_accelerations(8, "cpu").numpy()
    jacc = np.asarray(jax.vmap(
        lambda k: 0.5 * jax.random.normal(k, (3,)))(jax.random.split(
            jax.random.PRNGKey(0), 8)))
    np.testing.assert_allclose(acc, jacc, atol=1e-6, rtol=0)
    paths = {w: str(tmp_path / f"{w}.json") for w in ("jax", "port")}
    argv = ["--samples", "8", "--iters", "25"]
    _run_jax("convergence_rates", argv + ["--json", paths["jax"], "--out",
                                          str(tmp_path / "jax.png")])
    curves = convergence_rates.main(argv + ["--json", paths["port"],
                                            "--out", "", "--device", "cpu"])
    assert curves["C-ADMM"].shape == (8, 26)
    j, t = (json.load(open(paths[w])) for w in ("jax", "port"))
    for label in ("C-ADMM", "DD"):
        for k in ("median", "min", "max"):
            np.testing.assert_allclose(t[label][k], j[label][k],
                                       atol=CURVE_BAR, rtol=0)
    ab = convergence_rates.main(["--samples", "4", "--iters", "6",
                                 "--effort", "ab", "--device", "cpu"])
    assert sorted(ab) == ["C-ADMM_adaptive", "C-ADMM_fixed", "DD_adaptive",
                          "DD_fixed"]
    assert all(r["iters_mean"] >= 1 and np.isfinite(r["res_max"])
               for r in ab.values())
    assert "inner_per_solve_mean" in ab["C-ADMM_adaptive"]


def test_city_forest_resolves_bucketed(tmp_path):
    """1024 trees, 2 MPC steps: ``env_query="auto"`` resolves to the
    bucketed tier; the telemetry accumulator's counts equal a recount
    from the logs; the grid record is printed and a slab too narrow for
    the world raises ``GridOverflowError``."""
    metrics = str(tmp_path / "city.metrics.jsonl")
    out = city_forest.main(["--trees", "1024", "-T", "0.02", "--device",
                            "cpu", "--metrics", metrics])
    assert out["env_query"] == "bucketed"
    logs = out["logs"]
    assert out["steps"] == logs.xl.shape[0] == 2
    assert out["iters_sum"] == int(logs.iters.sum())
    assert out["collision_steps"] == int(logs.collision.sum())
    assert out["min_env_dist"] == pytest.approx(
        float(logs.min_env_dist.min()))
    assert out["grid"]["k"] >= out["grid"]["max_occupancy"] > 0
    assert os.path.getsize(metrics) > 0
    from tpu_aerial_transport_torch.envs import forest as forest_mod

    world = forest_mod.make_forest(0, 1024, world_size=32.5 / 0.085 ** 0.5,
                                   density=0.085, device="cpu")
    with pytest.raises(spatial.GridOverflowError):
        spatial.with_grid(world, 6.3, k=4)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_replay_reads_either_packages_log(logs, which, tmp_path):
    """``replay`` on the port's and on the JAX example's npz: the log read
    back as the JAX ``load_log`` reads it, the forest rebuilt from the
    logged trees, the frames, the ghost snapshot and the four figures
    written and non-empty."""
    got = replay.load_log(logs[which])
    ref = _jax_example("replay").load_log(logs[which])
    assert sorted(got) == sorted(ref) and sorted(got["state_seq"]) == sorted(
        ref["state_seq"])
    assert got["n"] == 3 and isinstance(got["T"], float)
    outdir = str(tmp_path / "out")
    res = replay.main([logs[which], "--outdir", outdir, "--stride", "50",
                       "--device", "cpu"])
    files = res["frames"] + [res["ghosts"]] + [
        os.path.join(outdir, f"{kind}_cadmm.png")
        for kind in ("tracking", "stats", "xy", "min_dist")]
    assert len(res["frames"]) == 1
    for f in files:
        assert os.path.getsize(f) > 1000, f


def test_drivers_refuse_without_a_card_and_meshcat(logs, monkeypatch,
                                                   tmp_path):
    """Each driver targets the card unless asked for the CPU; replay's
    ``--meshcat`` raises ``ImportError`` without meshcat, as the JAX
    driver does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the drivers run on it")
    for fn in (lambda: rqp_forest.main(RQP_ARGS),
               lambda: fault_injection.main(["--steps", "2"]),
               lambda: city_forest.main(["--trees", "1024"]),
               lambda: convergence_rates.main(["--samples", "2"]),
               lambda: replay.main([logs["port"]])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    monkeypatch.setitem(sys.modules, "meshcat", None)
    with pytest.raises(ImportError):
        replay.main([logs["port"], "--meshcat", "--device", "cpu",
                     "--outdir", str(tmp_path)])
