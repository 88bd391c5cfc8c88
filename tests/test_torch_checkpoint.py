"""PyTorch port vs the JAX package: the checkpoint tier
(``harness.checkpoint``), the counterpart of ``tests/test_checkpoint.py``.

Snapshots of the port's carries round-trip bit for bit (every dtype the
carries hold: float32 with NaNs, int32, bool, int64; ``None`` leaves kept
in place), onto the template's device; the rejection kinds, retention and
atomicity are the JAX package's; a port snapshot's manifest reads under
the JAX package's ``read_manifest``, and a port run dict under its
``load_run``. The run dict's arrays agree with the JAX package's within
the bars of ``tests/test_torch_rollout.py`` (1e-4; iteration counts,
flags and rungs equal).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_resilience import _bits_equal, _port_bits

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.control import lowlevel as jlowlevel
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import checkpoint as jcheckpoint
from tpu_aerial_transport.harness import rollout as jrollout
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport_torch.harness import checkpoint, rollout, setup
from tpu_aerial_transport_torch.obs import telemetry
from tpu_aerial_transport_torch.resilience import faults, prng
from tpu_aerial_transport_torch.resilience import rollout as tres
from tpu_aerial_transport_torch.tree import TensorSpec, leaves, tree_map


def _specs(tree):
    return tree_map(lambda t: TensorSpec(t.shape, t.dtype, t.device), tree)


def _carries():
    """The port carries a snapshot holds: the C-ADMM controller state, the
    payload state, and the resilient carry (NaN hold force, bool flag,
    the telemetry accumulator's int32 counts, the int64 schedule key
    beside it)."""
    tp, ts, cs0, hl, _ = _port_bits("cadmm")
    states = rollout.stack_scenarios(ts, 2)
    css = rollout.stack_scenarios(cs0, 2)
    sched = faults.make_schedule(4, t_fail={1: 2},
                                 key=prng.prng_key(3, device="cpu"),
                                 device="cpu")
    carry = tres.init_resilient_carry(hl, tp, states, css, sched,
                                      telemetry.TelemetryConfig())
    return {"cadmm_state": css, "rqp_state": states,
            "resilient_carry": (carry, sched.key)}


CARRIES = ("cadmm_state", "rqp_state", "resilient_carry")


@pytest.mark.parametrize("kind", CARRIES)
def test_snapshot_roundtrip_bit_exact(tmp_path, kind):
    """A port carry round-trips bit for bit, each leaf at its dtype on
    the template's device, through a tensor template and through a
    template of ``TensorSpec`` leaves; ``None`` leaves stay ``None``."""
    state = _carries()[kind]
    d = str(tmp_path)
    checkpoint.save_snapshot(d, 0, state, config_hash="h", meta={"chunk": 0})
    for template in (state, _specs(state)):
        back, manifest, skipped = checkpoint.load_latest_valid(
            d, template, config_hash="h")
        assert skipped == [] and manifest["step"] == 0
        assert manifest["meta"] == {"chunk": 0}
        fp = checkpoint.tree_fingerprint(state)
        assert checkpoint.tree_fingerprint(back) == fp
        for a, b in zip(leaves(state), leaves(back)):
            assert a.dtype == b.dtype and a.device == b.device
            assert _bits_equal(a, b)
    if kind == "resilient_carry":
        dtypes = {t.dtype for t in leaves(state)}
        assert {torch.float32, torch.int32, torch.bool,
                torch.int64} <= dtypes
        assert torch.isnan(state[0][2]).all()
    if kind == "cadmm_state":
        assert state.held is None and back.held is None


def test_tensor_spec_template_fingerprints_as_the_tensors():
    """A template of ``TensorSpec`` leaves has the fingerprint of the
    tensors it describes; a leaf's dtype, shape or a ``None`` in place of
    a tensor changes it."""
    state = _carries()["resilient_carry"]
    fp = checkpoint.tree_fingerprint(state)
    assert checkpoint.tree_fingerprint(_specs(state)) == fp
    carry, key = state
    drifted = [
        ((carry[:2] + (carry[2].double(),) + carry[3:]), key),
        ((carry[:2] + (carry[2][:1],) + carry[3:]), key),
        ((carry[0], carry[1]._replace(held=None)) + carry[2:], key),
    ]
    for d in drifted:
        assert checkpoint.tree_fingerprint(d) != fp


def test_snapshot_keep_last_k_retention(tmp_path):
    d = str(tmp_path)
    state = _carries()["rqp_state"]
    for step in range(6):
        checkpoint.save_snapshot(d, step, state, keep_last=3)
    assert [s for s, _ in checkpoint.list_snapshots(d)] == [3, 4, 5]
    for step in range(6, 9):
        checkpoint.save_snapshot(d, step, state, prefix="logs", keep_last=0)
    assert len(checkpoint.list_snapshots(d, "logs")) == 3
    with pytest.raises(ValueError, match="prefix"):
        checkpoint.snapshot_path(d, 0, prefix="bad/prefix")


def _tamper_leaf(path):
    raw = dict(np.load(path, allow_pickle=False))
    raw["leaf_000000"] = raw["leaf_000000"] + 1
    with open(path, "wb") as fh:
        np.savez(fh, **raw)


def test_corrupt_snapshot_rejected_with_fallback(tmp_path):
    d = str(tmp_path)
    state = _carries()["rqp_state"]
    checkpoint.save_snapshot(d, 0, state, keep_last=0)
    checkpoint.save_snapshot(d, 1, state, keep_last=0)
    newest = checkpoint.snapshot_path(d, 1)
    _tamper_leaf(newest)
    with pytest.raises(checkpoint.SnapshotError) as ei:
        checkpoint.load_snapshot(newest, state)
    assert ei.value.kind == "corrupt"
    back, manifest, skipped = checkpoint.load_latest_valid(d, state)
    assert manifest["step"] == 0 and [e.kind for e in skipped] == ["corrupt"]
    assert torch.equal(back.xl, state.xl)


def test_truncated_snapshot_rejected(tmp_path):
    d = str(tmp_path)
    state = _carries()["rqp_state"]
    checkpoint.save_snapshot(d, 0, state)
    p = checkpoint.snapshot_path(d, 0)
    with open(p, "r+b") as fh:
        fh.truncate(os.path.getsize(p) // 2)
    with pytest.raises(checkpoint.SnapshotError) as ei:
        checkpoint.load_snapshot(p, state)
    assert ei.value.kind == "unreadable"
    with pytest.raises(checkpoint.SnapshotError) as ei:
        checkpoint.load_latest_valid(d, state)
    assert ei.value.kind == "no_valid_snapshot" and ei.value.errors
    with pytest.raises(checkpoint.SnapshotError) as ei:
        checkpoint.read_manifest(p)
    assert ei.value.kind == "unreadable"


def test_config_mismatch_refused(tmp_path):
    d = str(tmp_path)
    state = _carries()["cadmm_state"]
    checkpoint.save_snapshot(d, 0, state, config_hash="cfg-A")
    p = checkpoint.snapshot_path(d, 0)
    with pytest.raises(checkpoint.SnapshotError) as ei:
        checkpoint.load_snapshot(p, state, config_hash="cfg-B")
    assert ei.value.kind == "config_mismatch"
    # Hash-less loads (either side) skip the check, as in the JAX package.
    checkpoint.load_snapshot(p, state)
    checkpoint.save_snapshot(d, 1, state)
    checkpoint.load_snapshot(checkpoint.snapshot_path(d, 1), state,
                             config_hash="cfg-B")


def test_structure_mismatch_refused(tmp_path):
    d = str(tmp_path)
    carry, key = _carries()["resilient_carry"]
    checkpoint.save_snapshot(d, 0, carry)
    p = checkpoint.snapshot_path(d, 0)
    for template in (carry[:4],  # the accumulator dropped
                     carry[:3] + (carry[3].to(torch.int32),) + carry[4:],
                     (carry[0], carry[1]._replace(held=None)) + carry[2:]):
        with pytest.raises(checkpoint.SnapshotError) as ei:
            checkpoint.load_snapshot(p, template)
        assert ei.value.kind == "structure_mismatch"


def test_atomic_write_leaves_no_temp_debris(tmp_path):
    d = str(tmp_path)
    state = _carries()["rqp_state"]
    checkpoint.save_snapshot(d, 0, state)
    assert os.listdir(d) == ["snap-00000000.ckpt"]
    checkpoint.load_snapshot(checkpoint.snapshot_path(d, 0), state)


def test_config_fingerprint_sees_interior_of_big_arrays():
    """Arrays (numpy and tensors) hash from their full bytes: a repr
    elides the interior past ~1000 elements, so a change there would
    otherwise go unseen; shape and dtype count too."""
    a = np.zeros(2000, np.float32)
    b = a.copy()
    b[1000] = 1.0
    assert repr(a) == repr(b)
    assert checkpoint.config_fingerprint(params=a) \
        != checkpoint.config_fingerprint(params=b)
    assert checkpoint.config_fingerprint(params=torch.as_tensor(a)) \
        != checkpoint.config_fingerprint(params=torch.as_tensor(b))
    assert checkpoint.config_fingerprint(params=a) \
        == checkpoint.config_fingerprint(params=a.copy())
    assert checkpoint.config_fingerprint(params=np.zeros(4, np.float32)) \
        != checkpoint.config_fingerprint(params=np.zeros(2, np.float64))
    assert checkpoint.config_fingerprint(n=4, cfg="x") \
        != checkpoint.config_fingerprint(n=5, cfg="x")
    # A dataclass of tensors, as the port's parameters and configs are.
    params = setup.rqp_setup(4, device="cpu")[0]
    fp = checkpoint.config_fingerprint(params=params)
    assert fp == checkpoint.config_fingerprint(
        params=setup.rqp_setup(4, device="cpu")[0])
    assert fp != checkpoint.config_fingerprint(
        params=dataclasses.replace(params, mT=params.mT + 1e-3))


def test_bf16_leaf_is_refused_by_name(tmp_path):
    with pytest.raises(ValueError, match="leaf 1 is bfloat16"):
        checkpoint.save_snapshot(str(tmp_path), 0, (
            torch.zeros(2), torch.zeros(2, dtype=torch.bfloat16)))
    assert checkpoint.list_snapshots(str(tmp_path)) == []


def test_port_manifest_reads_under_jax_read_manifest(tmp_path):
    """The JAX package's ``read_manifest`` reads a port snapshot: the same
    schema, step, config hash, meta, and per-leaf shapes, dtypes and
    digests; the port's reader agrees."""
    d = str(tmp_path)
    state = _carries()["resilient_carry"]
    p = checkpoint.save_snapshot(d, 5, state, prefix="carry",
                                 config_hash="abc", meta={"chunk": 5})
    ref = jcheckpoint.read_manifest(p)
    got = checkpoint.read_manifest(p)
    assert ref == got
    assert ref["schema"] == jcheckpoint.SCHEMA_VERSION == 1
    assert (ref["step"], ref["config_hash"], ref["meta"]) == (
        5, "abc", {"chunk": 5})
    lv = leaves(state)
    assert len(ref["leaves"]) == len(lv)
    for spec, t in zip(ref["leaves"], lv):
        a = t.numpy()
        assert spec["shape"] == list(a.shape) and spec["dtype"] == a.dtype.str
    assert [s for s, _ in jcheckpoint.list_snapshots(d, "carry")] == [5]


def test_shard_manifest_matches_jax(tmp_path):
    """The shard-manifest helpers: the port's file reads under the JAX
    package's loader, and both refuse a process-count or config drift."""
    d = str(tmp_path)
    assert checkpoint.shard_prefix("carry", 1, 2) == jcheckpoint.shard_prefix(
        "carry", 1, 2) == "carry.p1of2"
    with pytest.raises(ValueError):
        checkpoint.shard_prefix("carry", 2, 2)
    checkpoint.save_shard_manifest(d, prefix="carry", n_processes=2,
                                   topology={"scenario": 2},
                                   config_hash="h")
    ref = jcheckpoint.load_shard_manifest(d, prefix="carry", n_processes=2,
                                          config_hash="h")
    assert ref == checkpoint.load_shard_manifest(d, prefix="carry")
    for kw in (dict(n_processes=4), dict(config_hash="other")):
        with pytest.raises(checkpoint.SnapshotError) as ei:
            checkpoint.load_shard_manifest(d, prefix="carry", **kw)
        assert ei.value.kind == "config_mismatch"
    with pytest.raises(checkpoint.SnapshotError) as ei:
        checkpoint.load_shard_manifest(d, prefix="missing")
    assert ei.value.kind == "unreadable"


def test_save_state_roundtrip(tmp_path):
    state = _carries()["resilient_carry"]
    p = str(tmp_path / "st")
    checkpoint.save_state(p, state)
    back = checkpoint.load_state(p, state)
    for a, b in zip(leaves(state), leaves(back)):
        assert a.dtype == b.dtype and _bits_equal(a, b)


def test_load_run_preserves_scalar_dtype(tmp_path):
    p = str(tmp_path / "run.npz")
    checkpoint.save_run(p, {"f32_scalar": np.float32(1.5),
                            "i32_scalar": np.int32(7),
                            "nested": {"b": np.bool_(True)}})
    back = checkpoint.load_run(p)
    assert np.asarray(back["f32_scalar"]).dtype == np.float32
    assert np.asarray(back["i32_scalar"]).dtype == np.int32
    assert np.asarray(back["nested"]["b"]).dtype == np.bool_
    checkpoint.save_run(p, back)
    assert np.asarray(checkpoint.load_run(p)["f32_scalar"]).dtype \
        == np.float32


def test_port_run_dict_loads_under_jax_load_run(tmp_path):
    """One scenario of the port's logged C-ADMM rollout (n = 4, 3 steps,
    forest reference), ``logs_to_dict`` then ``save_run``: the JAX
    package's ``load_run`` reads it with the JAX run dict's keys and
    shapes; counts, flags, rungs and tree positions equal, every other
    array within 1e-4 of the JAX rollout's."""
    n, steps = 4, 3
    xl0 = np.array([5.0, 0.5, 2.0], np.float32)
    params, col, st0 = jsetup.rqp_setup(n)
    jf = jforest.make_forest(seed=0)
    cfg = jcadmm.make_config(params, col.collision_radius,
                             col.max_deceleration, max_iter=20,
                             inner_iters=20)
    f_eq = jcentral.equilibrium_forces(params)
    ll = jlowlevel.make_lowlevel_controller("pd", params)
    _, _, jlogs = jax.jit(lambda s, c: jrollout.rollout(
        lambda cs, x, a: jcadmm.control(params, cfg, f_eq, cs, x, a, jf),
        ll.control, params, s, c, steps,
        acc_des_fn=jrollout.make_forest_acc_des(jf)))(
        st0.replace(xl=jnp.asarray(xl0),
                    vl=jnp.array([0.5, 0.0, 0.0], jnp.float32)),
        jcadmm.init_cadmm_state(params, cfg))
    jp = str(tmp_path / "jax.npz")
    jcheckpoint.save_run(jp, jrollout.logs_to_dict(jlogs, n, 1e-3, 10, jf))
    ref = jcheckpoint.load_run(jp)

    ctl = rollout.make_controller("cadmm", n, max_iter=20, inner_iters=20,
                                  device="cpu")
    run = rollout.jit_rollout(ctl.control, ctl.ll.control, ctl.params,
                              n_hl_steps=steps,
                              acc_des_fn=rollout.make_forest_acc_des(
                                  ctl.forest))
    states = rollout.scenario_batch(ctl.state0, 1).replace(
        xl=torch.as_tensor(xl0[None]))
    _, _, logs = run(states, rollout.stack_scenarios(ctl.cs0, 1))
    one = tree_map(lambda t: t[:, 0], logs)
    tp = str(tmp_path / "port.npz")
    checkpoint.save_run(tp, rollout.logs_to_dict(one, n, 1e-3, 10,
                                                 ctl.forest))
    got = jcheckpoint.load_run(tp)
    assert sorted(got) == sorted(ref)
    exact = ("n", "dt", "T", "hl_rel_freq", "log_freq", "iter_seq",
             "collision_seq", "fallback_rung_seq", "quarantined_seq",
             "num_trees", "tree_pos")
    for k, v in ref.items():
        if isinstance(v, dict):
            assert sorted(got[k]) == sorted(v)
            for k2, v2 in v.items():
                assert np.shape(got[k][k2]) == np.shape(v2)
                np.testing.assert_allclose(got[k][k2], v2, rtol=0,
                                           atol=1e-4, err_msg=k2)
        elif k in exact:
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert np.shape(got[k]) == np.shape(v), k
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4,
                                       err_msg=k)
    assert int(np.max(got["iter_seq"])) > 1
