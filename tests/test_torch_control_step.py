"""PyTorch port vs the JAX package: C-ADMM's runtime setters (on C-ADMM's
config and, through its ``base``, on DD's), a control step after
``set_leader``, and ``jit_control_step`` of C-ADMM and DD (the plan built
once; with ``donate=True`` the new state written into the storage of the
state passed in).

Tolerances, and why: the setters copy numbers, so the configs' fields are
equal. The step after ``set_leader(cfg, 2)`` has the bars of
``tests/test_torch_cadmm.py`` (forces 1e-4 N, iteration counts equal).
``jit_control_step`` runs ``control`` itself on the same inputs: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cadmm import _scenarios, _t

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.control import dd as jdd
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport_torch.control import cadmm, centralized, dd
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.tree import leaves, tree_map

KEYS = ("xl", "vl", "Rl", "wl", "R", "w")
MODS = {"cadmm": (jcadmm, cadmm), "dd": (jdd, dd)}


def _configs(ctrl, n=4):
    jmod, mod = MODS[ctrl]
    jp, jcol, _ = jsetup.rqp_setup(n)
    tp, tcol, _ = setup.rqp_setup(n, device="cpu")
    kw = dict(max_iter=20, inner_iters=20)
    return (jmod.make_config(jp, jcol.collision_radius,
                             jcol.max_deceleration, **kw),
            mod.make_config(tp, tcol.collision_radius, tcol.max_deceleration,
                            device="cpu", **kw))


def _fields(cfg):
    base = cfg.base if hasattr(cfg, "base") else cfg
    out = {k: getattr(base, k) for k in ("leader_idx", "res_tol", "max_iter")}
    if hasattr(cfg, "base"):
        out["prim_inf_tol"] = cfg.prim_inf_tol
    return out


@pytest.mark.parametrize("ctrl", ["cadmm", "dd"])
def test_setters_match_jax(ctrl):
    """``set_leader``, ``unset_leader``, ``set_tolerance`` and
    ``set_max_iter`` give the JAX package's fields, and leave the config
    they were given as it was."""
    jcfg, cfg = _configs(ctrl)
    assert _fields(cfg) == {k: type(v)(np.asarray(v)) for k, v in
                            _fields(jcfg).items()}
    cases = [(jcadmm.set_leader, cadmm.set_leader, (2,)),
             (jcadmm.unset_leader, cadmm.unset_leader, ()),
             (jcadmm.set_tolerance, cadmm.set_tolerance, (3e-3,)),
             (jcadmm.set_max_iter, cadmm.set_max_iter, (7,))]
    for jset, tset, args in cases:
        got = _fields(tset(cfg, *args))
        want = _fields(jset(jcfg, *args))
        assert got == {k: type(got[k])(np.asarray(v)) for k, v in
                       want.items()}, tset.__name__
    assert _fields(cfg) == _fields(_configs(ctrl)[1])
    assert type(cadmm.set_leader(cfg, 1)) is type(cfg)


def test_step_after_set_leader_matches_jax():
    """A C-ADMM step with agent 2 as the leader (n = 4, 3 scenarios)
    against ``jax.vmap`` of the JAX step with ``set_leader(cfg, 2)``."""
    n = 4
    sc = _scenarios(n)
    jp, jcol, js = jsetup.rqp_setup(n)
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    jcfg = jcadmm.set_leader(jcadmm.make_config(
        jp, jcol.collision_radius, jcol.max_deceleration, max_iter=20,
        inner_iters=20, socp_fused="scan", pad_operators=True), 2)
    cfg = cadmm.set_leader(cadmm.make_config(
        tp, tcol.collision_radius, tcol.max_deceleration, max_iter=20,
        inner_iters=20, pad_operators=True, device="cpu"), 2)
    f_eq = jcentral.equilibrium_forces(jp)
    cs0, plan = jcadmm.init_cadmm_state(jp, jcfg), jcadmm.make_plan(jp, jcfg)
    acc = (jnp.array([0.3, 0.0, 0.0], jnp.float32), jnp.zeros(3, jnp.float32))
    jf = jforest.make_forest(seed=0)
    ref = jax.jit(jax.vmap(lambda s: jcadmm.control(
        jp, jcfg, f_eq, cs0, js.replace(**dict(zip(KEYS, s))), acc, jf,
        plan=plan)))(tuple(jnp.asarray(sc[k], jnp.float32) for k in KEYS))
    tf_eq = centralized.equilibrium_forces(tp)
    css = rollout.stack_scenarios(cadmm.init_cadmm_state(tp, cfg, tf_eq), 3)
    states = rollout.stack_scenarios(ts, 3).replace(
        **{k: _t(sc[k]) for k in KEYS})
    out = cadmm.control(tp, cfg, tf_eq, css, states,
                        (_t([0.3, 0.0, 0.0]), torch.zeros(3)),
                        forest.make_forest(seed=0, device="cpu"),
                        plan=cadmm.make_plan(tp, cfg))
    np.testing.assert_array_equal(out[2].iters.numpy(),
                                  np.asarray(ref[2].iters))
    assert int(out[2].iters.max()) > 1
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(out[1].lam.numpy(), np.asarray(ref[1].lam),
                               atol=1e-4, rtol=0)
    # The leader changed the step: agent 0 leading gives other forces.
    lead0 = cadmm.control(tp, cadmm.set_leader(cfg, 0), tf_eq, css, states,
                          (_t([0.3, 0.0, 0.0]), torch.zeros(3)),
                          forest.make_forest(seed=0, device="cpu"),
                          plan=cadmm.make_plan(tp, cfg))
    assert not torch.allclose(lead0[0], out[0], atol=1e-3)


def _port_run(ctrl, n=4, S=3):
    mod = MODS[ctrl][1]
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    cfg = mod.make_config(tp, tcol.collision_radius, tcol.max_deceleration,
                          max_iter=20, inner_iters=20, pad_operators=True,
                          device="cpu")
    f_eq = centralized.equilibrium_forces(tp)
    init = (cadmm.init_cadmm_state(tp, cfg, f_eq) if ctrl == "cadmm"
            else dd.init_dd_state(tp, cfg, f_eq))
    sc = _scenarios(n, S)
    states = rollout.stack_scenarios(ts, S).replace(
        **{k: _t(sc[k]) for k in KEYS})
    acc = (_t([0.3, 0.0, 0.0]), torch.zeros(3))
    return (mod, tp, cfg, f_eq, rollout.stack_scenarios(init, S), states,
            acc, forest.make_forest(seed=0, device="cpu"))


def _same(x, y):
    """Bitwise equal, NaN where the other is NaN (the unused tail of
    ``SolverStats.err_seq``)."""
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype != torch.float32:
        return torch.equal(x, y)
    bits = x.view(torch.int32) == y.view(torch.int32)
    return bool((bits | (x.isnan() & y.isnan())).all())


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(_same(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("ctrl", ["cadmm", "dd"])
def test_jit_control_step_equals_control(ctrl):
    """Two chained steps of ``jit_control_step`` (both ``donate`` modes)
    give ``control``'s outputs bit for bit; ``donate=True`` hands back the
    state passed in, its storage holding the new values, and
    ``donate=False`` leaves the input untouched."""
    mod, tp, cfg, f_eq, css, states, acc, tf = _port_run(ctrl)
    plan = (cadmm.make_plan(tp, cfg) if ctrl == "cadmm"
            else dd.make_dd_plan(tp, cfg))
    ref1 = mod.control(tp, cfg, f_eq, css, states, acc, tf, plan=plan)
    ref2 = mod.control(tp, cfg, f_eq, ref1[1], states, acc, tf, plan=plan)
    assert int(ref1[2].iters.max()) > 1

    keep = mod.jit_control_step(tp, cfg, f_eq, tf, donate=False)
    before = tree_map(torch.clone, css)
    out1 = keep(css, states, acc)
    assert _equal(out1, ref1) and _equal(css, before)
    assert all(x.data_ptr() != y.data_ptr()
               for x, y in zip(leaves(out1[1]), leaves(css)))

    donate = mod.jit_control_step(tp, cfg, f_eq, tf)
    carry = tree_map(torch.clone, css)
    ptrs = [t.data_ptr() for t in leaves(carry)]
    out1 = donate(carry, states, acc)
    assert out1[1] is carry
    assert [t.data_ptr() for t in leaves(out1[1])] == ptrs
    assert _equal(out1, ref1)
    out2 = donate(out1[1], states, acc)
    assert _equal(out2, ref2)
    assert [t.data_ptr() for t in leaves(out2[1])] == ptrs


def test_jit_control_step_refuses_a_mismatched_state():
    """A donated state whose leaves cannot take the step's (another warm
    layout) is a ValueError, not a silent broadcast."""
    mod, tp, cfg, f_eq, css, states, acc, tf = _port_run("cadmm")
    bad = css._replace(f_mean=css.f_mean[:, :1].clone())
    step = cadmm.jit_control_step(tp, cfg, f_eq, tf)
    with pytest.raises((ValueError, RuntimeError)):
        step(bad, states, acc)
