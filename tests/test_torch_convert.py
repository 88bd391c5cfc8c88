"""State carried across from the JAX package: ``convert`` builds the port's
RQPParams, RQPState, CADMMState (warm starts included), Forest and SchurPlan
from numpy leaves, and a port step from converted state equals a port step
from the port's own set-up.

Tolerances, and why: conversion itself is exact (float32 leaves copied).
Between the two set-ups the inputs are equal and the derived quantities
differ only by the rounding of sums over the agents (``x_com``, ``JT``), of
the inverses (``JT_inv``, the Schur plan's ``Qvv``/``Y`` inverses) and of
the minimum-norm equilibrium solve, a few float32 ulps; one MPC step from
either then agrees to 1e-5 in state and exactly in iteration counts.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.control import cadmm, centralized
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import rollout, setup

N = 8


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_side():
    jp, jcol, js = jsetup.rqp_setup(N)
    cfg = jcadmm.make_config(jp, jcol.collision_radius, jcol.max_deceleration,
                             max_iter=20, inner_iters=20, pad_operators=True)
    return (_np(jp), _np(js), _np(jcadmm.init_cadmm_state(jp, cfg)),
            _np(jforest.make_forest(seed=0)), _np(jcadmm.make_plan(jp, cfg)))


def _eq(a, b, exact=True, atol=0.0):
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape
    if exact:
        assert torch.equal(a, b)
    else:
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol,
                                   rtol=1e-5)


@pytest.mark.parametrize("as_dict", [False, True], ids=["pytree", "dict"])
def test_round_trip_leaves(as_dict):
    """Every leaf lands with the port's dtype and the JAX value, whether it
    comes as a pytree with numpy leaves or as a dict of arrays."""
    jp, js, jcs, jf, jplan = _jax_side()
    if as_dict:
        d = lambda t: {k: getattr(t, k) for k in (  # noqa: E731
            t._fields if hasattr(t, "_fields") else t.__dataclass_fields__)}
        jp, js, jf, jplan = d(jp), d(js), d(jf), d(jplan)
        jcs = dict(f=jcs.f, lam=jcs.lam, f_mean=jcs.f_mean, warm=d(jcs.warm))
    get = (lambda t, k: t[k]) if as_dict else getattr
    p = convert.rqp_params(jp, device="cpu")
    for k in p.__dataclass_fields__:
        assert np.array_equal(getattr(p, k).numpy(), get(jp, k))
    s = convert.rqp_state(js, device="cpu")
    assert s.step.dtype == torch.int32 and s.R.dtype == torch.float32
    cs = convert.cadmm_state(jcs, device="cpu")
    assert np.array_equal(cs.warm.x.numpy(), get(get(jcs, "warm"), "x"))
    f = convert.forest(jf, device="cpu")
    assert np.array_equal(f.tree_pos.numpy(), get(jf, "tree_pos"))
    assert f.tree_valid.dtype == torch.bool
    plan = convert.schur_plan(jplan, device="cpu")
    assert plan.perm.dtype == torch.int64
    assert np.array_equal(plan.N.numpy(), get(jplan, "N"))


def test_converted_matches_port_setup():
    jp, js, jcs, jf, jplan = _jax_side()
    tp, tcol, ts = setup.rqp_setup(N, device="cpu")
    cfg = cadmm.make_config(tp, tcol.collision_radius, tcol.max_deceleration,
                            max_iter=20, inner_iters=20, pad_operators=True,
                            device="cpu")
    p = convert.rqp_params(jp, device="cpu")
    for k in ("m", "J", "ml", "Jl", "r"):
        _eq(getattr(p, k), getattr(tp, k))
    # Derived sums over the agents: reduction order (x_com is 0 up to it).
    for k in ("mT", "x_com", "r_com", "JT"):
        _eq(getattr(p, k), getattr(tp, k), exact=False, atol=1e-6)
    _eq(p.JT_inv, tp.JT_inv, exact=False, atol=1e-5)
    s = convert.rqp_state(js, device="cpu")
    for k in s.__dataclass_fields__:
        _eq(getattr(s, k), getattr(ts, k))
    f = convert.forest(jf, device="cpu")
    tf = forest.make_forest(seed=0, device="cpu")
    for k in ("tree_pos", "tree_valid", "num_trees"):
        _eq(getattr(f, k), getattr(tf, k))
    cs = convert.cadmm_state(jcs, device="cpu")
    own = cadmm.init_cadmm_state(tp, cfg)
    for a, b in zip(cs.warm, own.warm):
        _eq(a, b, exact=False, atol=1e-6)
    _eq(cs.f, own.f, exact=False, atol=1e-6)
    plan = convert.schur_plan(jplan, device="cpu")
    own_plan = cadmm.make_plan(tp, cfg)
    _eq(plan.perm, own_plan.perm)
    _eq(plan.inv_perm, own_plan.inv_perm)
    for k in ("J", "N", "Yinv", "UUcore", "CUcore", "Mu", "scale"):
        a, b = getattr(plan, k), getattr(own_plan, k)
        _eq(a, b, exact=False, atol=1e-5 * float(b.abs().max()))


def test_step_from_converted_state_equals_own_setup():
    """One port MPC step over 4 scenarios from the converted JAX state and
    plan, against one from the port's own set-up."""
    jp, js, jcs, jf, jplan = _jax_side()
    S = 4
    p = convert.rqp_params(jp, device="cpu")
    tp, tcol, ts0 = setup.rqp_setup(N, device="cpu")
    cfg = cadmm.make_config(p, tcol.collision_radius, tcol.max_deceleration,
                            max_iter=20, inner_iters=20, pad_operators=True,
                            device="cpu")
    acc = (torch.tensor([0.3, 0.0, 0.0]), torch.zeros(3))

    def step(params, state0, cs0, fst, plan):
        f_eq = centralized.equilibrium_forces(params)
        css = rollout.stack_scenarios(cs0, S)
        states = rollout.scenario_batch(state0, S)
        _, css, stats = cadmm.control(params, cfg, f_eq, css, states, acc,
                                      fst, plan=plan)
        return css, stats

    css_c, st_c = step(p, convert.rqp_state(js, device="cpu"),
                       convert.cadmm_state(jcs, device="cpu"),
                       convert.forest(jf, device="cpu"),
                       convert.schur_plan(jplan, device="cpu"))
    css_o, st_o = step(tp, ts0, cadmm.init_cadmm_state(tp, cfg),
                       forest.make_forest(seed=0, device="cpu"),
                       cadmm.make_plan(tp, cfg))
    np.testing.assert_array_equal(st_c.iters.numpy(), st_o.iters.numpy())
    for a, b in ((css_c.f, css_o.f), (css_c.warm.x, css_o.warm.x),
                 (css_c.lam, css_o.lam)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("as_dict", [False, True], ids=["pytree", "dict"])
def test_forest_carries_grid(as_dict):
    """A JAX forest with its spatial-hash grid: the grid's index slabs (as
    int64 holding the same values), flags, origin and ``inv_cell``, and its
    static fields come across, and the port's bucketed rows on the
    converted forest equal its rows on a grid the port built itself."""
    from tpu_aerial_transport.envs import spatial as jspatial
    from tpu_aerial_transport_torch.envs import spatial

    jf = _np(jspatial.with_grid(jforest.make_forest(seed=0), 6.3))
    if as_dict:
        g = jf.grid
        jf = {k: getattr(jf, k) for k in jf.__dataclass_fields__}
        jf["grid"] = {k: getattr(g, k) for k in g.__dataclass_fields__}
    f = convert.forest(jf, device="cpu")
    src = jf["grid"] if as_dict else jf.grid
    get = (lambda t, k: t[k]) if as_dict else getattr
    assert isinstance(f.grid, spatial.SpatialGrid)
    assert f.grid.cell_idx.dtype == torch.int64
    np.testing.assert_array_equal(f.grid.cell_idx.numpy(),
                                  get(src, "cell_idx").astype(np.int64))
    np.testing.assert_array_equal(f.grid.cell_valid.numpy(),
                                  get(src, "cell_valid"))
    np.testing.assert_array_equal(f.grid.origin.numpy(), get(src, "origin"))
    assert f.grid.inv_cell.numpy() == get(src, "inv_cell")
    for k in ("nx", "ny", "k", "query_radius", "cell_size"):
        assert getattr(f.grid, k) == get(src, k)
    own = spatial.with_grid(forest.make_forest(seed=0, device="cpu"), 6.3)
    xl = torch.tensor([[30.0, 0.0, 2.0], [20.0, 5.0, 2.5]])
    vl = torch.tensor([[0.5, 0.0, 0.0], [0.0, 0.4, 0.0]])
    kw = dict(collision_radius=1.0, max_deceleration=2.0, vision_radius=6.0,
              dist_eps=0.1, alpha_env_cbf=1.5, n_rows=10,
              env_query="bucketed")
    a = forest.collision_cbf_rows(f, xl, vl, **kw)
    b = forest.collision_cbf_rows(own, xl, vl, **kw)
    assert torch.equal(a.lhs, b.lhs) and torch.equal(a.rhs, b.rhs)
