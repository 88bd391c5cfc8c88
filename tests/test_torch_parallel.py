"""PyTorch port vs the JAX package: the agent-sharded C-ADMM and DD steps
(``parallel.mesh``), the port's shard axis on one device against the JAX
package's ``shard_map`` on the virtual 8-device CPU mesh (conftest.py).

Inputs are those of ``tests/test_ring.py:175-206`` (``max_iter=4``,
``inner_iters=8``, payload velocity (0.2, 0.1, 0), ``acc_des = ((0.3, 0,
0.1), 0)``, no forest), carried across with ``convert.py``. Each JAX
sharded step compiles once, in the module-scoped ``jax_sharded`` fixture.

Tolerances, and why: consensus iteration counts are discrete and must be
equal. Forces and final residuals agree to 1e-4 N for C-ADMM and 2e-3 N
for DD, the single-program bars of ``tests/test_torch_cadmm.py`` and
``tests/test_torch_dd.py`` (the frameworks' float32 KKT inverses differ in
their last bits, which DD's 1e3-boosted equality penalties and
quasi-Newton step amplify); the exchange only adds float32 summation-order
differences on top. The sharded step against the port's own single
program holds to the same bars, and each scenario of a batch to its solo
run as ``tests/test_torch_cadmm.py`` holds it (1e-6 N).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.control import dd as jdd
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.parallel import mesh as jmesh
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.control import cadmm, centralized, dd
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.parallel import mesh, ring

BARS = {"cadmm": 1e-4, "dd": 2e-3}
CFG = dict(max_iter=4, inner_iters=8)
VL = (0.2, 0.1, 0.0)
ACC = ((0.3, 0.0, 0.1), (0.0, 0.0, 0.0))
# (controller, n, shards, impl) of the JAX references: two agents a shard
# with both XLA impls, one agent a shard with the all-reduce.
JAX_CASES = [(c, n, d, impl) for c in ("cadmm", "dd")
             for n, d, impl in ((8, 4, "allreduce"), (8, 4, "ring"),
                                (4, 4, "allreduce"))]
MODS = {"cadmm": (jcadmm, cadmm), "dd": (jdd, dd)}


def _jax_sharded(ctrl, n, d, impl):
    """One JAX sharded step through ``parallel.mesh``: its inputs and
    outputs as numpy trees."""
    jmod = MODS[ctrl][0]
    jp, jcol, js = jsetup.rqp_setup(n)
    js = js.replace(vl=jnp.asarray(VL, jnp.float32))
    acc = tuple(jnp.asarray(a, jnp.float32) for a in ACC)
    f_eq = jcentral.equilibrium_forces(jp)
    cfg = jmod.make_config(jp, jcol.collision_radius, jcol.max_deceleration,
                           consensus_impl=impl, **CFG)
    m = jmesh.make_mesh({"agent": d})
    if ctrl == "cadmm":
        cs0 = jcadmm.init_cadmm_state(jp, cfg)
        step = jmesh.cadmm_control_sharded(jp, cfg, f_eq, m)
    else:
        cs0 = jdd.init_dd_state(jp, cfg)
        step = jmesh.dd_control_sharded(jp, cfg, f_eq, m)
    out = jax.jit(step)(cs0, js, acc)
    return jax.tree.map(np.asarray, ((cs0, js), out))


@pytest.fixture(scope="module")
def jax_sharded():
    cache = {}

    def get(ctrl, n, d, impl):
        key = (ctrl, n, d, impl)
        if key not in cache:
            cache[key] = _jax_sharded(*key)
        return cache[key]

    return get


def _port(ctrl, n, impl="allreduce", **kw):
    """The port's params, config and shared inputs on the CPU."""
    tp, tcol, _ = setup.rqp_setup(n, device="cpu")
    cfg = MODS[ctrl][1].make_config(
        tp, tcol.collision_radius, tcol.max_deceleration,
        consensus_impl=impl, device="cpu", **{**CFG, **kw})
    acc = tuple(torch.tensor(a, dtype=torch.float32) for a in ACC)
    return tp, cfg, centralized.equilibrium_forces(tp), acc


def _port_inputs(ctrl, jin):
    """The JAX step's inputs as the port's, with a scenario axis of 1."""
    jcs, js = jin
    to_cs = convert.cadmm_state if ctrl == "cadmm" else convert.dd_state
    return (rollout.stack_scenarios(to_cs(jcs, device="cpu"), 1),
            rollout.stack_scenarios(convert.rqp_state(js, device="cpu"), 1))


def _sharded_step(ctrl, n, d, impl):
    tp, cfg, f_eq, acc = _port(ctrl, n, impl)
    build = (mesh.cadmm_control_sharded if ctrl == "cadmm"
             else mesh.dd_control_sharded)
    m = mesh.make_mesh({"agent": d})
    return build(tp, cfg, f_eq, m), acc


def _assert_matches(ctrl, out, ref_f, ref_iters, ref_res):
    f, _, stats = out
    bar = BARS[ctrl]
    np.testing.assert_array_equal(stats.iters.numpy(), ref_iters)
    np.testing.assert_allclose(f.numpy(), ref_f, rtol=0, atol=bar)
    np.testing.assert_allclose(stats.solve_res.numpy(), ref_res, rtol=0,
                               atol=bar)


@pytest.mark.parametrize("ctrl,n,d,impl", JAX_CASES,
                         ids=lambda v: str(v))
def test_sharded_step_matches_jax(jax_sharded, ctrl, n, d, impl):
    """The port's sharded step against the JAX package's with the same
    impl: equal consensus iteration counts, forces and final residual
    within the bar, the state's global shape kept."""
    jin, (jf, jcs, jst) = jax_sharded(ctrl, n, d, impl)
    step, acc = _sharded_step(ctrl, n, d, impl)
    cs, st = _port_inputs(ctrl, jin)
    out = step(cs, st, acc)
    _assert_matches(ctrl, out, jf[None], np.asarray(jst.iters)[None],
                    np.asarray(jst.solve_res)[None])
    assert int(out[2].iters[0]) > 1
    for name in out[1]._fields:
        if getattr(jcs, name) is None:
            # The fault path's held snapshots: None in both packages.
            assert getattr(out[1], name) is None, name
        elif name != "warm":
            assert getattr(out[1], name).shape[1:] == getattr(jcs, name).shape
    if ctrl == "cadmm":
        np.testing.assert_allclose(out[1].f_mean[0].numpy(), jcs.f_mean,
                                   rtol=0, atol=BARS[ctrl])


@pytest.mark.parametrize("ctrl", ["cadmm", "dd"])
def test_pallas_ring_matches_jax_ring(jax_sharded, ctrl):
    """``"pallas_ring"`` on the CPU (the ring-sum kernel's plain version)
    against the JAX package's ``"ring"``, which is what JAX runs for
    ``"pallas_ring"`` off the TPU; no kernel launch is counted."""
    jin, (jf, _, jst) = jax_sharded(ctrl, 8, 4, "ring")
    step, acc = _sharded_step(ctrl, 8, 4, "pallas_ring")
    before = dict(ring.LAUNCHES)
    out = step(*_port_inputs(ctrl, jin), acc)
    assert ring.LAUNCHES == before
    _assert_matches(ctrl, out, jf[None], np.asarray(jst.iters)[None],
                    np.asarray(jst.solve_res)[None])


@pytest.mark.parametrize("impl", ring.IMPLS)
@pytest.mark.parametrize("ctrl,n,d", [("cadmm", 8, 4), ("dd", 8, 4),
                                      ("cadmm", 4, 4)])
def test_sharded_step_matches_single_program(jax_sharded, ctrl, n, d, impl):
    """The port's sharded step against its own single program on the same
    inputs, to the same bars."""
    jin, _ = jax_sharded(ctrl, n, d, "allreduce")
    cs, st = _port_inputs(ctrl, jin)
    tp, cfg, f_eq, acc = _port(ctrl, n)
    mod = MODS[ctrl][1]
    plan = cadmm.make_plan(tp, cfg) if ctrl == "cadmm" else None
    ref = mod.control(tp, cfg, f_eq, cs, st, acc, plan=plan)
    step, _ = _sharded_step(ctrl, n, d, impl)
    out = step(cs, st, acc)
    _assert_matches(ctrl, out, ref[0].numpy(), ref[2].iters.numpy(),
                    ref[2].solve_res.numpy())
    np.testing.assert_array_equal(out[2].ok_frac.numpy(),
                                  ref[2].ok_frac.numpy())


@pytest.mark.parametrize("ctrl", ["cadmm", "dd"])
def test_batch_matches_solo_runs(ctrl):
    """Three scenarios of one sharded batch (``"pallas_ring"``, adaptive
    effort) against three solo runs, lane by lane; they stop at different
    iterations, so the frozen scenarios keep their carry."""
    n, d = 8, 4
    tp, cfg, f_eq, acc = _port(ctrl, n, "pallas_ring", effort="adaptive",
                               max_iter=20, inner_iters=20)
    _, _, ts = setup.rqp_setup(n, device="cpu")
    init = (cadmm.init_cadmm_state(tp, cfg, f_eq) if ctrl == "cadmm"
            else dd.init_dd_state(tp, cfg, f_eq))
    S = 3
    states = rollout.stack_scenarios(ts, S).replace(
        vl=torch.tensor([VL, (0.5, 0.0, 0.0), (-0.3, 0.4, 0.1)]),
        wl=torch.tensor([(0.0, 0.0, 0.0), (0.1, -0.05, 0.0),
                         (0.0, 0.2, -0.1)]))
    build = (mesh.cadmm_control_sharded if ctrl == "cadmm"
             else mesh.dd_control_sharded)
    step = build(tp, cfg, f_eq, mesh.make_mesh({"agent": d}))
    f, _, stats = step(rollout.stack_scenarios(init, S), states, acc)
    assert len(set(stats.iters.tolist())) > 1
    for i in range(S):
        one = type(states)(**{k: v[i:i + 1] for k, v in
                              vars(states).items()})
        f1, _, st1 = step(rollout.stack_scenarios(init, 1), one, acc)
        assert int(st1.iters[0]) == int(stats.iters[i])
        assert int(st1.inner_iters[0]) == int(stats.inner_iters[i])
        np.testing.assert_allclose(f1[0].numpy(), f[i].numpy(), rtol=0,
                                   atol=1e-6)


def test_bad_shard_counts_raise():
    """n % d != 0 (at build and at call), the centralized controller with
    shards, and an exchange impl without shards are ValueErrors."""
    tp, cfg, f_eq, acc = _port("cadmm", 8)
    m3 = mesh.make_mesh({"agent": 3})
    with pytest.raises(ValueError, match="divide"):
        mesh.cadmm_control_sharded(tp, cfg, f_eq, m3)
    tp_d, cfg_d, f_eq_d, _ = _port("dd", 8)
    with pytest.raises(ValueError, match="divide"):
        mesh.dd_control_sharded(tp_d, cfg_d, f_eq_d, m3)
    _, _, ts = setup.rqp_setup(8, device="cpu")
    cs = rollout.stack_scenarios(cadmm.init_cadmm_state(tp, cfg, f_eq), 1)
    with pytest.raises(ValueError, match="divide"):
        cadmm.control(tp, cfg, f_eq, cs, rollout.stack_scenarios(ts, 1), acc,
                      shards=3)
    with pytest.raises(ValueError, match="shard"):
        rollout.make_mpc_step("centralized", 4, shards=2, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        rollout.make_mpc_step("cadmm", 4, shards=0, device="cpu")
    for ctrl in ("cadmm", "dd"):
        with pytest.raises(ValueError, match="needs shards > 1"):
            rollout.make_mpc_step(ctrl, 4, consensus_impl="pallas_ring",
                                  device="cpu")
    with pytest.raises(ValueError, match="one shard axis"):
        mesh.make_mesh({"agent": 2, "scenario": 2})
    with pytest.raises(ValueError, match=">= 1"):
        mesh.make_mesh({"agent": 0})


@pytest.mark.parametrize("impl", ring.IMPLS)
@pytest.mark.parametrize("ctrl", ["cadmm", "dd"])
def test_rollout_step_with_shards(ctrl, impl):
    """One MPC step of ``rollout.make_mpc_step(..., shards=2)`` at n = 4,
    two scenarios: finite, and at the single program's iteration counts
    and forces within the bar."""
    S = 2
    runs = {}
    for shards, kw in ((1, {}), (2, dict(consensus_impl=impl))):
        step, cs0, st0 = rollout.make_mpc_step(
            ctrl, 4, max_iter=6, shards=shards, device="cpu", **kw)
        runs[shards] = step(rollout.stack_scenarios(cs0, S),
                            rollout.scenario_batch(st0, S))
    (cs1, st1, stats1), (cs2, st2, stats2) = runs[1], runs[2]
    assert torch.isfinite(st2.xl).all() and torch.isfinite(cs2.f).all()
    assert torch.equal(stats2.iters, stats1.iters)
    np.testing.assert_allclose(cs2.f.numpy(), cs1.f.numpy(), rtol=0,
                               atol=BARS[ctrl])
