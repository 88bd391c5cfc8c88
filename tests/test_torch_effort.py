"""PyTorch port vs the JAX package: adaptive solver effort and the chunked
solve route -- the early-exit form of the whole-solve kernel's plain
version, the chunk kernel's plain version, ``solve_socp``'s
tolerance-chunked path on both routes, and C-ADMM control steps and
rollouts with ``effort="adaptive"`` and ``inner_tol > 0``.

The JAX side of each kernel comparison runs the Pallas kernel the way the
JAX package's own tests run it on the CPU: under the interpreter, the
whole-solve kernel in its compiled form (``exact_dot=False``). Solves and
control steps compare against the JAX scan path under ``jax.vmap``.

Tolerances, and why:

- Kernel plain versions and solves: 1e-4 x max(1, |ref|), the JAX
  package's own bar for the compiled kernel form against the exact one
  (tests/test_fused_solve.py): both sides are float32, but the per-lane
  matvecs sum in another order and the equality rows' 1e3-boosted
  penalties amplify that rounding over the iterations. The exit residuals
  are held to 1e-4 x max(1, |y|): the dual residual |P x + q + A^T y|
  sums A^T y over the rows, so it carries the rounding of the duals y
  (|y| up to ~6 here), not its own small size.
- Effective iteration counts are discrete and must be equal. A lane whose
  residual sits at ``tol`` at a chunk boundary may flip under that
  rounding, so the tests use only lanes whose residual at every chunk
  boundary lies at least 1% away from ``tol`` (asserted on the problems
  they pick).
- Control steps and rollouts: the bars of tests/test_torch_cadmm.py and
  tests/test_torch_rollout.py (forces 1e-4 N, states 1e-4); consensus
  iteration counts and total inner iterations must be equal.
"""

import bench
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cadmm import _scenarios, _t

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import centralized as jcentral
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport.ops import admm_kernel as jkernel
from tpu_aerial_transport.ops import socp as jsocp
from tpu_aerial_transport_torch.control import cadmm, centralized
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.ops import admm_kernel, socp

ORDER = ["x", "y", "z", "K2", "Minv", "A", "P", "q", "rho", "lb", "ub",
         "shift"]
# (nv, n_box, soc): the padded C-ADMM agent QP (d = 48), the padded DD
# agent QP (d = 56) and the unpadded C-ADMM one (nv = 12, m = 25).
DIMS = {"cadmm": (16, 24, (4, 4)), "dd": (24, 24, (4, 4)),
        "unpadded": (12, 17, (4, 4))}
TOL, CHECK_EVERY = 1e-3, 7


def _problems(B, nv, n_box, soc, seed=0):
    """Seeded PSD problems with 3 equality rows (the boosted penalty), as
    tests/test_torch_socp.py builds them, with JAX-built operators and a
    projected cold start plus a small random warm start."""
    rng = np.random.default_rng(seed)
    m = n_box + sum(soc)
    L = rng.standard_normal((B, nv, nv))
    P = L @ np.swapaxes(L, -1, -2) + np.eye(nv)
    q = rng.standard_normal((B, nv))
    A = rng.standard_normal((B, m, nv)) * 0.5
    lb = rng.uniform(-2.0, -0.5, (B, n_box))
    ub = rng.uniform(0.5, 2.0, (B, n_box))
    lb[:, :3] = ub[:, :3] = rng.uniform(-0.5, 0.5, (B, 3))
    shift = np.zeros((B, m))
    off = n_box
    for k in soc:
        shift[:, off] = 3.0
        off += k
    P, q, A, lb, ub, shift = (a.astype(np.float32)
                              for a in (P, q, A, lb, ub, shift))
    rho = np.asarray(jax.vmap(
        lambda l_, u_: jsocp.make_rho_vec(m, n_box, l_, u_, 0.4))(lb, ub))
    op = jax.vmap(jsocp.kkt_operator)(jnp.asarray(P), jnp.asarray(A),
                                      jnp.asarray(rho))
    z0 = np.asarray(jax.vmap(lambda l_, u_, s_: jsocp._project_cone(
        jnp.zeros(m), l_, u_, n_box, soc, s_))(lb, ub, shift))
    x0 = (0.1 * rng.standard_normal((B, nv))).astype(np.float32)
    y0 = (0.1 * rng.standard_normal((B, m))).astype(np.float32)
    return dict(x=x0, y=y0, z=z0, K2=np.asarray(op.K2),
                Minv=np.asarray(op.Minv), A=A, P=P, q=q, rho=rho, lb=lb,
                ub=ub, shift=shift)


def _boundary_margin(arrs, statics, iters, check_every, tol):
    """Per lane, the smallest relative distance of ``max(prim, dual)`` from
    ``tol`` over the chunk boundaries 0, check_every, ... (the port's plain
    fixed-iteration form run to each boundary)."""
    margin = np.full(arrs["x"].shape[0], np.inf)
    for k in range(0, iters + 1, check_every):
        out = admm_kernel.fused_solve_lanes_reference(
            *[_t(arrs[n]) for n in ORDER], iters=k, alpha=1.6, **statics)
        res = torch.maximum(out[3], out[4]).numpy()
        margin = np.minimum(margin, np.abs(res / tol - 1.0))
    return margin


def _pick(arrs, statics, iters, check_every, tol, n):
    """``n`` lanes whose residuals stay 1% clear of ``tol`` at every chunk
    boundary."""
    margin = _boundary_margin(arrs, statics, iters, check_every, tol)
    keep = np.flatnonzero(margin > 0.01)[:n]
    assert len(keep) == n, f"only {len(keep)} clear lanes"
    picked = {k: v[keep] for k, v in arrs.items()}
    assert np.all(_boundary_margin(picked, statics, iters, check_every, tol)
                  > 0.01)
    return picked


def _close(out, ref, bar=1e-4):
    """Outputs to ``bar x max(1, |ref|)``; for a solution ``(x, y, z,
    prim_res, dual_res)`` the residuals to ``bar x max(1, |y|)``."""
    ref = [np.asarray(a) for a in ref]
    for i, (a, b) in enumerate(zip(ref, out)):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        scale = np.abs(ref[1] if i >= 3 else a).max()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=bar * max(1.0, scale))


@pytest.mark.parametrize("gate", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("dims", list(DIMS), ids=list(DIMS))
def test_early_exit_reference_matches_pallas_compiled_form(dims, gate):
    """The early-exit form's plain version against the JAX kernel's
    compiled form under the interpreter (check_every 7, tol 1e-3, 40
    iterations: 5 chunks and a remainder of 5), with half the lanes gated
    off or none: equal effective iteration counts, outputs to 1e-4."""
    nv, n_box, soc = DIMS[dims]
    statics = dict(nv=nv, n_box=n_box, soc_dims=soc)
    arrs = _pick(_problems(24, nv, n_box, soc), statics, 40, CHECK_EVERY,
                 TOL, 10)
    active = (np.arange(10) % 2 == 0) if gate else None
    kw = dict(statics, iters=40, alpha=1.6, check_every=CHECK_EVERY, tol=TOL)
    ref = jkernel.fused_solve_lanes(
        *[jnp.asarray(arrs[k]) for k in ORDER],
        None if active is None else jnp.asarray(active),
        interpret=True, exact_dot=False, **kw,
    )
    out = admm_kernel.fused_solve_lanes_reference(
        *[_t(arrs[k]) for k in ORDER],
        None if active is None else torch.as_tensor(active), **kw,
    )
    eff = out[5].numpy()
    np.testing.assert_array_equal(eff, np.asarray(ref[5]))
    assert out[5].dtype == torch.int32
    assert len(set(eff.tolist())) > 1  # the lanes stop apart.
    if gate:
        assert np.all(eff[~active] == 0) and np.all(eff[active] > 0)
        # A gated-off lane passes its warm start through.
        assert torch.equal(out[0][~torch.as_tensor(active)],
                           _t(arrs["x"])[~active])
    _close(out[:5], ref[:5])
    # The dispatching wrapper takes the plain version for CPU tensors and
    # counts no kernel launch.
    before = dict(admm_kernel.LAUNCHES)
    again = admm_kernel.fused_solve_lanes(
        *[_t(arrs[k]) for k in ORDER],
        None if active is None else torch.as_tensor(active), **kw)
    assert admm_kernel.LAUNCHES == before
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_early_exit_counts_and_nan_lanes():
    """The counting rules, on the plain version (check_every 10 of 25, tol
    1e-3; these problems' residuals fall from ~5 to 4e-2 after 10
    iterations and to 6e-4 or 2e-3 after 20, and stall near 7e-4): a lane
    converged at its warm start runs 0 iterations even with its gate on
    (the first test comes before any iteration); a lane that converges at
    a boundary stops there; the remainder chunk runs only for a lane still
    above tolerance; a non-finite lane is frozen (NaN compares false) and
    keeps its NaN residual."""
    nv, n_box, soc = DIMS["cadmm"]
    statics = dict(nv=nv, n_box=n_box, soc_dims=soc)
    arrs = {k: _t(v) for k, v in _problems(4, nv, n_box, soc).items()}
    done = admm_kernel.fused_solve_lanes_reference(
        *[arrs[k] for k in ORDER], iters=400, alpha=1.6, **statics)
    for i, k in enumerate(("x", "y", "z")):
        arrs[k][1] = done[i][1]
    arrs["x"][3, 0] = float("nan")  # both residuals NaN from the start.
    out = admm_kernel.fused_solve_lanes_reference(
        *[arrs[k] for k in ORDER], torch.ones(4, dtype=torch.bool),
        iters=25, alpha=1.6, check_every=10, tol=1e-3, **statics)
    assert out[5].tolist() == [20, 0, 25, 0]
    assert torch.equal(out[0][1], arrs["x"][1])
    assert torch.equal(out[0][3, 1:], arrs["x"][3, 1:])
    assert torch.isnan(out[3][3]) and torch.isnan(out[4][3])


@pytest.mark.parametrize("dims", ["cadmm", "unpadded"])
def test_chunk_reference_matches_pallas_chunk_kernel(dims):
    """The chunk kernel's plain version against JAX ``admm_chunk_lanes``
    under the interpreter (15 iterations, a given w2): outputs to 1e-4."""
    nv, n_box, soc = DIMS[dims]
    arrs = _problems(6, nv, n_box, soc, seed=2)
    wq = np.einsum("bij,bj->bi", arrs["Minv"], arrs["q"])
    w2 = np.concatenate([wq, np.einsum("bij,bj->bi", arrs["A"], wq)], -1)
    args = [arrs["x"], arrs["y"], arrs["z"], arrs["K2"], w2.astype(np.float32),
            arrs["rho"], arrs["lb"], arrs["ub"], arrs["shift"]]
    kw = dict(nv=nv, n_box=n_box, soc_dims=soc, iters=15, alpha=1.6)
    ref = jkernel.admm_chunk_lanes(*map(jnp.asarray, args), interpret=True,
                                   **kw)
    out = admm_kernel.admm_chunk_lanes_reference(*map(_t, args), **kw)
    _close(out, ref)
    before = dict(admm_kernel.LAUNCHES)
    again = admm_kernel.admm_chunk_lanes(*map(_t, args), **kw)
    assert admm_kernel.LAUNCHES == before
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def _solve_problems(seed=4):
    """A batch of solve_socp problems (unpadded C-ADMM dims) whose lanes
    stay 1% clear of TOL at every chunk boundary of both schedules the
    tests use (check_every 7 of 40, and 10 of 25)."""
    nv, n_box, soc = DIMS["unpadded"]
    arrs = _problems(32, nv, n_box, soc, seed=seed)
    statics = dict(nv=nv, n_box=n_box, soc_dims=soc)
    margin = np.minimum(
        _boundary_margin(arrs, statics, 40, 7, TOL),
        _boundary_margin(arrs, statics, 25, 10, TOL))
    keep = np.flatnonzero(margin > 0.01)[:8]
    assert len(keep) == 8
    return {k: v[keep] for k, v in arrs.items()}, n_box, soc


def _jax_solve(arrs, n_box, soc, active, **kw):
    """Vmapped JAX solve_socp on the scan path, warm-started from the
    problems' start and given their (JAX-built) operator."""
    B = len(arrs["x"])
    warm = jsocp.SOCPSolution(
        x=jnp.asarray(arrs["x"]), y=jnp.asarray(arrs["y"]),
        z=jnp.asarray(arrs["z"]), prim_res=jnp.zeros(B),
        dual_res=jnp.zeros(B))
    op = jsocp.KKTOp(Minv=jnp.asarray(arrs["Minv"]), MinvAT=None,
                     sigma=jnp.full((B,), 1e-6), K2=jnp.asarray(arrs["K2"]))

    def one(P_, q_, A_, l_, u_, s_, w_, o_, a_):
        return jsocp.solve_socp(P_, q_, A_, l_, u_, shift=s_, warm=w_, op=o_,
                                n_box=n_box, soc_dims=soc, fused="scan",
                                active=a_, report_iters=True, **kw)

    return jax.vmap(one)(*(jnp.asarray(arrs[k]) for k in
                           ("P", "q", "A", "lb", "ub", "shift")),
                         warm, op, jnp.asarray(active))


def _port_solve(arrs, n_box, soc, active, route, **kw):
    """The port's batched solve_socp on the same problems and operator."""
    B = len(arrs["x"])
    warm = socp.SOCPSolution(
        x=_t(arrs["x"]), y=_t(arrs["y"]), z=_t(arrs["z"]),
        prim_res=torch.zeros(B), dual_res=torch.zeros(B))
    op = socp.KKTOp(Minv=_t(arrs["Minv"]), MinvAT=None, K2=_t(arrs["K2"]))
    return socp.solve_socp(
        *(_t(arrs[k]) for k in ("P", "q", "A", "lb", "ub")),
        shift=_t(arrs["shift"]), warm=warm, op=op, n_box=n_box,
        soc_dims=soc, fused=route,
        active=None if active is None else torch.as_tensor(active),
        report_iters=True, **kw)


@pytest.mark.parametrize("case", ["gated", "remainder"])
@pytest.mark.parametrize("route", ["kernel", "pallas"])
def test_solve_socp_tolerance_path_matches_jax(route, case):
    """solve_socp's tolerance-chunked path on both routes against vmapped
    JAX ``solve_socp(fused="scan", check_every, tol, active,
    report_iters=True)``: check_every 7 of 40 with half the lanes gated
    off, or check_every 10 of 25 (a remainder chunk of 5) ungated."""
    arrs, n_box, soc = _solve_problems()
    if case == "gated":
        kw = dict(iters=40, check_every=7, tol=TOL)
        active = np.arange(8) % 2 == 1
    else:
        kw = dict(iters=25, check_every=10, tol=TOL)
        active = np.ones(8, bool)
    ref, ref_eff = _jax_solve(arrs, n_box, soc, active, **kw)
    out, eff = _port_solve(arrs, n_box, soc,
                           active if case == "gated" else None, route, **kw)
    np.testing.assert_array_equal(eff.numpy(), np.asarray(ref_eff))
    if case == "remainder":
        assert 25 in eff.tolist() and len(set(eff.tolist())) > 1
    else:
        assert np.all(eff.numpy()[~active] == 0)
    _close(out, ref)


@pytest.mark.parametrize("route", ["kernel", "pallas"])
def test_fast_lane_does_not_depend_on_stragglers(route):
    """The batch runs chunks while any lane is active, but a fast lane's
    result and effective count do not depend on the stragglers beside it:
    with the slowest lane replaced by a clone of the fastest, the fast
    lane is bitwise the same (the JAX package's
    tests/test_effort.py:117-147 property)."""
    arrs, n_box, soc = _solve_problems()
    kw = dict(iters=40, check_every=7, tol=TOL)
    sol, eff = _port_solve(arrs, n_box, soc, None, route, **kw)
    fast = int(eff.argmin())
    slow = (eff > eff[fast]).numpy()
    assert slow.any()
    clone = {k: v.copy() for k, v in arrs.items()}
    for k in clone:
        clone[k][slow] = arrs[k][fast]
    sol_c, eff_c = _port_solve(clone, n_box, soc, None, route, **kw)
    assert int(eff_c[fast]) == int(eff[fast])
    assert int(eff_c.max()) < int(eff.max())  # the batch stopped earlier.
    for a, b in zip(sol, sol_c):
        assert torch.equal(a[fast], b[fast])


def _control_pair(n, kw, route, S=3):
    """One C-ADMM control step of S scenarios: vmapped JAX (scan path) and
    the port (``route``), both with the controller knobs ``kw``."""
    sc = _scenarios(n, S)
    keys = ("xl", "vl", "Rl", "wl", "R", "w")
    jp, jcol, js = jsetup.rqp_setup(n)
    jcfg = jcadmm.make_config(
        jp, jcol.collision_radius, jcol.max_deceleration, max_iter=20,
        inner_iters=20, socp_fused="scan", pad_operators=True, **kw)
    f_eq = jcentral.equilibrium_forces(jp)
    cs0 = jcadmm.init_cadmm_state(jp, jcfg)
    plan = jcadmm.make_plan(jp, jcfg)
    jf = jforest.make_forest(seed=0)
    acc = (jnp.array([0.3, 0.0, 0.0], jnp.float32), jnp.zeros(3, jnp.float32))
    css = jax.vmap(lambda _: cs0)(jnp.arange(S))
    states = jax.vmap(lambda *a: js.replace(**dict(zip(keys, a))))(
        *(jnp.asarray(sc[k], jnp.float32) for k in keys))
    ref = jax.jit(jax.vmap(lambda cs, s: jcadmm.control(
        jp, jcfg, f_eq, cs, s, acc, jf, plan=plan)))(css, states)

    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    cfg = cadmm.make_config(
        tp, tcol.collision_radius, tcol.max_deceleration, max_iter=20,
        inner_iters=20, pad_operators=True, socp_fused=route, device="cpu",
        **kw)
    tf_eq = centralized.equilibrium_forces(tp)
    tcss = rollout.stack_scenarios(cadmm.init_cadmm_state(tp, cfg, tf_eq), S)
    tst = rollout.stack_scenarios(ts, S).replace(
        **{k: _t(sc[k]) for k in keys})
    out = cadmm.control(tp, cfg, tf_eq, tcss, tst,
                        (_t([0.3, 0.0, 0.0]), torch.zeros(3)),
                        forest.make_forest(seed=0, device="cpu"),
                        plan=cadmm.make_plan(tp, cfg))
    return ref, out


@pytest.mark.parametrize("route", ["kernel", "pallas"])
@pytest.mark.parametrize("kw", [dict(effort="adaptive"),
                                dict(inner_tol=1e-3)],
                         ids=["adaptive", "inner_tol"])
@pytest.mark.parametrize("n", [4, 8])
def test_control_step_matches_vmapped_jax(n, kw, route):
    (jf_app, jcs, jst), (f_app, cs, st) = _control_pair(n, kw, route)
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
    assert int(st.iters.max()) > 1
    # Total effective inner iterations: equal under adaptive effort, empty
    # (S, 0) otherwise, as in the JAX package.
    np.testing.assert_array_equal(st.inner_iters.numpy(),
                                  np.asarray(jst.inner_iters))
    assert st.inner_iters.dtype == torch.int32
    if kw.get("effort") == "adaptive":
        inner = st.inner_iters.numpy()
        assert np.all(inner > 0)
        assert np.all(inner <= n * 20 * st.iters.numpy())
    else:
        assert st.inner_iters.shape == (3, 0)
    for a, b in ((jf_app, f_app), (jcs.f, cs.f), (jcs.f_mean, cs.f_mean),
                 (jcs.lam, cs.lam), (jcs.warm.x, cs.warm.x),
                 (jst.solve_res, st.solve_res)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4,
                                   rtol=0)
    np.testing.assert_allclose(st.err_seq.numpy(), np.asarray(jst.err_seq),
                               atol=1e-4, rtol=0, equal_nan=True)
    np.testing.assert_array_equal(st.ok_frac.numpy(), np.asarray(jst.ok_frac))


def test_adaptive_gate_spares_converged_scenarios():
    """Adaptive effort spends fewer inner iterations than the fixed budget
    on a batch whose scenarios finish apart, and agrees with the fixed arm
    within the consensus tolerance (the JAX package's equal-quality bar,
    1e-2 N)."""
    n = 4
    (_, _, _), (f_ad, _, st_ad) = _control_pair(n, dict(effort="adaptive"),
                                                "kernel")
    (_, _, _), (f_fx, _, st_fx) = _control_pair(n, dict(effort="fixed"),
                                                "kernel")
    assert len(set(st_fx.iters.tolist())) > 1
    # The fixed arm spends n x inner_iters per consensus iteration.
    budget = n * 20 * st_ad.iters
    assert bool((st_ad.inner_iters <= budget).all())
    assert int(st_ad.inner_iters.sum()) < int(budget.sum())
    assert float((f_ad - f_fx).abs().max()) < 1e-2


def test_adaptive_rollout_matches_bench():
    """The slice as a whole: the adaptive headline rollout (C-ADMM, n = 8,
    whole-solve route) over 4 seeded scenarios for 2 MPC steps against
    ``bench.make_mpc_step("cadmm", 8, effort="adaptive")`` vmapped:
    equal consensus and inner iteration counts per step, states to 1e-4
    (see tests/test_torch_rollout.py for that bar)."""
    S, steps = 4, 2
    jstep, jcs0, jstate0 = bench.make_mpc_step("cadmm", 8, effort="adaptive",
                                               socp_fused="scan")
    jstates = bench._scenario_batch(jstate0, S)
    jcss = jax.vmap(lambda _: jcs0)(jnp.arange(S))
    jrun = jax.jit(jax.vmap(jstep))
    mpc_step, cs0, state0 = rollout.make_mpc_step(
        "cadmm", 8, effort="adaptive", device="cpu")
    states = rollout.scenario_batch(state0, S)
    css = rollout.stack_scenarios(cs0, S)
    for _ in range(steps):
        jcss, jstates, jst = jrun(jcss, jstates)
        css, states, st = mpc_step(css, states)
        np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
        np.testing.assert_array_equal(st.inner_iters.numpy(),
                                      np.asarray(jst.inner_iters))
    for f in ("xl", "vl", "Rl", "wl", "R", "w"):
        np.testing.assert_allclose(getattr(states, f).numpy(),
                                   np.asarray(getattr(jstates, f)),
                                   atol=1e-4, rtol=0, err_msg=f)
