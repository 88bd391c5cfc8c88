"""PyTorch port vs the JAX package: bfloat16 operator storage of the
whole-solve kernel (``precision="bf16"``) -- the rounding of the four
operators, the kernel's plain version in both forms, ``solve_socp`` on both
routes, and C-ADMM and DD control steps with ``socp_precision="bf16"``.

The JAX side runs as the JAX package's own tests run it on the CPU: the
Pallas kernel under the interpreter in its compiled form
(``interpret=True, exact_dot=False``), and the controllers through
``socp_fused="kernel_interpret"`` (on the scan path bf16 is inert).

Tolerances, and why:

- Rounding: exact. Both frameworks round float32 to bfloat16 to nearest,
  ties to even, so the rounded operators are equal bit for bit.
- Kernel plain version: 1e-4 x max(1, |ref|) (residuals: x max(1, |y|)),
  the bar of the float32 forms (tests/test_torch_effort.py): both
  sides read the same rounded operators in float32, and only the matvecs'
  summation order differs. Effective iteration counts must be equal, on
  lanes picked 1% clear of tol at every chunk boundary (tol 0.5: bf16
  storage stalls these problems' residuals at 0.1-2).
- bf16 against float32: within 3e-2 after 30 iterations and not equal,
  the JAX package's own check (tests/test_fused_solve.py:452-465).
- Control steps: equal consensus iteration counts; states to 1e-4 (the
  rollout bar of tests/test_torch_rollout.py); C-ADMM forces to 1e-4 N;
  DD forces to 2e-3 N (its float32 KKT inverses differ between the
  frameworks by ~1e-4 relative, tests/test_torch_dd.py).
"""

import bench
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_fused_solve
from test_torch_cadmm import _t
from test_torch_effort import DIMS, ORDER, _close, _problems

from tpu_aerial_transport.ops import admm_kernel as jkernel
from tpu_aerial_transport_torch.control import cadmm, dd
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.ops import admm_kernel, socp

OPS = ("K2", "Minv", "A", "P")
# bf16 storage stalls these problems' residuals at 0.1-2 (the iterations
# run on the rounded K2, the residuals read the rounded A, and the two no
# longer agree on a fixed point), so the early-exit case stops at 0.5: a
# tol that splits the lanes.
TOL, CHECK_EVERY = 0.5, 7


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _jax_round(a: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _ties() -> np.ndarray:
    """float32 values exactly halfway between two bfloat16 values (both
    parities of the kept mantissa, both signs), one ulp either side of a
    tie, subnormals, the largest finite values and infinities."""
    kept = np.arange(0, 1 << 16, 97, dtype=np.uint32) << 16
    half = np.uint32(1 << 15)
    bits = np.concatenate([
        kept | half, (kept | half) + 1, (kept | half) - 1,
        np.array([0x00000001, 0x00008000, 0x007fffff, 0x7f7fffff, 0x7f800000,
                  0xff800000, 0x80008000, 0x3f808000, 0x3f818000],
                 np.uint32),
    ])
    vals = bits.view(np.float32)
    return vals[~np.isnan(vals)]


@pytest.mark.parametrize("which", ["ties", "operators"])
def test_rounding_equals_jax_astype_bitwise(which):
    """The rounded operators equal ``jnp.astype(jnp.bfloat16)`` bit for bit:
    on the rounding's edge cases, and on a batch of real KKT operators
    rounded the way the controllers round them (``socp.stored_operators``,
    each of K2, Minv, A and P on its own)."""
    if which == "ties":
        a = _ties()
        out = admm_kernel.store_operators((_t(a),), "bf16")[0]
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(out.float().numpy()),
                                      _bits(_jax_round(a)))
        return
    arrs = _problems(16, *DIMS["cadmm"])
    op = socp.KKTOp(Minv=_t(arrs["Minv"]), MinvAT=None, K2=_t(arrs["K2"]))
    op_s, A_s, P_s = socp.stored_operators(op, _t(arrs["A"]), _t(arrs["P"]),
                                           "bf16", "kernel")
    assert op_s.MinvAT is None
    for name, t in zip(OPS, (op_s.K2, op_s.Minv, A_s, P_s)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(t.float().numpy()),
                                      _bits(_jax_round(arrs[name])), name)
    # Off route "kernel", or in float32, nothing is rounded.
    for prec, route in (("bf16", "pallas"), ("f32", "kernel")):
        same = socp.stored_operators(op, _t(arrs["A"]), _t(arrs["P"]), prec,
                                     route)
        assert same[0] is op and same[1].dtype == torch.float32


def _bf16_margin(arrs, statics, iters, check_every, tol):
    """Per lane, the smallest relative distance of ``max(prim, dual)`` from
    ``tol`` over the chunk boundaries, on the bf16 plain version."""
    margin = np.full(arrs["x"].shape[0], np.inf)
    for k in range(0, iters + 1, check_every):
        out = admm_kernel.fused_solve_lanes_reference(
            *[_t(arrs[n]) for n in ORDER], iters=k, alpha=1.6,
            precision="bf16", **statics)
        res = torch.maximum(out[3], out[4]).numpy()
        margin = np.minimum(margin, np.abs(res / tol - 1.0))
    return margin


@pytest.mark.parametrize("form", ["fixed", "early_gated"])
@pytest.mark.parametrize("dims", ["cadmm", "dd"])
def test_bf16_reference_matches_pallas_compiled_form(dims, form):
    """The bf16 plain version against the JAX kernel's compiled form under
    the interpreter, at d = 48 (C-ADMM, with the cone shift) and d = 56
    (DD): 30 fixed iterations, or 40 in chunks of 7 to tol 0.5 with half
    the lanes gated off. Rounded-before and float32 operators give the
    same result bit for bit; the wrapper takes the plain version for CPU
    tensors and counts no launch."""
    nv, n_box, soc = DIMS[dims]
    statics = dict(nv=nv, n_box=n_box, soc_dims=soc)
    arrs = _problems(24, nv, n_box, soc, seed=5)
    if form == "fixed":
        kw = dict(statics, iters=30, alpha=1.6)
        active = None
        arrs = {k: v[:10] for k, v in arrs.items()}
    else:
        kw = dict(statics, iters=40, alpha=1.6, check_every=CHECK_EVERY,
                  tol=TOL)
        keep = np.flatnonzero(
            _bf16_margin(arrs, statics, 40, CHECK_EVERY, TOL) > 0.01)[:10]
        assert len(keep) == 10
        arrs = {k: v[keep] for k, v in arrs.items()}
        active = np.arange(10) % 2 == 0
    ref = jkernel.fused_solve_lanes(
        *[jnp.asarray(arrs[k]) for k in ORDER],
        None if active is None else jnp.asarray(active),
        precision="bf16", interpret=True, exact_dot=False, **kw,
    )
    gate = None if active is None else torch.as_tensor(active)
    out = admm_kernel.fused_solve_lanes_reference(
        *[_t(arrs[k]) for k in ORDER], gate, precision="bf16", **kw)
    _close(out[:5], ref[:5])
    if active is not None:
        eff = out[5].numpy()
        np.testing.assert_array_equal(eff, np.asarray(ref[5]))
        assert np.all(eff[~active] == 0) and len(set(eff[active])) > 1
    args = [_t(arrs[k]) for k in ORDER]
    for i, name in enumerate(ORDER):
        if name in OPS:
            args[i] = args[i].to(torch.bfloat16)
    before = dict(admm_kernel.LAUNCHES)
    again = admm_kernel.fused_solve_lanes(*args, gate, precision="bf16", **kw)
    assert admm_kernel.LAUNCHES == before
    for a, b in zip(out, again):
        assert torch.equal(a, b)
    # And the rounding is real: float32 storage gives another result.
    f32 = admm_kernel.fused_solve_lanes_reference(
        *[_t(arrs[k]) for k in ORDER], gate, **kw)
    assert float((f32[0] - out[0]).abs().max()) > 0.0


def _fused_problems():
    """The JAX package's tests/test_fused_solve.py problems, batched."""
    return [_t(np.asarray(a)) for a in test_fused_solve._problems()]


def test_bf16_solve_close_to_f32():
    """bf16 storage stays within bf16 mantissa distance of the float32
    solve after 30 iterations (the operators carry 8 mantissa bits; the
    iterates and the sums are float32), and differs from it."""
    P, q, A, lb, ub, shift = _fused_problems()
    kw = dict(n_box=6, soc_dims=(4,), iters=30, shift=shift)
    f32 = socp.solve_socp(P, q, A, lb, ub, **kw)
    bf16 = socp.solve_socp(P, q, A, lb, ub, precision="bf16", **kw)
    np.testing.assert_allclose(bf16.x.numpy(), f32.x.numpy(), rtol=0,
                               atol=3e-2)
    assert float((bf16.x - f32.x).abs().max()) > 0.0


@pytest.mark.parametrize("tol_path", [False, True], ids=["fixed", "tol"])
def test_bf16_inert_on_pallas_route(tol_path):
    """On route "pallas" bf16 is inert, as in the JAX package: the solve is
    the float32 one bit for bit."""
    P, q, A, lb, ub, shift = _fused_problems()
    kw = dict(n_box=6, soc_dims=(4,), iters=30, shift=shift, fused="pallas")
    if tol_path:
        kw.update(check_every=7, tol=1e-3)
    f32 = socp.solve_socp(P, q, A, lb, ub, **kw)
    bf16 = socp.solve_socp(P, q, A, lb, ub, precision="bf16", **kw)
    for a, b in zip(f32, bf16):
        assert torch.equal(a, b)


def test_bf16_operand_checks(monkeypatch):
    """A mix of operator dtypes, an unknown precision and bfloat16
    operators under "f32" raise; solve_socp builds no KKT operator from
    rounded matrices; ``resolve_precision`` reads TPU_AERIAL_PRECISION
    for "auto" (else f32) and refuses junk."""
    arrs = {k: _t(v) for k, v in _problems(2, *DIMS["cadmm"]).items()}
    args = [arrs[k] for k in ORDER]
    kw = dict(nv=16, n_box=24, soc_dims=(4, 4), iters=2, alpha=1.6)
    mixed = list(args)
    mixed[ORDER.index("K2")] = mixed[ORDER.index("K2")].to(torch.bfloat16)
    with pytest.raises(TypeError, match="one dtype"):
        admm_kernel.fused_solve_lanes(*mixed, precision="bf16", **kw)
    stored = [a.to(torch.bfloat16) if n in OPS else a
              for n, a in zip(ORDER, args)]
    with pytest.raises(TypeError, match="precision='f32'"):
        admm_kernel.fused_solve_lanes(*stored, **kw)
    with pytest.raises(ValueError, match="precision"):
        admm_kernel.fused_solve_lanes(*args, precision="fp8", **kw)
    with pytest.raises(ValueError, match="float32 P and A"):
        socp.solve_socp(arrs["P"].to(torch.bfloat16), arrs["q"],
                        arrs["A"].to(torch.bfloat16), arrs["lb"], arrs["ub"],
                        n_box=24, soc_dims=(4, 4), precision="bf16")
    monkeypatch.delenv("TPU_AERIAL_PRECISION", raising=False)
    assert socp.resolve_precision("auto") == "f32"
    assert socp.resolve_precision(None) == "f32"
    monkeypatch.setenv("TPU_AERIAL_PRECISION", "bf16")
    assert socp.resolve_precision("auto") == "bf16"
    assert socp.resolve_precision("f32") == "f32"
    monkeypatch.setenv("TPU_AERIAL_PRECISION", "fp8")
    with pytest.raises(ValueError, match="TPU_AERIAL_PRECISION"):
        socp.resolve_precision("auto")


@pytest.mark.parametrize("route", ["kernel", "pallas"])
def test_controller_rounds_once_per_step(route, monkeypatch):
    """A bf16 C-ADMM step hands every solve operators already rounded
    (rounded once per control step, not per consensus iteration) on route
    "kernel", and float32 ones on route "pallas"."""
    seen = []
    solve = socp.solve_socp

    def spy(P, q, A, *a, op=None, precision="f32", **kw):
        seen.append((op.K2.dtype, op.Minv.dtype, A.dtype, P.dtype,
                     precision))
        return solve(P, q, A, *a, op=op, precision=precision, **kw)

    monkeypatch.setattr(socp, "solve_socp", spy)
    rounds = []
    store = admm_kernel.store_operators
    monkeypatch.setattr(admm_kernel, "store_operators",
                        lambda ops, p: rounds.append(p) or store(ops, p))
    step, cs0, st0 = rollout.make_mpc_step(
        "cadmm", 4, max_iter=3, socp_fused=route, socp_precision="bf16",
        device="cpu")
    _, _, stats = step(rollout.stack_scenarios(cs0, 2),
                       rollout.stack_scenarios(st0, 2))
    assert len(seen) == int(stats.iters.max()) > 1
    want = torch.bfloat16 if route == "kernel" else torch.float32
    for dtypes in seen:
        assert dtypes[:4] == (want,) * 4 and dtypes[4] == "bf16"
    # One rounding a control step on route "kernel" (the later calls see
    # bfloat16 operators and round nothing); none on "pallas".
    assert len(rounds) == (1 + len(seen) if route == "kernel" else 0)


def _bench_pair(controller, n, S):
    """One bf16 MPC step of S seeded scenarios: the JAX bench's step
    (``kernel_interpret``) vmapped, and the port's on the CPU."""
    jstep, jcs0, jstate0 = bench.make_mpc_step(
        controller, n, socp_fused="kernel_interpret", socp_precision="bf16")
    jstates = bench._scenario_batch(jstate0, S)
    jcss = jax.vmap(lambda _: jcs0)(jnp.arange(S))
    ref = jax.jit(jax.vmap(jstep))(jcss, jstates)
    step, cs0, state0 = rollout.make_mpc_step(
        controller, n, socp_precision="bf16", device="cpu")
    out = step(rollout.stack_scenarios(cs0, S),
               rollout.scenario_batch(state0, S))
    return ref, out


@pytest.mark.parametrize("controller", ["cadmm", "dd"])
def test_bf16_control_step_matches_jax_kernel(controller):
    """A bf16 C-ADMM (n = 8) and DD (n = 8) step of 2 scenarios against the
    JAX bench's step through the interpreted kernel with
    ``socp_precision="bf16"``: equal iteration counts, states to 1e-4,
    forces to 1e-4 N (C-ADMM) or 2e-3 N (DD)."""
    (jcss, jstates, jst), (css, states, st) = _bench_pair(controller, 8, 2)
    np.testing.assert_array_equal(st.iters.numpy(), np.asarray(jst.iters))
    for f in ("xl", "vl", "Rl", "wl", "R", "w"):
        np.testing.assert_allclose(getattr(states, f).numpy(),
                                   np.asarray(getattr(jstates, f)),
                                   atol=1e-4, rtol=0, err_msg=f)
    bar = 1e-4 if controller == "cadmm" else 2e-3
    np.testing.assert_allclose(css.f.numpy(), np.asarray(jcss.f), atol=bar,
                               rtol=0)
    np.testing.assert_allclose(st.solve_res.numpy(),
                               np.asarray(jst.solve_res), atol=bar, rtol=0)


def test_bf16_config_resolves_for_both_controllers():
    """``socp_precision`` resolves at config build for C-ADMM and for DD's
    shared base, and a config left at "auto" stays float32."""
    params, col, _ = setup.rqp_setup(8, device="cpu")
    cfg = cadmm.make_config(params, col.collision_radius,
                            col.max_deceleration, socp_precision="bf16",
                            device="cpu")
    assert cfg.socp_precision == "bf16"
    base = dd.make_config(params, col.collision_radius, col.max_deceleration,
                          socp_precision="bf16", device="cpu").base
    assert base.socp_precision == "bf16"
    auto = cadmm.make_config(params, col.collision_radius,
                             col.max_deceleration, device="cpu")
    assert auto.socp_precision in socp.PRECISIONS
