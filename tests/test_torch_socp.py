"""PyTorch port vs the JAX package: the whole-solve ADMM kernel's plain
PyTorch version, the operator builders, and the batched fixed-iteration
solve.

The JAX side of the kernel comparison runs the Pallas kernel the way the JAX
package's own tests run it on the CPU: under the interpreter in its compiled
form (``fused_solve_lanes(interpret=True, exact_dot=False)``). Tolerance:
atol 1e-4 after 30 iterations, the JAX package's own bar for that form
against the exact one (tests/test_fused_solve.py): both sides are float32,
but the per-lane matvecs sum in another order, and the equality rows'
1e3-boosted penalties amplify that rounding over the iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.ops import admm_kernel as jkernel
from tpu_aerial_transport.ops import socp as jsocp
from tpu_aerial_transport_torch.ops import admm_kernel, socp


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _problems(B, nv, n_box, soc, seed=0, n_eq=3, p_scale=1.0):
    """Seeded PSD problems in the style of tests/test_fused_solve.py, with
    ``n_eq`` equality rows (lb == ub) so the boosted penalty is exercised."""
    rng = np.random.default_rng(seed)
    m = n_box + sum(soc)
    L = rng.standard_normal((B, nv, nv))
    P = p_scale * (L @ np.swapaxes(L, -1, -2)) + np.eye(nv)
    q = rng.standard_normal((B, nv))
    A = rng.standard_normal((B, m, nv)) * 0.5
    lb = rng.uniform(-2.0, -0.5, (B, n_box))
    ub = rng.uniform(0.5, 2.0, (B, n_box))
    lb[:, :n_eq] = ub[:, :n_eq] = rng.uniform(-0.5, 0.5, (B, n_eq))
    shift = np.zeros((B, m))
    off = n_box
    for k in soc:
        shift[:, off] = 3.0
        off += k
    f = lambda a: a.astype(np.float32)  # noqa: E731
    return f(P), f(q), f(A), f(lb), f(ub), f(shift)


# (nv, n_box, soc): the padded C-ADMM headline dims (d = 48) and the
# unpadded ones (nv = 12, m = 25, n_box = 17).
DIMS = {"padded": (16, 24, (4, 4)), "unpadded": (12, 17, (4, 4))}


def _kernel_inputs(dims, with_shift, B=6):
    nv, n_box, soc = dims
    P, q, A, lb, ub, shift = _problems(B, nv, n_box, soc)
    m = n_box + sum(soc)
    rho = np.asarray(jax.vmap(
        lambda l_, u_: jsocp.make_rho_vec(m, n_box, l_, u_, 0.4))(lb, ub))
    op = jax.vmap(jsocp.kkt_operator)(jnp.asarray(P), jnp.asarray(A),
                                      jnp.asarray(rho))
    s = shift if with_shift else None
    z0 = np.asarray(jax.vmap(lambda l_, u_, s_: jsocp._project_cone(
        jnp.zeros(m), l_, u_, n_box, soc, s_ if with_shift else None))(
            lb, ub, shift))
    rng = np.random.default_rng(1)
    x0 = (0.1 * rng.standard_normal((B, nv))).astype(np.float32)
    y0 = (0.1 * rng.standard_normal((B, m))).astype(np.float32)
    return dict(x=x0, y=y0, z=z0, K2=np.asarray(op.K2),
                Minv=np.asarray(op.Minv), A=A, P=P, q=q, rho=rho, lb=lb,
                ub=ub, shift=s), dict(nv=nv, n_box=n_box, soc_dims=soc)


@pytest.mark.parametrize("with_shift", [True, False],
                         ids=["shift", "no_shift"])
@pytest.mark.parametrize("dims", list(DIMS), ids=list(DIMS))
def test_reference_matches_pallas_compiled_form(dims, with_shift):
    arrs, statics = _kernel_inputs(DIMS[dims], with_shift)
    order = ["x", "y", "z", "K2", "Minv", "A", "P", "q", "rho", "lb", "ub",
             "shift"]
    kw = dict(statics, iters=30, alpha=1.6)
    ref = jkernel.fused_solve_lanes(
        *[None if arrs[k] is None else jnp.asarray(arrs[k]) for k in order],
        interpret=True, exact_dot=False, **kw,
    )
    out = admm_kernel.fused_solve_lanes_reference(
        *[None if arrs[k] is None else _t(arrs[k]) for k in order], **kw,
    )
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-4)
    # The dispatching wrapper takes the plain version for CPU tensors and
    # does not count a kernel launch.
    before = admm_kernel.LAUNCHES["fused_solve"]
    again = admm_kernel.fused_solve_lanes(
        *[None if arrs[k] is None else _t(arrs[k]) for k in order], **kw,
    )
    assert admm_kernel.LAUNCHES["fused_solve"] == before
    for a, b in zip(out, again):
        assert torch.equal(a, b)


def test_project_cone_and_soc_edge_cases():
    """Inside / polar / outside regimes and the nrm = 0 guard."""
    z = np.array([
        [0.3, -0.2, 0.5, 0.1, 0.2, 0.0, 0.0, 0.0],  # t=0.2, v=0: inside.
        [0.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0],  # v=0, t<0: polar.
        [2.0, 3.0, -3.0, 0.0, 0.5, 1.0, 2.0, 0.0],  # outside: shrink.
        [0.0, 0.0, 0.0, 0.0, -5.0, 1.0, 1.0, 1.0],  # polar.
        [9.0, -9.0, 0.1, 0.0, 4.0, 1.0, 1.0, 1.0],  # inside; box clipped.
    ], np.float32)
    lb = np.full((5, 4), -1.0, np.float32)
    ub = np.full((5, 4), 1.0, np.float32)
    shift = np.zeros((5, 8), np.float32)
    shift[:, 4] = 0.5
    for s in (None, shift):
        ref = jsocp._project_cone(jnp.asarray(z), jnp.asarray(lb),
                                  jnp.asarray(ub), 4, (4,),
                                  None if s is None else jnp.asarray(s))
        out = socp._project_cone(_t(z), _t(lb), _t(ub), 4, (4,),
                                 None if s is None else _t(s))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7,
                                   rtol=0)


def test_operator_builders_match():
    """pad_qp (exact: zeros, ones and +-INF), make_rho_vec (exact),
    equilibrate_rows (row norms: reduction order, rtol 1e-6) and
    kkt_operator (a float32 inverse of a matrix with 1e3-boosted equality
    penalties: condition ~1e4, so the inverses agree to ~1e-4 relative)."""
    nv, n_box, soc = 12, 17, (4, 4)
    P, q, A, lb, ub, shift = _problems(5, nv, n_box, soc, seed=3)
    padded = jax.vmap(lambda *a: jsocp.pad_qp(*a, n_box=n_box, soc_dims=soc))(
        P, q, A, lb, ub, shift)
    out = socp.pad_qp(*map(_t, (P, q, A, lb, ub, shift)), n_box=n_box,
                      soc_dims=soc)
    for a, b in zip(padded, out):
        assert np.array_equal(b.numpy(), np.asarray(a))
    ref = jax.vmap(lambda *a: jsocp.equilibrate_rows(*a, n_box, soc))(
        A, lb, ub, shift)
    got = socp.equilibrate_rows(_t(A), _t(lb), _t(ub), _t(shift), n_box, soc)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    Pp, _, Ap, lbp, ubp, _ = (np.asarray(a) for a in padded)
    m_p = Ap.shape[-2]
    n_box_p = lbp.shape[-1]
    rho_ref = jax.vmap(lambda l_, u_: jsocp.make_rho_vec(
        m_p, n_box_p, l_, u_, 0.4))(lbp, ubp)
    rho = socp.make_rho_vec(m_p, n_box_p, _t(lbp), _t(ubp), 0.4)
    assert np.array_equal(rho.numpy(), np.asarray(rho_ref))
    op_ref = jsocp.kkt_operator(jnp.asarray(Pp), jnp.asarray(Ap), rho_ref)
    op = socp.kkt_operator(_t(Pp), _t(Ap), rho)
    for name in ("Minv", "MinvAT", "K2"):
        a, b = np.asarray(getattr(op_ref, name)), getattr(op, name).numpy()
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * np.abs(a).max())


def _solve_pair(P, q, A, lb, ub, shift, kw, op=None, warm=None):
    """The JAX scan path vmapped over the batch, and the port's batched
    solve, on the same inputs (``op``/``warm`` from the JAX side)."""
    def one(P_, q_, A_, l_, u_, s_, o_, w_):
        return jsocp.solve_socp(P_, q_, A_, l_, u_, shift=s_, op=o_, warm=w_,
                                fused="scan", **kw)

    ref = jax.vmap(one)(P, q, A, lb, ub, shift, op, warm)
    conv = lambda t: None if t is None else type(t)(  # noqa: E731
        *(_t(np.asarray(a)) for a in t))
    out = socp.solve_socp(*map(_t, (P, q, A, lb, ub)), shift=_t(shift),
                          op=conv(op), warm=conv(warm), **kw)
    return ref, out


def _assert_solutions(ref, out, atol):
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=atol)
    fin = socp.solution_is_finite(out)
    assert fin.shape == out.prim_res.shape and bool(fin.all())


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_solve_socp_matches_scan_path(warm):
    """Batched solve_socp with the JAX-built operator (equality rows with
    boosted penalties included), cold and warm started: the same bar as the
    kernel comparison, atol 1e-4."""
    nv, n_box, soc = 12, 17, (4, 4)
    P, q, A, lb, ub, shift = _problems(6, nv, n_box, soc, seed=5)
    m = n_box + sum(soc)
    kw = dict(n_box=n_box, soc_dims=soc, iters=25)
    rho = jax.vmap(lambda l_, u_: jsocp.make_rho_vec(m, n_box, l_, u_, 0.4))(
        lb, ub)
    op = jax.vmap(jsocp.kkt_operator)(jnp.asarray(P), jnp.asarray(A), rho)
    ref, out = _solve_pair(P, q, A, lb, ub, shift, kw, op=op)
    if warm:
        ref, out = _solve_pair(P, q + 0.1, A, lb, ub, shift, kw, op=op,
                               warm=ref)
    _assert_solutions(ref, out, 1e-4)


def test_solve_socp_builds_its_operator():
    """solve_socp building the KKT operator itself. Without boosted
    equality rows the float32 inverses of the two frameworks agree to a few
    ulps, so the solves meet the same atol 1e-4 bar."""
    nv, n_box, soc = 12, 17, (4, 4)
    P, q, A, lb, ub, shift = _problems(6, nv, n_box, soc, seed=6, n_eq=0,
                                       p_scale=1.0 / nv)
    kw = dict(n_box=n_box, soc_dims=soc, iters=25)
    _assert_solutions(*_solve_pair(P, q, A, lb, ub, shift, kw), 1e-4)


def _central_shape(n):
    """(nv, n_box, soc) of the centralized QP at n agents (the JAX package's
    qp_dims with 10 environment rows): n = 16 is d = 223 with 32 SOC
    blocks, n = 64 d = 799 with 128."""
    return 9 + 3 * n, 12 + n + 10, (4,) * (2 * n)


def _scan_pair(n, B, kw, seed, warm=False):
    """The JAX package's scan route (vmapped) and the port's solve on the
    same seeded problems and JAX-built operator at the centralized n-agent
    shape, cold started or (``warm``) warm started from the JAX cold
    solution with a moved q. The port runs through "auto", which its
    resolver sends to "scan" at this shape, through "scan" itself, and
    through "scan" in float64 (the yardstick of its float32 rounding)."""
    nv, n_box, soc = _central_shape(n)
    P, q, A, lb, ub, shift = _problems(B, nv, n_box, soc, seed=seed,
                                       p_scale=1.0 / nv)
    m = n_box + sum(soc)
    assert socp.runtime_fused_mode("auto", nv, m, n_box, soc) == "scan"
    rho = jax.vmap(lambda l_, u_: jsocp.make_rho_vec(m, n_box, l_, u_, 0.4))(
        lb, ub)
    op = jax.vmap(jsocp.kkt_operator)(jnp.asarray(P), jnp.asarray(A), rho)
    kw = dict(kw, n_box=n_box, soc_dims=soc)
    start = None
    if warm:
        start, _ = _solve_pair(P, q, A, lb, ub, shift,
                               dict(n_box=n_box, soc_dims=soc, iters=30),
                               op=op)
        q = q + 0.1

    def conv(t, dtype=torch.float32):
        return None if t is None else type(t)(
            *(_t(np.asarray(a)).to(dtype) for a in t))

    ref, auto = _solve_pair(P, q, A, lb, ub, shift, kw, op=op, warm=start)
    scan = socp.solve_socp(*map(_t, (P, q, A, lb, ub)), shift=_t(shift),
                           op=conv(op), warm=conv(start), fused="scan", **kw)
    f64 = torch.float64
    scan64 = socp.solve_socp(
        *(_t(a).to(f64) for a in (P, q, A, lb, ub)), shift=_t(shift).to(f64),
        op=conv(op, f64), warm=conv(start, f64), fused="scan", **kw)
    return ref, (auto, scan, scan64)


def _close(ref, out, out64):
    """The smoke's kernel bar, per output: 1e-4 x max(1, |ref|), or twice
    the port's own float32 rounding (its distance from the same solve in
    float64) where that is larger. The duals of the three equality rows
    move by rho = 400 times the rounding of A x, which the two frameworks'
    sums round apart (chip_smoke.py ROUNDING_FACTOR)."""
    for a, b, c in zip(ref, out, out64):
        a = np.asarray(a)
        noise = float((b.double() - c).abs().max())
        bar = max(1e-4 * max(1.0, float(np.abs(a).max())), 2.0 * noise)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=bar)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("form", ["fixed", "chunked"])
def test_scan_route_matches_jax_at_centralized_n16(form, warm):
    """Route "scan" against the JAX package's ``fused="scan"`` at the
    centralized n = 16 shape (d = 223, 32 SOC blocks: no kernel holds it),
    fixed-iteration and tolerance-chunked (with the effective iterations
    each lane ran, equal in both packages and in float64), cold and warm
    started, within the kernel bar (:func:`_close`). The port's "auto" and
    "scan" give the same bits at this shape."""
    kw = dict(iters=40)
    if form == "chunked":
        kw.update(check_every=10, tol=2e-2, report_iters=True)
    ref, (auto, scan, scan64) = _scan_pair(16, 3, kw, seed=11, warm=warm)
    if form == "chunked":
        (ref, ref_eff), (auto, eff), (scan, eff_s), (scan64, eff64) = (
            ref, auto, scan, scan64)
        assert eff.tolist() == np.asarray(ref_eff).tolist()
        assert torch.equal(eff, eff_s) and torch.equal(eff, eff64)
    _close(ref, auto, scan64)
    for a, b in zip(auto, scan):
        assert torch.equal(a, b)


def test_scan_route_matches_jax_at_centralized_n64():
    """One lane at the centralized n = 64 shape (d = 799, 128 SOC blocks),
    a few iterations of route "scan" against the JAX package's."""
    ref, (auto, _, auto64) = _scan_pair(64, 1, dict(iters=4), seed=12)
    _close(ref, auto, auto64)
