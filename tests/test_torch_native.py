"""The port's float64 oracle (``tpu_aerial_transport_torch.native``) against
the JAX package's (``tpu_aerial_transport.native``) on the problems of
tests/test_native_solver.py: both compile the same solver with the same
flags on this host, so their results must be bitwise equal. Then the port's
``ops.socp.solve_socp`` on every route against the port's own oracle, and
the build's failure modes: a missing compiler or a failed build raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport import native as jax_native
from tpu_aerial_transport.ops import socp as jax_socp
from tpu_aerial_transport_torch import native
from tpu_aerial_transport_torch.ops import socp

# Both oracles are built with g++: without it there is nothing to compare
# (test_missing_compiler_raises holds the port's build to raising then).
needs_gxx = pytest.mark.skipif(
    not jax_native.available(),
    reason="no C++ compiler (g++) on this host: neither oracle builds")


def _random_qp(seed, nv=8, n_eq=3, n_ineq=6):
    """tests/test_native_solver.py's random QP, drawn with jax.random."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    L = jax.random.normal(ks[0], (nv, nv)) * 0.5
    P = L @ L.T + 0.5 * jnp.eye(nv)
    q = jax.random.normal(ks[1], (nv,))
    A_eq = jax.random.normal(ks[2], (n_eq, nv))
    b_eq = jax.random.normal(ks[3], (n_eq,)) * 0.3
    A_in = jax.random.normal(ks[4], (n_ineq, nv))
    A = jnp.concatenate([A_eq, A_in], axis=0)
    lb = jnp.concatenate([b_eq, jnp.full((n_ineq,), -jax_socp.INF)])
    ub = jnp.concatenate([b_eq, jnp.ones((n_ineq,))])
    return tuple(np.array(a) for a in (P, q, A, lb, ub))


def _soc_projection():
    p = np.array([0.5, 3.0, -4.0, 1.0])
    return ((2 * np.eye(4), -2.0 * p, np.eye(4), np.zeros(0), np.zeros(0)),
            dict(n_box=0, soc_dims=(4,), iters=800))


def _shifted_cone():
    p = np.array([2.0, 1.0, -2.0])
    A = np.concatenate([np.zeros((1, 3)), np.eye(3)], axis=0)
    return ((2 * np.eye(3), -2 * p, A, np.zeros(0), np.zeros(0)),
            dict(n_box=0, soc_dims=(4,), iters=800,
                 shift=np.array([1.0, 0.0, 0.0, 0.0])))


def _bitwise(a, b):
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y)), (x, y)


PROBLEMS = {
    **{f"qp{s}": (lambda s=s: (_random_qp(s), dict(n_box=9, iters=800)))
       for s in range(4)},
    "soc_projection": _soc_projection,
    "shifted_cone": _shifted_cone,
}


@needs_gxx
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_oracle_bitwise_equals_jax_native(name):
    args, kw = PROBLEMS[name]()
    got = native.solve_socp_native(*args, **kw)
    ref = jax_native.solve_socp_native(*args, **kw)
    _bitwise(got, ref)
    assert got[3] < 1e-6  # prim: the f64 oracle converges.


@needs_gxx
def test_oracle_batch_bitwise_equals_jax_native():
    qps = [_random_qp(seed + 50) for seed in range(6)]
    stacked = [np.stack(a) for a in zip(*qps)]
    got = native.solve_socp_native_batch(*stacked, n_box=9, iters=600)
    ref = jax_native.solve_socp_native_batch(*stacked, n_box=9, iters=600)
    _bitwise(got, ref)
    assert got[0].shape == (6, 8) and got[1][:, 0].max() < 1e-5
    # The same problems as CPU tensors give the same bits.
    tensors = [torch.as_tensor(a) for a in stacked]
    _bitwise(native.solve_socp_native_batch(*tensors, n_box=9, iters=600),
             got)


@needs_gxx
def test_oracle_warm_start_fixed_point_bitwise():
    args = _random_qp(11)
    x, y, z, _, _ = native.solve_socp_native(*args, n_box=9, iters=800)
    got = native.solve_socp_native(*args, n_box=9, iters=5, warm=(x, y, z))
    ref = jax_native.solve_socp_native(*args, n_box=9, iters=5,
                                       warm=(x, y, z))
    _bitwise(got, ref)
    assert np.abs(got[0] - x).max() < 1e-6


@needs_gxx
@pytest.mark.parametrize("route", socp.ROUTES)
@pytest.mark.parametrize("seed", range(4))
def test_port_solve_within_oracle(seed, route):
    """The port's float32 solve on each route against its own float64
    oracle, with tests/test_native_solver.py's bars."""
    P, q, A, lb, ub = _random_qp(seed)
    x, _, _, prim, _ = native.solve_socp_native(P, q, A, lb, ub, n_box=9,
                                                iters=800)
    got = socp.solve_socp(
        *(torch.as_tensor(a, dtype=torch.float32)[None]
          for a in (P, q, A, lb, ub)),
        n_box=9, iters=800, fused=route)
    assert prim < 1e-6
    assert np.abs(got.x[0].numpy() - x).max() < 5e-3


def _fresh_build(monkeypatch, tmp_path):
    """The module with no library loaded and an empty build directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "build_dir", lambda: str(tmp_path))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    assert not native.available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.solve_socp_native(*_random_qp(0), n_box=9)


@needs_gxx
def test_failed_build_raises_with_stderr(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    bad = tmp_path / "broken.cpp"
    bad.write_text("int socp_solve( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="failed .*\n.*error"):
        native.build()
    assert not list(tmp_path.glob("*.so")) and not list(
        tmp_path.glob("*.tmp"))


@needs_gxx
def test_library_name_keys_on_source_and_flags(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    base = native.library_path()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != base
    built = native.build()
    assert built == native.library_path() and built.endswith(".so")
    # A second build finds the library and compiles nothing.
    mtime = (tmp_path / built.rsplit("/", 1)[-1]).stat().st_mtime_ns
    assert native.build() == built
    assert (tmp_path / built.rsplit("/", 1)[-1]).stat().st_mtime_ns == mtime
