"""PyTorch port vs the JAX package: the consensus-exchange seam
(``parallel/ring.py``) and the ring-sum kernel's plain version.

The JAX package runs each shard as its own program under ``shard_map`` on
the virtual 8-device CPU mesh (conftest.py); the port takes the same
payloads stacked on a leading shard axis, row r being shard r's.

Tolerances, and why:

- Max, min and gathers move values without arithmetic: bitwise equal.
- Sums: ``"ring"`` makes the JAX ring's float32 adds in the JAX ring's
  order, so it is bitwise equal to it; ``"allreduce"`` adds in whatever
  order each framework's reduction takes, so it is held within 1e-6 x
  max(1, |ref|), float32 rounding of a sum of four unit-normal values. On
  payloads spread over many decades the two orders round apart, which
  tells the impls apart.
- The kernel's plain version adds in the TPU kernel's order: bitwise equal
  to a numpy float32 loop in that order, within 1e-6 x max(1, |ref|) of
  the float64 sum, and within 1e-5 of JAX's ``"ring"`` (JAX runs
  ``"pallas_ring"`` as ``"ring"`` off the TPU; the bar of
  ``tests/test_ring.py:111``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_aerial_transport.parallel import mesh as jmesh
from tpu_aerial_transport.parallel import ring as jring
from tpu_aerial_transport.utils import compat
from tpu_aerial_transport_torch.control import cadmm, dd
from tpu_aerial_transport_torch.harness import setup
from tpu_aerial_transport_torch.parallel import ring

D = 4  # ring size of the raw-exchange tests (4 of the 8 virtual devices).

# Per-shard payload shapes: 18 floats (not divisible by the ring), a
# scalar, and a controller-shaped (S, n, 3) payload.
PAYLOADS = {"p18": (18,), "scalar": (), "controller": (3, 8, 3)}


def _payload(shape, seed=0, d=D):
    return np.random.default_rng(seed).standard_normal(
        (d,) + shape).astype(np.float32)


def _shmap(fn, mesh):
    return functools.partial(
        compat.shard_map, mesh=mesh, in_specs=P("agent"),
        out_specs=P("agent"), check_vma=False,
    )(fn)


def _jax_exchange(x, op, impl, d=D):
    m = jmesh.make_mesh({"agent": d})

    @functools.partial(_shmap, mesh=m)
    def step(v):
        return jring.consensus_exchange(
            v[0], "agent", axis_size=d, op=op, impl=impl)[None]

    return np.asarray(jax.jit(step)(jnp.asarray(x)))


def _jax_gather(x, impl, d=D):
    m = jmesh.make_mesh({"agent": d})

    @functools.partial(_shmap, mesh=m)
    def step(v):
        return jring.consensus_gather(
            v[0], "agent", axis_size=d, impl=impl)[None]

    return np.asarray(jax.jit(step)(jnp.asarray(x)))


# ----------------------------- resolution gate -------------------------


def test_resolve_auto(monkeypatch):
    """"auto" is "allreduce" on the CPU (as in the JAX package) and "ring"
    on the card (the JAX package's rule for a non-CPU backend)."""
    monkeypatch.delenv(ring.ENV_VAR, raising=False)
    assert ring.resolve_consensus("auto", "cpu") == "allreduce"
    assert ring.resolve_consensus(None, "cpu") == "allreduce"
    assert jring.resolve_consensus("auto") == "allreduce"
    assert ring.resolve_consensus("auto", "cuda") == "ring"
    assert ring.IMPLS == jring.IMPLS and ring.ENV_VAR == jring.ENV_VAR


def test_resolve_env_force_and_validation(monkeypatch):
    """The env var forces "auto"; an explicit impl wins over it; bad values
    raise with the JAX package's messages."""
    for impl in ring.IMPLS:
        monkeypatch.setenv(ring.ENV_VAR, impl)
        assert ring.resolve_consensus("auto", "cpu") == impl
        assert ring.resolve_consensus("auto", "cuda") == impl
    monkeypatch.setenv(ring.ENV_VAR, "ring")
    assert ring.resolve_consensus("allreduce", "cpu") == "allreduce"
    assert ring.resolve_consensus("pallas_ring", "cpu") == "pallas_ring"
    for env, impl in (("bogus", "auto"), ("", "bogus")):
        monkeypatch.setenv(ring.ENV_VAR, env)
        with pytest.raises(ValueError) as ours:
            ring.resolve_consensus(impl, "cpu")
        with pytest.raises(ValueError) as theirs:
            jring.resolve_consensus(impl)
        assert str(ours.value) == str(theirs.value)
        assert ("TPU_AERIAL_CONSENSUS" if env else "consensus_impl") in str(
            ours.value)


def test_make_config_resolves_at_build_time(monkeypatch):
    monkeypatch.delenv(ring.ENV_VAR, raising=False)
    params, col, _ = setup.rqp_setup(4, device="cpu")
    args = (params, col.collision_radius, col.max_deceleration)
    assert cadmm.make_config(*args, device="cpu").consensus_impl == "allreduce"
    monkeypatch.setenv(ring.ENV_VAR, "ring")
    assert cadmm.make_config(*args, device="cpu").consensus_impl == "ring"
    assert dd.make_config(*args, device="cpu").base.consensus_impl == "ring"
    assert cadmm.make_config(*args, consensus_impl="pallas_ring",
                             device="cpu").consensus_impl == "pallas_ring"
    with pytest.raises(ValueError, match="consensus_impl"):
        dd.make_config(*args, consensus_impl="tree", device="cpu")


# ----------------------------- raw exchange ----------------------------


@pytest.mark.parametrize("impl", ["allreduce", "ring"])
@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("payload", list(PAYLOADS))
def test_exchange_matches_jax(payload, op, impl):
    """The port's impl against the JAX package's same impl on the virtual
    mesh: the all-reduce sum to float32 rounding; the ring sum, max and
    min bitwise; the ring sum bitwise identical on every shard."""
    x = _payload(PAYLOADS[payload])
    ref = _jax_exchange(x, op, impl)
    out = ring.consensus_exchange(torch.as_tensor(x), axis_size=D, op=op,
                                  impl=impl).numpy()
    assert out.shape == ref.shape == x.shape
    if op == "sum" and impl == "allreduce":
        np.testing.assert_allclose(
            out, ref, rtol=0, atol=1e-6 * max(1.0, np.abs(ref).max()))
    else:
        np.testing.assert_array_equal(out, ref)
    if op == "sum" and impl == "ring":
        assert (out == out[:1]).all()


@pytest.mark.parametrize("d", [4, 8])
@pytest.mark.parametrize("payload", ["p18", "controller"])
def test_ring_sum_is_the_jax_ring_order(payload, d):
    """On a payload spread over nine decades the summation order shows in
    the last bits: the port's ``"ring"`` sum is bitwise the JAX ring's and
    not the all-reduce's, so the exchange tests tell the impls apart."""
    rng = np.random.default_rng(5)
    shape = (d,) + PAYLOADS[payload]
    x = (rng.standard_normal(shape)
         * 10.0 ** rng.integers(-4, 5, shape)).astype(np.float32)
    jax_ring = _jax_exchange(x, "sum", "ring", d=d)
    out = {impl: ring.consensus_exchange(torch.as_tensor(x), axis_size=d,
                                         op="sum", impl=impl).numpy()
           for impl in ("ring", "allreduce")}
    np.testing.assert_array_equal(out["ring"], jax_ring)
    assert not np.array_equal(out["allreduce"], out["ring"])
    assert not np.array_equal(_jax_exchange(x, "sum", "allreduce", d=d),
                              jax_ring)


@pytest.mark.parametrize("impl", ["allreduce", "ring"])
@pytest.mark.parametrize("payload", ["p18", "controller"])
def test_gather_matches_jax(payload, impl):
    """Gathers are bitwise equal to the JAX package's, shard-ordered and
    the same on every shard; "pallas_ring" gathers take the ring path."""
    x = _payload(PAYLOADS[payload], seed=1)
    ref = _jax_gather(x, impl)
    out = ring.consensus_gather(torch.as_tensor(x), axis_size=D,
                                impl=impl).numpy()
    assert out.shape == (D,) + x.shape == ref.shape
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, np.broadcast_to(x, out.shape))
    pallas = ring.consensus_gather(torch.as_tensor(x), axis_size=D,
                                   impl="pallas_ring").numpy()
    np.testing.assert_array_equal(pallas, ref)


@pytest.mark.parametrize("impl", ring.IMPLS)
def test_axis_size_one_is_identity(impl):
    x = torch.tensor([[1.0, 2.0, 3.0]])
    for op in ring.OPS:
        out = ring.consensus_exchange(x, axis_size=1, op=op, impl=impl)
        assert torch.equal(out, x)
    assert torch.equal(ring.consensus_gather(x, axis_size=1, impl=impl),
                       x[None])


def test_exchange_rejects_bad_arguments():
    x = torch.zeros((D, 3))
    with pytest.raises(ValueError, match="op="):
        ring.consensus_exchange(x, axis_size=D, op="mean")
    with pytest.raises(ValueError, match="resolve 'auto'"):
        ring.consensus_exchange(x, axis_size=D, impl="auto")
    with pytest.raises(ValueError, match="shard axis"):
        ring.consensus_exchange(x, axis_size=D + 1)
    with pytest.raises(ValueError, match="shard axis"):
        ring.consensus_gather(x, axis_size=2, impl="ring")


# ------------------------- the kernel's plain version --------------------


def _numpy_ring_order(x):
    """Shard r's sum in the TPU kernel's order, x_r + x_{r-1} + ... +
    x_{r-d+1}, added left to right in float32."""
    d = x.shape[0]
    out = np.empty_like(x)
    for r in range(d):
        acc = x[r].copy()
        for s in range(1, d):
            acc = (acc + x[(r - s) % d]).astype(np.float32)
        out[r] = acc
    return out


@pytest.mark.parametrize("d", [2, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("P", [1, 18, 1025, 6147])
def test_ring_sum_reference_order(d, P):
    """Bitwise equal to the TPU kernel's order in numpy float32, and within
    float32 rounding of the float64 sum; d = 16 and the kernel's cap of 32
    included."""
    x = 10.0 * _payload((P,), seed=d * 7919 + P, d=d)
    out = ring.ring_sum_shards_reference(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(out, _numpy_ring_order(x))
    exact = x.astype(np.float64).sum(axis=0)
    np.testing.assert_allclose(
        out, np.broadcast_to(exact, out.shape), rtol=0,
        atol=1e-6 * max(1.0, np.abs(exact).max()))
    # The wrapper runs the plain version on a CPU tensor.
    np.testing.assert_array_equal(
        ring.ring_sum_shards(torch.as_tensor(x)).numpy(), out)


@pytest.mark.parametrize("payload", ["p18", "controller"])
def test_pallas_ring_on_cpu_is_the_plain_version(payload):
    """On a CPU tensor ``impl="pallas_ring"`` sums through the kernel's
    plain version and counts no launch; it is within 1e-5 of JAX's ring
    (JAX's "pallas_ring" off the TPU); max and min take the ring path."""
    x = _payload(PAYLOADS[payload], seed=2)
    t = torch.as_tensor(x)
    before = dict(ring.LAUNCHES)
    out = ring.consensus_exchange(t, axis_size=D, op="sum",
                                  impl="pallas_ring")
    assert ring.LAUNCHES == before
    plain = ring.ring_sum_shards_reference(t.reshape(D, -1)).reshape(t.shape)
    assert torch.equal(out, plain)
    ref = _jax_exchange(x, "sum", "ring")
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    for op in ("max", "min"):
        assert torch.equal(
            ring.consensus_exchange(t, axis_size=D, op=op,
                                    impl="pallas_ring"),
            ring.consensus_exchange(t, axis_size=D, op=op, impl="ring"))


def test_ring_sum_wrapper_checks():
    """What the wrapper refuses needs no card: another dtype, another rank,
    a non-tensor, and another device than the CPU or the card."""
    with pytest.raises(TypeError, match="float32"):
        ring.ring_sum_shards(torch.zeros((D, 5), dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        ring.ring_sum_shards(torch.zeros((D, 5, 2)))
    with pytest.raises(TypeError, match="tensor"):
        ring.ring_sum_shards(np.zeros((D, 5), np.float32))
    with pytest.raises(ValueError, match="unsupported device"):
        ring.ring_sum_shards(torch.zeros((D, 5), device="meta"))
    assert ring.ring_sum_bytes(8, 6144) == 2 * 8 * 6144 * 4
    assert ring.ring_sum_flops(8, 6144) == 7 * 8 * 6144
