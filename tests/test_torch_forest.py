"""PyTorch port vs the JAX package: the seeded forest, the collision CBF rows
and the C-ADMM per-agent vision-cone rows, including exact-contact cases and
the mirrored-trees tie order.

Tolerances, and why:

- Tree positions come from the same float64 numpy calls, rounded once to
  float32: they match exactly.
- Distances are elementwise in both packages, but XLA may fuse a multiply and
  an add into one rounding where PyTorch rounds twice: they agree to a few
  ulps (atol 1e-5). Which trees are in range, which collide, and which rows
  are selected must match exactly.
- Given the same distance sweep, the row construction agrees to atol 1e-5.
- End to end, each row also depends on the witness point: the minimizer of
  a smooth distance along the braking capsule, found by comparisons
  (grid bracket + golden section). In float32 a comparison-based minimizer
  is determined only to about sqrt(eps) of the capsule length (~3e-4 of it,
  ~1e-3 m on a 2 m capsule), so the two packages' witnesses differ by that
  much. The unit normal inherits it (atol 3e-3), and the braking time
  ``v/a - sqrt(2 (h - proj) / a)`` that divides the row amplifies it for
  rows whose closest approach lies near the capsule's far end
  (rhs rtol 3e-2, with atol 1e-5 for O(1) values).

The seeded states keep every payload beside the trees (between base and top,
outside the bark), where the distance has no flat stretch (over a cap or
inside a tree the minimizer is not unique at all); the exact-contact cases
are pinned separately.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport_torch.control import cadmm
from tpu_aerial_transport_torch.envs import forest
from tpu_aerial_transport_torch.harness import setup

KW = dict(collision_radius=0.9, max_deceleration=2.0, vision_radius=6.0,
          dist_eps=0.1, alpha_env_cbf=1.5, n_rows=4)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _forests():
    """The seed-0 forest of both packages (host-side generation, once)."""
    return jforest.make_forest(seed=0), forest.make_forest(seed=0,
                                                           device="cpu")


def _jax_rows(jf, xl, vl, **kw):
    kw = kw or KW
    return jax.jit(lambda x, v: jforest.collision_cbf_rows(jf, x, v, **kw))(
        jnp.asarray(xl, jnp.float32), jnp.asarray(vl, jnp.float32))


def _cbf_close(ref, out, atol=1e-5, witness=False):
    """Rows equal to atol 1e-5; ``witness=True`` allows for the float32
    precision of the witness point (see the module docstring)."""
    np.testing.assert_allclose(out.lhs.numpy(), np.asarray(ref.lhs),
                               atol=3e-3 if witness else atol, rtol=0)
    np.testing.assert_allclose(out.rhs.numpy(), np.asarray(ref.rhs),
                               atol=atol, rtol=3e-2 if witness else 1e-6)
    np.testing.assert_array_equal(out.collision.numpy(),
                                  np.asarray(ref.collision))
    np.testing.assert_allclose(out.min_dist.numpy(), np.asarray(ref.min_dist),
                               atol=atol, rtol=0)
    # The selection itself: which rows are active must match exactly.
    np.testing.assert_array_equal(np.abs(out.lhs.numpy()).max(-1) > 0,
                                  np.abs(np.asarray(ref.lhs)).max(-1) > 0)


def test_make_forest_seed0_matches_exactly():
    jf, tf = _forests()
    assert np.array_equal(tf.tree_pos.numpy(), np.asarray(jf.tree_pos))
    assert np.array_equal(tf.tree_valid.numpy(), np.asarray(jf.tree_valid))
    assert int(tf.num_trees) == int(jf.num_trees)
    assert float(tf.mountain_sphere_radius) == float(jf.mountain_sphere_radius)
    assert float(tf.mountain_center_depth) == float(jf.mountain_center_depth)
    assert tf.tree_pos.dtype == torch.float32


def _seeded_states(S, seed=3):
    """Payload positions scattered over the forest beside the trees (0.8 to
    3.2 m above the local ground, at least 0.5 m from every tree axis),
    every fourth at rest, the others moving mostly horizontally."""
    rng = np.random.default_rng(seed)
    trees = np.asarray(_forests()[0].tree_pos)
    sphere_r, depth = jforest._mountain_geometry()
    xl = []
    while len(xl) < S:
        xy = rng.uniform([8.0, -20.0], [50.0, 20.0])
        if np.min(np.linalg.norm(trees[:, :2] - xy, axis=1)) < 0.5:
            continue
        d2 = np.sum((xy - jforest.MOUNTAIN_CENTER) ** 2)
        ground = jforest._ground_np(sphere_r, depth, d2)
        xl.append([xy[0], xy[1], ground + rng.uniform(0.8, 3.2)])
    xl = np.array(xl)
    vl = rng.normal(size=(S, 3)) * np.array([1.5, 1.5, 0.05])
    vl[::4] = 0.0
    return xl.astype(np.float32), vl.astype(np.float32)


def _sweeps(xl, vl):
    jf, tf = _forests()

    def one(x, v):
        a, b, *_ = jforest.braking_capsule(x, v, 0.9, 2.0)
        return jforest.capsule_forest_distance(jf, a, b, 0.9, 6.0)

    ref = jax.jit(jax.vmap(one))(jnp.asarray(xl), jnp.asarray(vl))
    a, b, *_ = forest.braking_capsule(_t(xl), _t(vl), 0.9, 2.0)
    return ref, forest.capsule_forest_distance(tf, a, b, 0.9, 6.0)


def test_capsule_forest_distance_matches():
    xl, vl = _seeded_states(24)
    ref, out = _sweeps(xl, vl)
    mask = np.asarray(ref.mask)
    np.testing.assert_array_equal(out.mask.numpy(), mask)
    assert mask.sum() > 50
    np.testing.assert_allclose(out.dists.numpy()[mask],
                               np.asarray(ref.dists)[mask], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out.collision.numpy(),
                                  np.asarray(ref.collision))
    np.testing.assert_allclose(out.min_dist.numpy(), np.asarray(ref.min_dist),
                               atol=1e-5, rtol=0)
    # Witness and normal: the float32 precision of the minimizer.
    np.testing.assert_allclose(out.normal_out.numpy()[mask],
                               np.asarray(ref.normal_out)[mask], atol=3e-3,
                               rtol=0)


def test_cbf_rows_from_the_same_sweep_match():
    """Row construction and the nearest-row selection, fed the JAX sweep."""
    xl, vl = _seeded_states(24)
    ref_data, _ = _sweeps(xl, vl)
    kw = dict(KW, n_rows=10)
    del kw["collision_radius"]

    def rows(data, x, v):
        _, _, h, sp, d = jforest.braking_capsule(x, v, 0.9, 2.0)
        return jforest.cbf_rows_from_distance(data, x, v, h, sp, d, **kw)

    ref = jax.jit(jax.vmap(rows))(ref_data, jnp.asarray(xl), jnp.asarray(vl))
    data = forest.DistanceData(**{
        f: torch.as_tensor(np.array(getattr(ref_data, f)))
        for f in forest.DistanceData.__dataclass_fields__
    })
    _, _, h, sp, d = forest.braking_capsule(_t(xl), _t(vl), 0.9, 2.0)
    out = forest.cbf_rows_from_distance(data, _t(xl), _t(vl), h, sp, d, **kw)
    assert np.abs(out.lhs.numpy()).max(-1).sum() > 10  # rows are active.
    _cbf_close(ref, out)


def test_collision_cbf_rows_match_on_seeded_states():
    jf, tf = _forests()
    xl, vl = _seeded_states(24)
    kw = dict(KW, n_rows=10)
    ref = jax.jit(jax.vmap(
        lambda x, v: jforest.collision_cbf_rows(jf, x, v, **kw)))(
        jnp.asarray(xl), jnp.asarray(vl))
    out = forest.collision_cbf_rows(tf, _t(xl), _t(vl), **kw)
    assert np.abs(out.lhs.numpy()).max(-1).sum() > 10  # rows are active.
    _cbf_close(ref, out, witness=True)


@pytest.mark.parametrize("case", ["axis_surface", "top_cap"])
def test_exact_contact_normals(case):
    """Exact axis-surface and top-cap contact (tests/test_forest.py): the
    outward normal falls back to the radial / signed vertical direction and
    the protecting row stays active, in both packages alike."""
    tree = np.array([[1.0, 0.0, 2.0]])
    jf = jforest.forest_from_tree_pos(tree, 1)
    tf = forest.forest_from_tree_pos(tree, 1, device="cpu")
    if case == "axis_surface":
        xl = np.array([1.0 - jforest.BARK_RADIUS, 0.0, 2.0], np.float32)
    else:
        xl = np.array([1.1, 0.0, 4.0], np.float32)
    jd = jax.jit(lambda x: jforest.capsule_forest_distance(
        jf, x, x, 0.9, 6.0))(jnp.asarray(xl))
    td = forest.capsule_forest_distance(tf, _t(xl), _t(xl), 0.9, 6.0)
    assert np.float32(td.dists[0]) + np.float32(0.9) == np.float32(0.0)
    n0 = td.normal_out[0].numpy()
    np.testing.assert_array_equal(n0, np.asarray(jd.normal_out[0]))
    assert abs(np.linalg.norm(n0) - 1.0) < 1e-5
    if case == "axis_surface":
        assert n0[0] < -0.99
    else:
        assert n0[2] > 0.99
    ref = _jax_rows(jf, xl, np.zeros(3))
    out = forest.collision_cbf_rows(tf, _t(xl), torch.zeros(3), **KW)
    _cbf_close(ref, out)
    act = np.abs(out.lhs.numpy()).max(axis=1) > 0
    assert act.any()


@pytest.mark.parametrize("xl,vl", [
    ([0.9, 0.0, 2.0], [0.3, 0.0, 0.0]),  # axis inside the bark.
    ([0.0, 0.0, 2.0], [0.0, 0.0, 0.0]),  # at rest in shallow contact.
])
def test_penetration_rows_match(xl, vl):
    tree = np.array([[1.0, 0.0, 2.0]])
    jf = jforest.forest_from_tree_pos(tree, 1)
    tf = forest.forest_from_tree_pos(tree, 1, device="cpu")
    ref = _jax_rows(jf, xl, vl)
    out = forest.collision_cbf_rows(tf, _t(xl), _t(vl), **KW)
    _cbf_close(ref, out)
    r = int(np.argmax(np.abs(out.lhs.numpy()).max(axis=1) > 0))
    assert out.lhs[r, 0] < 0 and out.rhs[r] > 0


def test_topk_tie_order_pinned():
    """Two mirrored trees at bitwise-equal distances: the stable selection
    takes tree 0's row first, like lax.top_k (tests/test_spatial.py)."""
    trees = np.array([[33.0, 3.0, 2.0], [33.0, -3.0, 2.0]])
    jf = jforest.forest_from_tree_pos(trees, 2)
    tf = forest.forest_from_tree_pos(trees, 2, device="cpu")
    xl = np.array([33.0, 0.0, 2.0], np.float32)
    vl = np.array([1.0, 0.0, 0.0], np.float32)
    td = forest.capsule_forest_distance(tf, _t(xl), _t(xl), 0.5, 6.3)
    assert np.float32(td.dists[0]) == np.float32(td.dists[1])
    kw = dict(KW, collision_radius=0.5, vision_radius=6.3, n_rows=2)
    ref = _jax_rows(jf, xl, vl, **kw)
    out = forest.collision_cbf_rows(tf, _t(xl), _t(vl), **kw)
    np.testing.assert_array_equal(out.lhs.numpy(), np.asarray(ref.lhs))
    # Tree 0 sits at +y: its outward normal (tree -> payload) points -y.
    assert out.lhs[0, 1] < 0 < out.lhs[1, 1]


@pytest.mark.parametrize("n", [4, 8])
def test_agent_env_cbfs_match(n):
    """C-ADMM per-agent vision-cone rows over a scenario batch."""
    jp, jcol, js = jsetup.rqp_setup(n)
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    jcfg = jcadmm.make_config(jp, jcol.collision_radius, jcol.max_deceleration)
    tcfg = cadmm.make_config(tp, tcol.collision_radius, tcol.max_deceleration,
                             device="cpu")
    jf, tf = _forests()
    xl, vl = _seeded_states(12, seed=n)
    ref = jax.jit(jax.vmap(lambda x, v: jcadmm.agent_env_cbfs(
        jp, jcfg, jf, js.replace(xl=x, vl=v))))(jnp.asarray(xl),
                                                jnp.asarray(vl))
    S = xl.shape[0]
    states = ts.replace(
        R=ts.R.expand(S, n, 3, 3), w=ts.w.expand(S, n, 3), xl=_t(xl),
        vl=_t(vl), Rl=ts.Rl.expand(S, 3, 3), wl=ts.wl.expand(S, 3),
        step=ts.step.expand(S),
    )
    out = cadmm.agent_env_cbfs_for(tp, tcfg, tf, states, tp.r)
    assert out.lhs.shape == (S, n, tcfg.n_env_cbfs, 3)
    assert np.abs(out.lhs.numpy()).max(-1).sum() > 10  # rows are active.
    _cbf_close(ref, out, witness=True)
