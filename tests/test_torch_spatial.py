"""PyTorch port vs the JAX package: the spatial-hash grid and the bucketed
environment query (``envs/spatial.py``), the city-scale ``make_forest``, the
resolution of the query tier, and the bucketed rows against the port's own
dense rows.

Tolerances, and why:

- The grid is built host-side in float64 numpy with the JAX package's
  calls, and the city world's tree positions come from the same numpy RNG
  calls rounded once to float32: indices, flags, shapes and positions are
  exactly equal (indices compared as integers; the port holds them as
  int64).
- Bucketed rows against the port's dense rows: bitwise. Every per-tree
  value comes from the same elementwise ops whatever the number of trees
  swept, the slabs cover every tree in range, and they ascend in tree
  index (the stable selection's tie order).
- Bucketed rows against the JAX package's: the bars of
  ``tests/test_torch_forest.py`` (the float32 witness point, see there).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_forest import _cbf_close

from tpu_aerial_transport.control import cadmm as jcadmm
from tpu_aerial_transport.control import dd as jdd
from tpu_aerial_transport.envs import forest as jforest
from tpu_aerial_transport.envs import spatial as jspatial
from tpu_aerial_transport.harness import setup as jsetup
from tpu_aerial_transport_torch import convert
from tpu_aerial_transport_torch.control import cadmm, dd
from tpu_aerial_transport_torch.envs import forest, spatial
from tpu_aerial_transport_torch.harness import bucketing, setup
from tpu_aerial_transport_torch.tree import tree_map

VISION = 6.0
QUERY_R = VISION + forest.BARK_RADIUS
DENSITY = 0.085


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def _city_kw(n_trees):
    n_side = math.isqrt(n_trees)
    return dict(max_trees=n_trees, density=DENSITY,
                world_size=(n_side + 0.5) / math.sqrt(DENSITY))


def _city(n_trees=4096, seed=1):
    return forest.make_forest(seed=seed, device="cpu", **_city_kw(n_trees))


def _rows(f, xl, vl, mode, n_rows=10, vision_mask=None):
    return forest.collision_cbf_rows(
        f, xl, vl, VISION - 5.0, 2.0, VISION, 0.1, 1.5, n_rows,
        vision_mask=vision_mask, env_query=mode)


def _bitwise(a, b):
    for k in ("lhs", "rhs", "collision", "min_dist"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def _grids_equal(jg, tg):
    np.testing.assert_array_equal(tg.cell_idx.numpy(),
                                  np.asarray(jg.cell_idx).astype(np.int64))
    assert tg.cell_idx.dtype == torch.int64
    np.testing.assert_array_equal(tg.cell_valid.numpy(),
                                  np.asarray(jg.cell_valid))
    np.testing.assert_array_equal(tg.origin.numpy(), np.asarray(jg.origin))
    assert tg.inv_cell.numpy() == np.asarray(jg.inv_cell)
    for k in ("nx", "ny", "k", "query_radius", "cell_size"):
        assert getattr(tg, k) == getattr(jg, k), k


# ------------------------------- build --------------------------------


@pytest.mark.parametrize("world", ["mountain", "city4096"])
def test_build_grid_matches_jax_exactly(world):
    """``build_grid`` and ``with_grid`` give the JAX package's grid: every
    index, every flag, the origin, ``inv_cell`` and the static fields."""
    if world == "mountain":
        jf, tf = jforest.make_forest(seed=3), forest.make_forest(
            seed=3, device="cpu")
    else:
        jf = jforest.make_forest(seed=1, **_city_kw(4096))
        tf = _city(4096)
    jg = jspatial.build_grid(jf, QUERY_R)
    _grids_equal(jg, spatial.build_grid(tf, QUERY_R))
    _grids_equal(jg, spatial.with_grid(tf, QUERY_R).grid)
    assert spatial.grid_stats(spatial.build_grid(tf, QUERY_R)) \
        == jspatial.grid_stats(jg)


def test_overflow_refusal_measures_k_needed():
    """The refusal's ``k_needed`` is the JAX package's, and it is the fix."""
    jf, tf = jforest.make_forest(seed=0), forest.make_forest(seed=0,
                                                             device="cpu")
    with pytest.raises(jspatial.GridOverflowError) as jerr:
        jspatial.build_grid(jf, QUERY_R, k=2)
    with pytest.raises(spatial.GridOverflowError) as terr:
        spatial.build_grid(tf, QUERY_R, k=2)
    assert isinstance(terr.value, ValueError)
    assert (terr.value.k, terr.value.k_needed) == (2, jerr.value.k_needed)
    assert str(terr.value.k_needed) in str(terr.value)
    grid = spatial.build_grid(tf, QUERY_R, k=terr.value.k_needed)
    assert grid.k == terr.value.k_needed
    with pytest.raises(ValueError, match="positive"):
        spatial.build_grid(tf, 0.0)


def test_empty_world_grid():
    tf = forest.forest_from_tree_pos(np.zeros((0, 3)), 0, device="cpu")
    jf = jforest.forest_from_tree_pos(np.zeros((0, 3)), 0)
    grid = spatial.build_grid(tf, QUERY_R)
    _grids_equal(jspatial.build_grid(jf, QUERY_R), grid)
    stats = spatial.grid_stats(grid)
    assert stats["max_occupancy"] == 0 and stats["n_cells"] == 1


@pytest.mark.parametrize("seed,n_trees,density", [
    (0, 1024, DENSITY), (2, 4096, DENSITY), (5, 900, None)])
def test_make_forest_city_matches_jax_exactly(seed, n_trees, density):
    """The jittered-grid world: the same numpy RNG calls, so the tree
    positions are bitwise the JAX package's (``density=None`` is the
    tightest packing the spacing admits)."""
    world_size = (math.isqrt(n_trees) + 0.5) * 3.2 if density is None \
        else _city_kw(n_trees)["world_size"]
    kw = dict(max_trees=n_trees + 7, world_size=world_size, density=density)
    jf = jforest.make_forest(seed=seed, **kw)
    tf = forest.make_forest(seed=seed, device="cpu", **kw)
    np.testing.assert_array_equal(tf.tree_pos.numpy(), np.asarray(jf.tree_pos))
    np.testing.assert_array_equal(tf.tree_valid.numpy(),
                                  np.asarray(jf.tree_valid))
    assert int(tf.num_trees) == int(jf.num_trees)
    assert tf.tree_pos.dtype == torch.float32 and tf.grid is None


@pytest.mark.parametrize("kw,match", [
    (dict(world_size=100.0, density=0.2), "density"),
    (dict(max_trees=100, world_size=100.0, density=0.085), "max_trees"),
    (dict(density=0.05), "world_size"),
])
def test_make_forest_refusals(kw, match):
    """The city form's three refusals, as the JAX package's."""
    with pytest.raises(ValueError, match=match):
        jforest.make_forest(seed=0, **kw)
    with pytest.raises(ValueError, match=match):
        forest.make_forest(seed=0, device="cpu", **kw)


# ----------------------------- resolution ------------------------------


@pytest.mark.parametrize("env", [None, "", "auto", "dense", "Bucketed ",
                                 "quadtree"])
def test_resolve_env_query_matches_jax(monkeypatch, env):
    """``resolve_env_query`` reads TAT_ENV_QUERY as the JAX package does:
    dense/bucketed force the tier, auto or unset stays "auto", anything
    else is a ValueError; explicit arguments pass through validated."""
    if env is None:
        monkeypatch.delenv("TAT_ENV_QUERY", raising=False)
    else:
        monkeypatch.setenv("TAT_ENV_QUERY", env)
    for arg in ("auto", None, "dense", "bucketed", "grid"):
        try:
            want = jspatial.resolve_env_query(arg)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).split(":")[0]):
                spatial.resolve_env_query(arg)
            continue
        assert spatial.resolve_env_query(arg) == want, (env, arg)
    params, col, _ = setup.rqp_setup(4, device="cpu")
    if env is not None and env.strip().lower() not in (
            "", "auto", "dense", "bucketed"):
        with pytest.raises(ValueError, match="TAT_ENV_QUERY"):
            cadmm.make_config(params, col.collision_radius,
                              col.max_deceleration, device="cpu")
        return
    cfg = cadmm.make_config(params, col.collision_radius,
                            col.max_deceleration, device="cpu")
    assert cfg.env_query == jspatial.resolve_env_query("auto")
    dcfg = dd.make_config(params, col.collision_radius, col.max_deceleration,
                          env_query="dense", device="cpu")
    assert dcfg.base.env_query == "dense"


def test_runtime_env_query_resolution():
    """"auto" by slot count; "bucketed" without a grid is the JAX
    package's ValueError, not a dense fallback."""
    small = forest.make_forest(seed=0, device="cpu")
    assert spatial.runtime_env_query("auto", small) == "dense"
    assert spatial.DENSE_AUTO_MAX_TREES == jspatial.DENSE_AUTO_MAX_TREES \
        == forest.MAX_TREES
    big = _city(1024)
    with pytest.raises(ValueError, match="no spatial grid"):
        spatial.runtime_env_query("auto", big)
    assert spatial.runtime_env_query(
        "auto", spatial.with_grid(big, QUERY_R)) == "bucketed"
    with pytest.raises(ValueError, match="no spatial grid"):
        spatial.runtime_env_query("bucketed", small)
    assert spatial.runtime_env_query("dense", big) == "dense"
    with pytest.raises(ValueError, match="env_query"):
        spatial.runtime_env_query("grid", small)
    xl = torch.tensor([30.0, 0.0, 2.0])
    with pytest.raises(ValueError, match="no spatial grid"):
        _rows(big, xl, xl, "auto")


def test_coverage_and_rowcount_refusals():
    short = spatial.with_grid(forest.make_forest(seed=0, device="cpu"), 3.0)
    xl = torch.tensor([30.0, 0.0, 2.0])
    with pytest.raises(ValueError, match="query_radius"):
        spatial.bucketed_distance(short, xl, xl, 1.0, VISION)
    ok = spatial.with_grid(forest.make_forest(seed=0, device="cpu"), QUERY_R)
    with pytest.raises(ValueError, match="n_rows"):
        spatial.bucketed_distance(ok, xl, xl, 1.0, VISION,
                                  n_rows=ok.grid.k + 1)
    with pytest.raises(ValueError, match="n_rows"):
        _rows(ok, xl, xl, "bucketed", n_rows=ok.grid.k + 1)
    with pytest.raises(ValueError, match="forest.grid"):
        spatial.bucketed_distance(forest.make_forest(seed=0, device="cpu"),
                                  xl, xl, 1.0, VISION)


def test_candidate_slab_covers_and_matches_jax():
    """Batched over scenarios, ``(S, 3) -> (S, K)``: the JAX package's slab
    at every probe, ascending, and holding every tree within the query
    radius of the probe (the coverage the bitwise rows rest on); probes
    far outside the world clip into it."""
    jf = jspatial.with_grid(jforest.make_forest(seed=3), QUERY_R)
    tf = spatial.with_grid(forest.make_forest(seed=3, device="cpu"), QUERY_R)
    rng = np.random.default_rng(0)
    probes = np.concatenate([
        rng.uniform(-30, 30, size=(64, 2)) + forest.MOUNTAIN_CENTER,
        [[-1e4, 5.0], [1e4, -1e4], [30.0, 1e9]]]).astype(np.float32)
    mids = np.concatenate([probes, np.full((len(probes), 1), 2.0,
                                           np.float32)], 1)
    idx, valid = spatial.candidate_slab(tf, _t(mids))
    assert idx.shape == valid.shape == (len(mids), tf.grid.k)
    ji, jv = jax.jit(jax.vmap(lambda m: jspatial.candidate_slab(jf, m)))(
        jnp.asarray(mids))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    pos = tf.tree_pos.numpy()[: int(tf.num_trees), :2].astype(np.float64)
    for p, i, v in zip(probes[:64], idx.numpy(), valid.numpy()):
        slab = i[v]
        assert (np.diff(slab) > 0).all()
        near = np.nonzero(np.linalg.norm(pos - p, axis=1) <= QUERY_R)[0]
        assert set(near.tolist()) <= set(slab.tolist())


# ------------------------ bucketed == dense ----------------------------


@pytest.mark.parametrize("seed", range(4))
def test_bucketed_rows_bitwise_equal_dense(seed):
    """One query and a batch of 32 over the mountain world, and the batch
    over a 1024-tree city world with and without a vision mask: the
    bucketed rows are the dense rows, bit for bit."""
    f = spatial.with_grid(forest.make_forest(seed=seed, device="cpu"),
                          QUERY_R)
    rng = np.random.default_rng(seed)
    xl = _t(np.append(rng.uniform(5, 55, 2), 2.0))
    vl = _t(rng.normal(size=3))
    _bitwise(_rows(f, xl, vl, "dense"), _rows(f, xl, vl, "bucketed"))
    xs = _t(np.concatenate([rng.uniform(0, 60, (32, 2)),
                            np.full((32, 1), 2.0)], axis=1))
    vs = _t(rng.normal(size=(32, 3)))
    dense = _rows(f, xs, vs, "dense")
    assert (dense.lhs.abs().amax(-1) > 0).sum() > 20  # rows are active.
    _bitwise(dense, _rows(f, xs, vs, "bucketed"))
    city = spatial.with_grid(_city(1024, seed=seed), QUERY_R)
    cxs = xs + _t([10.0 * seed - 20.0, 5.0, 0.0])
    _bitwise(_rows(city, cxs, vs, "dense"), _rows(city, cxs, vs, "auto"))
    mask = torch.as_tensor(rng.random((32, city.tree_pos.shape[0])) < 0.7)
    _bitwise(_rows(city, cxs, vs, "dense", vision_mask=mask),
             _rows(city, cxs, vs, "bucketed", vision_mask=mask))


def test_tie_order_pinned():
    """Two mirrored trees at bitwise-equal distances: both tiers take tree
    0's row first."""
    trees = np.array([[33.0, 3.0, 2.0], [33.0, -3.0, 2.0]])
    f = spatial.with_grid(forest.forest_from_tree_pos(trees, 2,
                                                      device="cpu"), QUERY_R)
    xl = torch.tensor([33.0, 0.0, 2.0])
    vl = torch.tensor([1.0, 0.0, 0.0])
    data = forest.capsule_forest_distance(f, xl, xl, 0.5, VISION)
    assert float(data.dists[0]) == float(data.dists[1])
    dense, buck = _rows(f, xl, vl, "dense"), _rows(f, xl, vl, "bucketed")
    _bitwise(dense, buck)
    assert buck.lhs[0, 1] < 0 < buck.lhs[1, 1]


def test_zero_range_cone_keep_through_bucketed():
    """``vision_cone_mask`` keeps a tree at zero camera range, as the JAX
    package's does, and the mask over a slab's candidates is the dense mask
    gathered at the slab."""
    trees = np.array([[30.0, 0.0, 2.0], [35.0, 1.0, 2.0]])
    f = spatial.with_grid(forest.forest_from_tree_pos(trees, 2,
                                                      device="cpu"), QUERY_R)
    jf = jforest.forest_from_tree_pos(trees, 2)
    camera, direction = torch.tensor([30.0, 0.0]), torch.tensor([1.0, 0.0])
    dense_mask = forest.vision_cone_mask(f, camera, direction, 0.1)
    assert bool(dense_mask[0])
    np.testing.assert_array_equal(
        dense_mask.numpy(), np.asarray(jforest.vision_cone_mask(
            jf, jnp.asarray(camera), jnp.asarray(direction), 0.1)))
    idx, _ = spatial.candidate_slab(f, torch.tensor([30.0, 0.0, 2.0]))
    cand = forest.cone_mask_at(f.tree_pos[idx], camera, direction, 0.1)
    assert torch.equal(cand, dense_mask[idx])


def test_exact_axis_contact_through_bucketed():
    """Exact axis-surface contact keeps its protecting row on the bucketed
    tier, bitwise the dense row."""
    tree = np.array([[1.0, 0.0, 2.0]])
    f = spatial.with_grid(forest.forest_from_tree_pos(tree, 1, device="cpu"),
                          6.0 + 0.3)
    xl = torch.tensor([1.0 - forest.BARK_RADIUS, 0.0, 2.0])
    kw = dict(collision_radius=0.9, max_deceleration=2.0, vision_radius=6.0,
              dist_eps=0.1, alpha_env_cbf=1.5, n_rows=4)
    buck = forest.collision_cbf_rows(f, xl, torch.zeros(3),
                                     env_query="bucketed", **kw)
    act = buck.lhs.abs().amax(-1) > 0
    assert bool(act.any())
    r = int(torch.argmax(act.to(torch.int32)))
    assert buck.lhs[r, 0] < 0 and buck.rhs[r] > 0
    _bitwise(forest.collision_cbf_rows(f, xl, torch.zeros(3),
                                       env_query="dense", **kw), buck)


def test_empty_cell_matches_forest_none():
    """A query far outside a city world (an empty slab after clipping)
    gives the inactive rows of ``forest=None``."""
    f = spatial.with_grid(_city(4096), QUERY_R)
    far = torch.tensor([[-4000.0, -4000.0, 2.0], [5000.0, 30.0, 2.0]])
    v = torch.tensor([[0.5, 0.0, 0.0], [0.0, -1.0, 0.0]])
    _bitwise(_rows(f, far, v, "bucketed"), _rows(None, far, v, "dense"))
    _bitwise(_rows(f, far, v, "bucketed"), _rows(f, far, v, "dense"))


def test_bucketed_rows_match_jax():
    """The port's bucketed rows against the JAX package's bucketed rows on a
    city world (the same grid), beside the trees at mid-height, within
    ``tests/test_torch_forest.py``'s bars."""
    jf = jspatial.with_grid(jforest.make_forest(seed=1, **_city_kw(1024)),
                            QUERY_R)
    tf = convert.forest(jax.tree.map(np.asarray, jf), device="cpu")
    rng = np.random.default_rng(7)
    pos = tf.tree_pos.numpy()[:1024, :2]
    xl = []
    while len(xl) < 24:
        xy = rng.uniform(pos.min(0) + 5, pos.max(0) - 5)
        if np.min(np.linalg.norm(pos - xy, axis=1)) > 0.6:
            xl.append([xy[0], xy[1], rng.uniform(1.2, 3.0)])
    xl = np.array(xl, np.float32)
    vl = (rng.normal(size=(24, 3)) * np.array([1.2, 1.2, 0.05])).astype(
        np.float32)
    vl[::4] = 0.0
    kw = dict(collision_radius=0.9, max_deceleration=2.0, vision_radius=VISION,
              dist_eps=0.1, alpha_env_cbf=1.5, n_rows=10)
    ref = jax.jit(jax.vmap(lambda x, v: jforest.collision_cbf_rows(
        jf, x, v, env_query="bucketed", **kw)))(jnp.asarray(xl),
                                                jnp.asarray(vl))
    out = forest.collision_cbf_rows(tf, _t(xl), _t(vl), env_query="bucketed",
                                    **kw)
    assert (out.lhs.abs().amax(-1) > 0).sum() > 50  # rows are active.
    _cbf_close(ref, out, witness=True)


@pytest.mark.parametrize("ctrl", ["cadmm", "dd"])
def test_agent_env_cbfs_on_both_tiers(ctrl):
    """The per-agent vision-cone rows (one sweep a scenario, a cone mask an
    agent): bucketed bitwise the dense rows on a city world, for C-ADMM's
    config and DD's; and against the JAX package's ``agent_env_cbfs`` on the
    bucketed tier within ``tests/test_torch_forest.py``'s bars."""
    n = 4
    tp, tcol, ts = setup.rqp_setup(n, device="cpu")
    jp, jcol, js = jsetup.rqp_setup(n)
    mods = {"cadmm": (cadmm, jcadmm), "dd": (dd, jdd)}[ctrl]
    cfgs = {}
    for mode in ("dense", "bucketed", "auto"):
        cfg = mods[0].make_config(tp, tcol.collision_radius,
                                  tcol.max_deceleration, env_query=mode,
                                  device="cpu")
        cfgs[mode] = cfg if ctrl == "cadmm" else cfg.base
    jcfg = mods[1].make_config(jp, jcol.collision_radius,
                               jcol.max_deceleration, env_query="auto")
    jcfg = jcfg if ctrl == "cadmm" else jcfg.base
    jf = jspatial.with_grid(jforest.make_forest(seed=2, **_city_kw(1024)),
                            jcfg.vision_radius + jforest.BARK_RADIUS)
    tf = convert.forest(jax.tree.map(np.asarray, jf), device="cpu")
    rng = np.random.default_rng(3)
    S = 12
    xl = (rng.normal(size=(S, 3)) * np.array([15.0, 15.0, 0.5])
          + np.array([30.0, 0.0, 2.2])).astype(np.float32)
    vl = (rng.normal(size=(S, 3)) * np.array([0.8, 0.8, 0.05])).astype(
        np.float32)
    states = tree_map(lambda t: t.expand((S,) + t.shape).clone(), ts).replace(
        xl=_t(xl), vl=_t(vl))
    rows = {m: cadmm.agent_env_cbfs_for(tp, c, tf, states, tp.r)
            for m, c in cfgs.items()}
    assert rows["dense"].lhs.shape == (S, n, cfgs["dense"].n_env_cbfs, 3)
    assert (rows["dense"].lhs.abs().amax(-1) > 0).sum() > 20
    _bitwise(rows["dense"], rows["bucketed"])
    _bitwise(rows["dense"], rows["auto"])
    _bitwise(rows["auto"], cadmm.agent_env_cbfs(tp, cfgs["auto"], tf, states))
    ref = jax.jit(jax.vmap(lambda x, v: jcadmm.agent_env_cbfs(
        jp, jcfg, jf, js.replace(xl=x, vl=v))))(jnp.asarray(xl),
                                                jnp.asarray(vl))
    _cbf_close(ref, rows["auto"], witness=True)


def test_grid_rides_the_forest():
    """``tree_map`` and ``dataclasses.replace`` carry the grid (tensors
    mapped, static fields unchanged), the bucketed rows stay the same, and
    the congestion metric reads a gridded forest as a plain one."""
    import dataclasses

    f = spatial.with_grid(forest.make_forest(seed=0, device="cpu"), QUERY_R)
    moved = tree_map(lambda t: t.clone(), f)
    assert moved.grid is not f.grid and moved.grid.k == f.grid.k
    assert moved.bark_radius == f.bark_radius
    assert moved.grid.cell_idx.data_ptr() != f.grid.cell_idx.data_ptr()
    assert dataclasses.replace(f, num_trees=f.num_trees).grid is f.grid
    xl = torch.tensor([[30.0, 0.0, 2.0], [12.0, 4.0, 2.5]])
    vl = torch.tensor([[0.5, 0.0, 0.0], [0.0, 0.3, 0.0]])
    _bitwise(_rows(f, xl, vl, "bucketed"), _rows(moved, xl, vl, "bucketed"))
    plain = dataclasses.replace(f, grid=None)
    states = setup.rqp_setup(4, device="cpu")[2]
    states = tree_map(lambda t: t.expand((2,) + t.shape).clone(),
                      states).replace(xl=xl)
    assert torch.equal(bucketing.env_congestion_metric(f, 6.0)(states),
                       bucketing.env_congestion_metric(plain, 6.0)(states))


def test_bucketed_distance_shapes_and_entry_points():
    """``bucketed_distance`` over ``(S, 3)`` capsules: ``(S, K)`` data,
    ``(S, K, 3)`` candidate centers at the slab indices; the two entry
    points are the two tiers' sweeps."""
    f = spatial.with_grid(forest.make_forest(seed=0, device="cpu"), QUERY_R)
    a = torch.tensor([[30.0, 0.0, 2.0], [20.0, -5.0, 2.0], [40.0, 3.0, 3.0]])
    b = a + torch.tensor([0.3, 0.0, 0.0])
    data, centers, idx = spatial.bucketed_distance(f, a, b, 1.0, VISION)
    K = f.grid.k
    assert data.dists.shape == (3, K) and centers.shape == (3, K, 3)
    assert torch.equal(centers, f.tree_pos[idx])
    buck = spatial.env_query_bucketed(f, a, b, 1.0, VISION)
    dense = spatial.env_query_dense(f, a, b, 1.0, VISION)
    assert torch.equal(buck.min_dist, dense.min_dist)
    assert torch.equal(buck.collision, dense.collision)
    # Every in-range tree's distance appears in the slab, bit for bit.
    for s in range(3):
        d_in = dense.dists[s][dense.mask[s]]
        b_in = buck.dists[s][buck.mask[s]]
        assert torch.equal(torch.sort(d_in).values, torch.sort(b_in).values)
