"""The port's kernel launch layouts, decided on the host: which body of the
whole-solve kernel and of the chunk kernel each QP shape takes, its block
and shared memory, the solver's route resolver against the wrappers'
refusals, and the ring-sum kernel's shard cap. Nothing here needs a card:
the wrapper decides from the shapes alone, and these are the decisions it
makes.

The expected shared-memory sizes are written out from the layout that
``csrc/fused_solve.cu`` documents (row strides of an odd number of
16-byte words), independently of the functions under test.
"""

import pytest
import torch

from tpu_aerial_transport_torch.control import (
    cadmm,
    centralized,
    dd,
    pmrl_centralized,
    rp_centralized,
)
from tpu_aerial_transport_torch.harness import setup
from tpu_aerial_transport_torch.ops import admm_kernel, socp
from tpu_aerial_transport_torch.parallel import ring

# Shared memory of one H100 SM (228 KB) and what the runtime reserves a
# block (1 KB): 16 lanes an SM need 16 / lanes-per-block blocks to fit.
SM_SMEM_BYTES = 233472
BLOCK_RESERVED_BYTES = 1024


def _agent_dims(controller, n):
    """(nv, m) of one padded agent QP, from the controller's own config."""
    params, col, _ = setup.rqp_setup(n, device="cpu")
    mod = cadmm if controller == "cadmm" else dd
    cfg = mod.make_config(params, col.collision_radius, col.max_deceleration,
                          pad_operators=True, device="cpu")
    if controller == "cadmm":
        _, _, nv_p, _, m_p = cadmm._qp_dims(cfg, n)
    else:
        _, _, nv_p, _, m_p = dd._qp_dims(cfg)
    return nv_p, m_p


def _central_dims(n):
    n_box, m, soc = centralized.qp_dims(n, 10)
    return 9 + 3 * n, m, n_box, soc


@pytest.mark.parametrize("controller,n,nv,m,lane_floats", [
    # A 32 x 20 + P 16 x 20, K2's 16 x rows x 52, u 48, y 32.
    ("cadmm", 8, 16, 32, 48 * 20 + 16 * 52 + 48 + 32),
    # A 32 x 28 + P 24 x 28, K2's 24 x rows x 60, u 56, y 32.
    ("dd", 8, 24, 32, 56 * 28 + 24 * 60 + 56 + 32),
    ("cadmm", 3, 24, 32, 56 * 28 + 24 * 60 + 56 + 32),  # the full QP.
])
def test_agent_qps_take_the_warp_body(controller, n, nv, m, lane_floats):
    """Every agent QP (C-ADMM d = 48, DD and the n = 3 full QP d = 56)
    runs one warp per lane, four lanes a block, and 16 lanes fit an SM's
    shared memory."""
    assert _agent_dims(controller, n) == (nv, m)
    geo = admm_kernel.fused_solve_geometry(nv, m)
    assert geo == admm_kernel.Geometry("warp", 4, 128, 4 * 4 * lane_floats)
    blocks = 16 // geo.lanes_per_block
    assert blocks * (geo.smem_bytes + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES
    admm_kernel._check_layout("fused_solve", nv, m, m - 8, (4, 4), 20,
                              geo.smem_bytes)


@pytest.mark.parametrize("n,d,threads", [(3, 67, 96), (4, 79, 96),
                                         (8, 127, 128)])
def test_centralized_qps_take_the_shared_memory_body(n, d, threads):
    """The centralized QPs (m > 32) keep one block of whole warps per lane
    with every operator in shared memory."""
    nv, m, n_box, soc = _central_dims(n)
    assert nv + m == d
    geo = admm_kernel.fused_solve_geometry(nv, m)
    assert geo == admm_kernel.Geometry(
        "shared", 1, threads, admm_kernel.fused_solve_smem_bytes(nv, m))
    admm_kernel._check_layout("fused_solve", nv, m, n_box, soc, 120,
                              geo.smem_bytes)


@pytest.mark.parametrize("n,route,threads,smem", [
    # 4 (d (d|1) + (2 nv + m) (nv|1) + 2 d + 66): n = 3, nv = 15, m = 36.
    (3, "kernel", 64, 4 * (51 * 51 + 66 * 15 + 102 + 66)),
    # n = 8, nv = 30, m = 81: above the 48 KB default, 16 SOC blocks.
    (8, "kernel", 128, 4 * (111 * 111 + 141 * 31 + 222 + 66)),
    (9, "scan", None, None),  # 18 SOC blocks.
])
def test_rp_and_pmrl_qps_take_the_shared_memory_body(n, route, threads,
                                                     smem):
    """The RP and PMRL controllers' QP (m = 9n + 9 > 32 rows) takes the
    whole-solve kernel's shared-memory body up to n = 8 (67,920 B of
    shared memory at d = 111, exactly MAX_SOC_BLOCKS blocks) and route
    "scan" from n = 9; the controllers' fixed and early-exit solves
    resolve alike."""
    nv = 6 + 3 * n
    n_box, m, soc = rp_centralized.qp_dims(n)
    assert pmrl_centralized.qp_dims(n) == (n_box, m, soc)
    assert (n_box, m) == (9 + n, 9 * n + 9)
    params = setup.rp_setup(n, device="cpu")[0]
    assert rp_centralized.solve_route(
        n, rp_centralized.make_config(params)) == route
    assert socp.runtime_fused_mode("auto", nv, m, n_box, soc, check_every=25,
                                   tol=5e-3) == route
    geo = admm_kernel.fused_solve_geometry(nv, m)
    if route == "scan":
        assert len(soc) > admm_kernel.MAX_SOC_BLOCKS
        with pytest.raises(ValueError, match="SOC blocks"):
            admm_kernel._check_layout("fused_solve", nv, m, n_box, soc, 150,
                                      geo.smem_bytes)
        return
    assert geo == admm_kernel.Geometry("shared", 1, threads, smem)
    assert smem <= admm_kernel.MAX_SMEM_BYTES
    admm_kernel._check_layout("fused_solve", nv, m, n_box, soc, 150, smem)


def test_centralized_n16_is_refused():
    """n = 16 (32 SOC blocks, d = 223) is refused, as before the warp
    body: the shared-memory body takes it by size, not by its cone."""
    nv, m, n_box, soc = _central_dims(16)
    geo = admm_kernel.fused_solve_geometry(nv, m)
    assert geo.body == "shared"
    with pytest.raises(ValueError, match="SOC blocks"):
        admm_kernel._check_layout("fused_solve", nv, m, n_box, soc, 120,
                                  geo.smem_bytes)


@pytest.mark.parametrize("nv,m,body", [
    (16, 32, "warp"), (24, 32, "warp"), (32, 32, "warp"), (1, 1, "warp"),
    (12, 25, "warp"),  # the unpadded C-ADMM agent QP.
    (33, 31, "shared"), (12, 33, "shared"),  # d = 64, one side past 32.
    (40, 32, "shared"),  # C-ADMM's full QP at n = 8, padded: d = 72.
])
def test_body_follows_the_shape_alone(nv, m, body):
    """The warp body takes nv and m up to 32 each (one x row and one
    constraint row a thread); every other shape takes the shared-memory
    body, which can also be asked for at any shape (to time one body
    against the other); the warp body cannot be forced past its rows."""
    assert admm_kernel.fused_solve_geometry(nv, m).body == body
    assert admm_kernel.fused_solve_geometry(nv, m, "shared").body == "shared"
    if body == "shared":
        with pytest.raises(ValueError, match="warp"):
            admm_kernel.fused_solve_geometry(nv, m, "warp")


@pytest.mark.parametrize("k", range(1, 65))
def test_warp_row_stride_is_an_odd_count_of_16_byte_words(k):
    """Rows of k floats get a stride of whole 16-byte words, an odd number
    of them, so eight threads reading eight rows' same word hit eight
    distinct bank groups."""
    ld = admm_kernel._ld16(k)
    assert ld >= k and ld % 4 == 0 and (ld // 4) % 2 == 1 and ld - k < 8


def test_kernel_names_are_distinct_and_counted():
    """Eight entry points, none a substring of another, each with its own
    launch counter; the per-form counters stay as they were."""
    names = list(admm_kernel.KERNEL_NAMES.values())
    assert len(set(names)) == 8
    for a in names:
        assert not any(a != b and a in b for b in names)
    assert set(admm_kernel.KERNEL_LAUNCHES) == set(names)
    assert set(admm_kernel.LAUNCHES) == {
        "fused_solve", "fused_solve_early", "fused_solve_bf16",
        "fused_solve_early_bf16", "admm_chunk"}
    assert admm_kernel.KERNEL_NAMES["warp", True, "bf16"] == \
        "warp_solve_early_bf16_kernel"


def test_ring_sum_shard_cap():
    """The ring-sum kernel takes up to 32 shards (a thread holds a column's
    d values in registers); 33 is refused on any device, before the
    plain version runs, with a message that says why."""
    assert ring.MAX_SHARDS == 32
    x = torch.arange(32 * 5, dtype=torch.float32).reshape(32, 5)
    before = dict(ring.LAUNCHES)
    out = ring.ring_sum_shards(x)
    assert ring.LAUNCHES == before
    assert torch.equal(out, ring.ring_sum_shards_reference(x))
    with pytest.raises(ValueError, match="at most 32.*registers"):
        ring.ring_sum_shards(torch.zeros((33, 5)))


@pytest.mark.parametrize("controller,n,nv,m,x_rows,lane_floats", [
    # u 48; x rows in two half-warps' registers.
    ("cadmm", 8, 16, 32, "split", 48),
    # u 56, then K2's 24 x rows x 60 in shared memory.
    ("dd", 8, 24, 32, "shared", 56 + 24 * 60),
])
def test_agent_qps_take_the_warp_chunk_body(controller, n, nv, m, x_rows,
                                            lane_floats):
    """The chunk kernel runs every agent QP one warp a lane, four lanes a
    block: the headline (d = 48, nv = 16) with K2's x rows split across
    the two half-warps' registers, DD (d = 56, nv = 24) with them in
    shared memory; 16 lanes fit an SM's shared memory."""
    assert _agent_dims(controller, n) == (nv, m)
    geo = admm_kernel.admm_chunk_geometry(nv, m)
    assert geo == admm_kernel.ChunkGeometry("warp", x_rows, 4, 128,
                                            4 * 4 * lane_floats)
    blocks = 16 // geo.lanes_per_block
    assert blocks * (geo.smem_bytes + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES
    assert admm_kernel.admm_chunk_fits(nv, m, m - 8, (4, 4))
    admm_kernel._check_layout("admm_chunk", nv, m, m - 8, (4, 4), 20,
                              geo.smem_bytes)


@pytest.mark.parametrize("nv,m,threads", [
    (40, 32, 96),  # C-ADMM's full QP at n = 8, padded: d = 72.
    (33, 31, 64), (12, 33, 64),  # d = 64, one side past 32.
    (57, 94, 160),  # a centralized-sized QP.
])
def test_chunk_shapes_beyond_the_warp_take_the_block_body(nv, m, threads):
    """Past 32 x rows or 32 constraint rows the chunk kernel keeps one
    block of whole warps a lane with K2 in shared memory (odd row stride,
    two d-vectors); the warp body cannot be forced there, and the split
    layout only up to 16 x rows."""
    d = nv + m
    geo = admm_kernel.admm_chunk_geometry(nv, m)
    assert geo == admm_kernel.ChunkGeometry(
        "block", None, 1, threads, 4 * (d * (d | 1) + 2 * d))
    with pytest.raises(ValueError, match="warp"):
        admm_kernel.admm_chunk_geometry(nv, m, "warp")
    with pytest.raises(ValueError, match="split"):
        admm_kernel.admm_chunk_geometry(24, 32, "warp", "split")
    assert admm_kernel.admm_chunk_geometry(16, 32, "block").body == "block"
    assert admm_kernel.admm_chunk_geometry(
        16, 32, "warp", "shared").smem_bytes == 4 * 4 * (48 + 16 * 52)


# (nv, m, n_box, soc_dims) of the solves the port runs: the centralized QPs
# at n agents, and the padded agent QPs.
_CENTRAL = {f"central_n{n}": _central_dims(n)
            for n in (1, 2, 3, 4, 6, 8, 9, 10, 16, 64)}
_AGENTS = {"cadmm_d48": (16, 32, 24, (4, 4)), "dd_d56": (24, 32, 24, (4, 4)),
           "full_qp_n8_d72": (40, 32, 24, (4, 4)),
           "cadmm_unpadded": (12, 25, 17, (4, 4))}
_SHAPES = {**_CENTRAL, **_AGENTS}


@pytest.mark.parametrize("shape", list(_SHAPES), ids=list(_SHAPES))
def test_route_resolver_agrees_with_the_kernels_refusal(shape):
    """``runtime_fused_mode`` over every route: a shape it sends to a
    kernel ("kernel" or "pallas") is one that kernel's wrapper accepts
    (``_check_layout``), and a shape it turns from that kernel into "scan"
    is one the wrapper refuses; "scan" stays "scan", and "auto" is
    "kernel" resolved the same way."""
    nv, m, n_box, soc = _SHAPES[shape]
    geos = {"kernel": ("fused_solve",
                       admm_kernel.fused_solve_geometry(nv, m).smem_bytes),
            "pallas": ("admm_chunk",
                       admm_kernel.admm_chunk_geometry(nv, m).smem_bytes)}
    for route in ("kernel", "pallas"):
        kernel, smem = geos[route]
        got = socp.runtime_fused_mode(route, nv, m, n_box, soc,
                                      check_every=5, tol=1e-3)
        if got == route:
            admm_kernel._check_layout(kernel, nv, m, n_box, soc, 20, smem)
        else:
            assert got == "scan"
            with pytest.raises(ValueError, match="kernel takes"):
                admm_kernel._check_layout(kernel, nv, m, n_box, soc, 20,
                                          smem)
    assert socp.runtime_fused_mode("auto", nv, m, n_box, soc) == \
        socp.runtime_fused_mode("kernel", nv, m, n_box, soc)
    assert socp.runtime_fused_mode("scan", nv, m, n_box, soc) == "scan"
    if shape in _AGENTS:  # every agent QP runs on a kernel route.
        assert socp.runtime_fused_mode("auto", nv, m, n_box, soc) == \
            "kernel"
        assert socp.runtime_fused_mode("pallas", nv, m, n_box, soc) == \
            "pallas"


def test_route_resolver_boundary_and_bad_routes():
    """Centralized n <= 8 (at most 16 SOC blocks) stays on the whole-solve
    kernel; from n = 9 (18 blocks) both kernel routes resolve to "scan";
    the controller's own label says the same; routes outside ROUTES and
    "auto" are ValueErrors."""
    for n in range(1, 17):
        nv, m, n_box, soc = _central_dims(n)
        want = "kernel" if n <= 8 else "scan"
        assert socp.runtime_fused_mode("auto", nv, m, n_box, soc) == want
        assert (socp.runtime_fused_mode("pallas", nv, m, n_box, soc)
                == ("pallas" if n <= 8 else "scan"))
        params, col, _ = setup.rqp_setup(n, device="cpu")
        cfg = centralized.make_config(params, col.collision_radius,
                                      col.max_deceleration)
        assert centralized.solve_route(n, cfg) == want
    assert admm_kernel.fused_solve_fits(*_central_dims(8))
    assert not admm_kernel.fused_solve_fits(*_central_dims(9))
    for bad in ("interpret", "kernel_interpret", "turbo"):
        with pytest.raises(ValueError, match="socp_fused"):
            socp.runtime_fused_mode(bad, 16, 32, 24, (4, 4))
