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


# The register-row layout's shared memory a lane, in floats, region by
# region (csrc/admm_common.cuh rb_smem, one thread a K2 row): K2 at d's
# stride, Minv and P (nv rows) and A (m rows) at nv's stride, each rounded
# to whole 16-byte words; two u buffers of the instantiation's row length
# at an odd count of 16-byte words (d <= 72: 76; <= 80: 84; <= 112: 116;
# <= 128: 132); d, m and 68 floats of scratch, each whole words. A stride is
# k | 1 for k not a multiple of 4, else an odd count of 16-byte words.
@pytest.mark.parametrize("n,d,threads,lane_floats", [
    # nv = 18, m = 49: 67 x 67, 2 x 18 x 19, 49 x 19, 2 x 76, 68, 52, 68.
    (3, 67, 96, 4492 + 2 * 344 + 932 + 2 * 76 + 68 + 52 + 68),
    # nv = 21, m = 58: 79 x 79, 2 x 21 x 21, 58 x 21, 2 x 84, 80, 60, 68.
    (4, 79, 96, 6244 + 2 * 444 + 1220 + 2 * 84 + 80 + 60 + 68),
    # nv = 33, m = 94: 127 x 127, 2 x 33 x 33, 94 x 33, 2 x 132, 128, 96, 68.
    (8, 127, 128, 16132 + 2 * 1092 + 3104 + 2 * 132 + 128 + 96 + 68),
])
def test_centralized_qps_take_the_shared_memory_body(n, d, threads,
                                                     lane_floats):
    """The centralized QPs (m > 32) keep one block of whole warps per lane,
    one thread a K2 row held in registers (staged once through shared
    memory), Minv, P and A in shared memory."""
    nv, m, n_box, soc = _central_dims(n)
    assert nv + m == d and admm_kernel.register_rows(d)
    geo = admm_kernel.fused_solve_geometry(nv, m)
    assert geo == admm_kernel.Geometry("shared", 1, threads, 4 * lane_floats)
    admm_kernel._check_layout("fused_solve", nv, m, n_box, soc, 120,
                              geo.smem_bytes)


@pytest.mark.parametrize("n,route,threads,smem", [
    # d = 51, K2 in shared memory: 4 (d (d|1) + (2 nv + m) (nv|1) + 2 d +
    # 66), nv = 15, m = 36.
    (3, "kernel", 64, 4 * (51 * 51 + 66 * 15 + 102 + 66)),
    # n = 8, d = 111 in registers: 111 x 111, 2 x 30 x 31, 81 x 31, 2 x 116,
    # 112, 84, 68 (above the 48 KB default, 16 SOC blocks).
    (8, "kernel", 128, 4 * (12324 + 2 * 932 + 2512 + 2 * 116 + 112 + 84
                            + 68)),
    (9, "scan", None, None),  # 18 SOC blocks.
])
def test_rp_and_pmrl_qps_take_the_shared_memory_body(n, route, threads,
                                                     smem):
    """The RP and PMRL controllers' QP (m = 9n + 9 > 32 rows) takes the
    whole-solve kernel's block body up to n = 8 (68,784 B of shared memory
    at d = 111, exactly MAX_SOC_BLOCKS blocks) and route "scan" from n = 9;
    the controllers' fixed and early-exit solves resolve alike."""
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


@pytest.mark.parametrize("nv,m,threads,lane_floats", [
    # C-ADMM's full QP at n = 8, padded: d = 72, K2 rows in registers (72 x
    # 76 staged), two u buffers of 76, m.
    (40, 32, 96, 72 * 76 + 2 * 76 + 32),
    # d = 64 and 45, one side past 32, and a centralized-sized QP (d = 151):
    # K2 in shared memory at an odd stride, two d-vectors.
    (33, 31, 64, 64 * 65 + 2 * 64), (12, 33, 64, 45 * 45 + 2 * 45),
    (57, 94, 160, 151 * 151 + 2 * 151),
])
def test_chunk_shapes_beyond_the_warp_take_the_block_body(nv, m, threads,
                                                          lane_floats):
    """Past 32 x rows or 32 constraint rows the chunk kernel keeps one
    block of whole warps a lane, one thread a K2 row: held in registers
    where d is 65 to 128, else read from shared memory; the warp body
    cannot be forced there, and the split layout only up to 16 x rows."""
    geo = admm_kernel.admm_chunk_geometry(nv, m)
    assert geo == admm_kernel.ChunkGeometry("block", None, 1, threads,
                                            4 * lane_floats)
    with pytest.raises(ValueError, match="warp"):
        admm_kernel.admm_chunk_geometry(nv, m, "warp")
    with pytest.raises(ValueError, match="split"):
        admm_kernel.admm_chunk_geometry(24, 32, "warp", "split")
    assert admm_kernel.admm_chunk_geometry(16, 32, "block").body == "block"
    assert admm_kernel.admm_chunk_geometry(
        16, 32, "warp", "shared").smem_bytes == 4 * 4 * (48 + 16 * 52)


@pytest.mark.parametrize("nv,m,chunk,lanes", [
    (40, 32, False, 4),  # the full QP at n = 8, 2048 lanes.
    (40, 32, True, 5),  # its chunk (route "pallas").
    (30, 81, False, 2),  # RP and PMRL at n = 8.
    (30, 81, True, 2),
])
def test_block_body_residency(nv, m, chunk, lanes):
    """The register-row layout keeps ``lanes`` lanes an SM, and its
    registers are what set that: the launch bound's budget a thread (read
    from csrc/admm_common.cuh, where the bound takes it: up to d = 80, 168
    for the whole solve and 136 for the chunk; 255 above), allocated 256
    registers a warp, fits that many lanes' warps in the SM's 65,536
    registers and not one more, while their shared memory (with the 1 KB a
    block the runtime reserves) and threads would fit one more."""
    budgets = admm_kernel._row_register_budgets()
    d = nv + m
    budget = (budgets["RB_LONG_REGS"] if d > budgets["RB_SHORT_D"]
              else budgets["RB_CHUNK_SHORT_REGS" if chunk
                           else "RB_SOLVE_SHORT_REGS"])
    geo = (admm_kernel.admm_chunk_geometry(nv, m) if chunk
           else admm_kernel.fused_solve_geometry(nv, m))
    assert geo.threads == _round_up32(d)
    lane_regs = geo.threads // 32 * -(-32 * budget // 256) * 256
    assert lanes * lane_regs <= 65536 < (lanes + 1) * lane_regs
    assert (lanes + 1) * (geo.smem_bytes + BLOCK_RESERVED_BYTES) \
        <= SM_SMEM_BYTES
    assert (lanes + 1) * geo.threads <= 2048
    assert admm_kernel.block_lanes_per_sm(nv, m, chunk) == lanes


def _round_up32(k):
    return -(-k // 32) * 32


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


def _parent_fits(nv, m, soc):
    """The kernels' admission before the register-row layout, written out:
    at most 16 SOC blocks, d at most 256, and the one-thread-a-row
    footprint (whole solve: K2 at an odd stride, Minv, P and A at an odd
    stride, two d-vectors and 66 floats of scratch; chunk: K2 and two
    d-vectors) within 232,448 B, for the body the shape alone picks."""
    d = nv + m
    warp = nv <= 32 and m <= 32
    if warp:
        solve = 4 * 4 * ((m + nv) * admm_kernel._ld16(nv)
                         + nv * admm_kernel._ld16(-(-d // 8) * 8)
                         + -(-d // 8) * 8 + -(-m // 4) * 4)
        chunk = 4 * 4 * (-(-d // 8) * 8 + (
            0 if nv <= 16 else nv * admm_kernel._ld16(-(-d // 8) * 8)))
    else:
        solve = 4 * (d * (d | 1) + (2 * nv + m) * (nv | 1) + 2 * d + 66)
        chunk = 4 * (d * (d | 1) + 2 * d)
    ok = len(soc) <= 16 and d <= 256
    return ok and solve <= 232448, ok and chunk <= 232448


@pytest.mark.parametrize("shape", list(_SHAPES), ids=list(_SHAPES))
def test_fits_answers_are_the_parents(shape):
    """Every shape the port solves gets the whole-solve and chunk kernels'
    admission it got before the register-row layout: the new footprint
    lets no kernel take a shape it refused, so no solve changes route."""
    nv, m, n_box, soc = _SHAPES[shape]
    assert (admm_kernel.fused_solve_fits(nv, m, n_box, soc),
            admm_kernel.admm_chunk_fits(nv, m, n_box, soc)) == \
        _parent_fits(nv, m, soc)


def test_fits_answers_are_the_parents_at_every_size():
    """The same over every (nv, m) whose footprint the register-row layout
    sets (d from ROW_MIN_D to ROW_MAX_D, and a margin each side) or that
    lies near the shared-memory cap (d >= 228), four SOC blocks."""
    sizes = [(nv, m) for nv in range(1, 256) for m in range(1, 257 - nv)
             if 60 <= nv + m <= 132 or nv + m >= 228]
    for nv, m in sizes:
        got = (admm_kernel.fused_solve_fits(nv, m, 0, (4,) * 4),
               admm_kernel.admm_chunk_fits(nv, m, 0, (4,) * 4))
        assert got == _parent_fits(nv, m, (4,) * 4), (nv, m)
