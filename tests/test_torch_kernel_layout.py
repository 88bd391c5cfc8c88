"""The port's kernel launch layouts, decided on the host: which body of the
whole-solve kernel each QP shape takes, its block and shared memory, and
the ring-sum kernel's shard cap. Nothing here needs a card: the wrapper
decides from the shapes alone, and these are the decisions it makes.

The expected shared-memory sizes are written out from the layout that
``csrc/fused_solve.cu`` documents (row strides of an odd number of
16-byte words), independently of the functions under test.
"""

import pytest
import torch

from tpu_aerial_transport_torch.control import cadmm, centralized, dd
from tpu_aerial_transport_torch.harness import setup
from tpu_aerial_transport_torch.ops import admm_kernel
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
