"""The registry's contracts (``analysis/contracts.py`` run_contracts): the
fast subset holds on the CPU, each contract catches its seeded violation,
every entry states a host-sync budget, and the faults the contracts found
in the port stay repaired."""

import numpy as np
import pytest
import torch

from tpu_aerial_transport_torch.analysis import contracts, entrypoints
from tpu_aerial_transport_torch.harness import cuda_graph

CPU = torch.device("cpu")


def test_fast_subset_holds_on_the_cpu():
    reports = {}
    findings = contracts.run_contracts(contracts.FAST_SUBSET, "cpu",
                                       reports=reports)
    assert findings == [], [f.render() for f in findings]
    assert set(reports) == set(contracts.FAST_SUBSET)
    for name, rep in reports.items():
        assert rep["syncs_total"] <= rep["budget"], (name, rep)
        assert rep["wide_ops"] == {} and not any(rep["rebuilds"].values())
    # The solves and the controller read their KKT inverse's error flag.
    assert reports["ops.socp:solve_socp"]["syncs"] == {
        "aten._linalg_check_errors": 1}


def test_every_entry_has_a_budget_with_a_reason():
    assert set(contracts.REGISTRY) == set(entrypoints.CONTRACT_ENTRYPOINTS)
    assert set(entrypoints.SYNC_BUDGETS) == set(contracts.REGISTRY)
    for name, row in entrypoints.SYNC_BUDGETS.items():
        assert set(row) <= {"budget", "card_only", "reason"}, name
        assert len(row["reason"]) >= 30, name
        budget, card_only = contracts.budget_of(contracts.REGISTRY[name])
        assert isinstance(budget, int) and budget >= 0, name
        assert isinstance(card_only, int) and card_only >= 0, name
        # A card-only term names the library call that makes it.
        assert ("card_only" in row) == ("cuSOLVER" in row["reason"]), name
    # A kernel-only entry may not read the card at all.
    for name in ("ops.admm_kernel:fused_solve_pallas",
                 "ops.admm_kernel:fused_solve_earlyexit_pallas",
                 "parallel.ring:consensus_exchange_pallas"):
        assert entrypoints.SYNC_BUDGETS[name] == {
            "budget": 0, "reason": entrypoints.SYNC_BUDGETS[name]["reason"]}


def test_chunk_tests_counts_the_early_exit_loop():
    """The budgets' count of a tolerance-chunked solve's host tests: once a
    full chunk, once more when there are full chunks, once for a
    remainder."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    args = contracts._fused_operands(CPU, early=True)
    K2, Minv, A, P, q, rho, lb, ub, shift, x, y, z, active = args
    for iters, every, tests in ((8, 3, 4), (9, 3, 4), (2, 5, 1), (6, 2, 4),
                                (10, 25, 1), (4, 2, 3)):
        watch = contracts.OpWatch("cpu")
        with watch:
            admm_kernel.fused_solve_lanes_reference(
                x, y, z, K2, Minv, A, P, q, rho, lb, ub, shift, active,
                nv=16, n_box=24, soc_dims=(4, 4), alpha=1.6, iters=iters,
                check_every=every, tol=1e-12)
        assert watch.syncs == {"aten._local_scalar_dense": tests}, (
            iters, every)


def test_card_only_syncs_are_held_apart_from_the_dispatched():
    """The dispatched count is held to its own budget on every device; the
    card's count may exceed it only by the card-only syncs (the resilient
    rollout's SVD inside cuSOLVER), so those cannot hide dispatched ones."""
    syncs = {"aten._linalg_check_errors": 3, "aten._local_scalar_dense": 8}
    budgets = (11, 8)
    assert contracts.sync_findings(syncs, budgets, None, {}) == []
    assert contracts.sync_findings(syncs, budgets, 19, {}) == []
    (msg,) = contracts.sync_findings(syncs, budgets, 20, {"a.py:1": 20})
    assert "9 beyond the 11 dispatched" in msg
    more = dict(syncs, **{"aten._local_scalar_dense": 9})
    (msg,) = contracts.sync_findings(more, budgets, None, {})
    assert "12 host syncs" in msg and "budget 11" in msg
    assert len(contracts.sync_findings(more, budgets, 20, {})) == 1
    assert contracts.sync_findings({}, (0, 0), 1, {}) != []
    assert "no entrypoints" in contracts.sync_findings({}, None, None,
                                                       {})[0]


# ----------------------------- seeded faults ----------------------------

def _contract(name, fn, make_args, **kw):
    return contracts.Contract(name=name, build=lambda dev: (fn, make_args),
                              **kw)


def _args():
    return (torch.arange(6, dtype=torch.float32).reshape(2, 3),)


@pytest.fixture
def budget(monkeypatch):
    def set_budget(name, value):
        monkeypatch.setitem(entrypoints.SYNC_BUDGETS, name,
                            {"budget": value, "reason": "seeded case"})
    return set_budget


def _rules(findings):
    return sorted(f.rule for f in findings)


class _PerCallCache:
    """A cache keyed on an object rebuilt every call (a config rebuilt per
    call, say): it grows on every call."""

    def __init__(self):
        self._graphs = {}

    def __call__(self, x):
        self._graphs[object()] = x
        return x * 2


def test_tc101_catches_a_static_rebuilt_per_call(budget):
    budget("seeded:tc101", 0)
    leaky = _PerCallCache()
    assert _rules(contracts.check_entry(
        _contract("seeded:tc101", leaky, _args), "cpu")) == ["TC101"]

    def capturing(x):  # a CUDA-graph capture on every call
        cuda_graph.PROCESS_CAPTURES["captures"] += 1
        return x * 2

    found = contracts.check_entry(
        _contract("seeded:tc101", capturing, _args), "cpu")
    assert _rules(found) == ["TC101"] and "captures" in found[0].message
    assert contracts.check_entry(
        _contract("seeded:tc101", lambda x: x * 2, _args), "cpu") == []


def test_tc102_names_the_float64_op(budget):
    budget("seeded:tc102", 0)
    found = contracts.check_entry(
        _contract("seeded:tc102", lambda x: (x.double() * 2).float(),
                  _args), "cpu")
    assert _rules(found) == ["TC102"]
    assert "aten._to_copy" in found[0].message
    assert "aten.mul" in found[0].message


def test_tc103_holds_syncs_to_the_budget(budget):
    def one_read(x):
        return x * float(x.sum())

    budget("seeded:tc103", 1)
    assert contracts.check_entry(
        _contract("seeded:tc103", one_read, _args), "cpu") == []

    def extra_item(x):  # one .item() beyond the budget
        return x * float(x.sum()) + x.max().item()

    found = contracts.check_entry(
        _contract("seeded:tc103", extra_item, _args), "cpu")
    assert _rules(found) == ["TC103"]
    assert "2 host syncs" in found[0].message
    # An entry with no budget at all is a finding.
    found = contracts.check_entry(
        _contract("seeded:no_budget", lambda x: x, _args), "cpu")
    assert _rules(found) == ["TC103"] and "no entrypoints" in found[
        0].message
    # Boolean-mask indexing and nonzero size their output on the host.
    budget("seeded:tc103", 1)
    found = contracts.check_entry(
        _contract("seeded:tc103", lambda x: (x[x > 2], torch.nonzero(x)),
                  _args), "cpu")
    assert _rules(found) == ["TC103"]
    assert "bool_mask_index" in found[0].message


def test_tc105_catches_a_copied_carry(budget, monkeypatch):
    budget("seeded:tc105", 0)
    monkeypatch.setitem(entrypoints.DONATION_CONTRACTS, "seeded:tc105", 1)

    def donated(x):
        x.mul_(2.0)
        return x

    assert contracts.check_entry(
        _contract("seeded:tc105", donated, _args), "cpu") == []
    found = contracts.check_entry(
        _contract("seeded:tc105", lambda x: x.clone() * 2.0, _args), "cpu")
    assert _rules(found) == ["TC105"]


def test_tc105_holds_the_donated_control_step(budget, monkeypatch):
    """The port's donated carry, ``jit_control_step(donate=True)``, hands
    back the state passed in: every leaf of the C-ADMM state shares its
    storage. ``donate=False`` returns new tensors, and TC105 says so."""
    from tpu_aerial_transport_torch.control import cadmm, centralized
    from tpu_aerial_transport_torch.tree import leaves

    params, col, _ = contracts._rqp_bits(CPU)
    cfg = cadmm.make_config(params, col.collision_radius,
                            col.max_deceleration, max_iter=2, inner_iters=4,
                            pad_operators=True, device=CPU)
    f_eq = centralized.equilibrium_forces(params)
    _, make_args = contracts._control_bits("cadmm", CPU)
    n_leaves = len(leaves(make_args()[0]))
    budget("seeded:tc105_step", 5)
    monkeypatch.setitem(entrypoints.DONATION_CONTRACTS, "seeded:tc105_step",
                        n_leaves)
    for donate, rules in ((True, []), (False, ["TC105"])):
        step = cadmm.jit_control_step(params, cfg, f_eq, donate=donate)
        rep = {}
        assert _rules(contracts.check_entry(
            _contract("seeded:tc105_step", step, make_args), "cpu",
            report=rep)) == rules, donate
        assert (rep["shared_outputs"] >= n_leaves) == donate


# ------------------------------- repairs --------------------------------

def test_single_point_bucketed_query_reads_nothing_on_the_host():
    """A single (0-d) query indexed the slab table with a 0-d tensor, which
    PyTorch reads on the host as a Python int: a sync per query."""
    from tpu_aerial_transport_torch.envs import forest as forest_mod
    from tpu_aerial_transport_torch.envs import spatial

    world = spatial.with_grid(forest_mod.make_forest(0, device="cpu"), 7.0)
    pts = torch.tensor([[28.0, 1.0, 2.0], [3.0, -4.0, 1.0]])
    watch = contracts.OpWatch("cpu")
    with watch:
        one = spatial.candidate_slab(world, pts[0])
    assert watch.syncs == {}
    both = spatial.candidate_slab(world, pts)
    assert torch.equal(one[0], both[0][0]) and torch.equal(one[1],
                                                           both[1][0])
    assert one[0].shape == both[0].shape[1:]


def test_rp_cadmm_reads_nothing_beyond_its_loop():
    """The RP consensus step read its rho back from a host tensor once a
    step; its budget is the loop's exit tests and the KKT check."""
    rep = {}
    assert contracts.check_entry(contracts.REGISTRY[
        "control.rp_cadmm:control"], "cpu", report=rep) == []
    assert rep["syncs"] == {"aten._linalg_check_errors": 1,
                            "aten._local_scalar_dense": 4}


@pytest.mark.parametrize("name", [
    "control.cadmm:control", "control.dd:control",
    "control.centralized:control", "control.rp_centralized:control",
    "control.pmrl_centralized:control"])
def test_control_steps_write_no_scalar_from_the_host(name):
    """The QP builders wrote Python scalars into single elements of card
    tensors (``e3[2] = 1.0``, ``soc[0, 11] = ...``): each a copy from the
    host and a synchronisation on the card (its set_sync_debug_mode count
    was 2-11x the budget). They fill_ now, the same values."""
    rep = {}
    assert contracts.check_entry(contracts.REGISTRY[name], "cpu",
                                 report=rep) == []
    assert "copy_from_host" not in rep["syncs"], rep["syncs"]


def test_sync_sites_name_the_port_frame():
    from tpu_aerial_transport_torch.tree import tree_map

    sites = {}
    show = contracts._sync_site_recorder(sites)
    msg = "called a synchronizing CUDA operation"
    show(msg, UserWarning, "harness.py", 7)
    show("an unrelated warning", UserWarning, "x.py", 1)
    tree_map(lambda t: show(msg, UserWarning, "torch.py", 3),
             torch.zeros(1))
    (line,) = [k for k in sites if k.startswith("tree.py:")]
    assert sites == {"outside:harness.py:7": 1, line: 1}


@pytest.mark.slow
def test_whole_registry_holds_on_the_cpu():
    reports = {}
    findings = contracts.run_contracts(device="cpu", reports=reports)
    assert findings == [], [f.render() for f in findings]
    skipped = {n for n, r in reports.items() if "skipped" in r}
    assert skipped == {n for n, c in contracts.REGISTRY.items()
                       if c.needs}
    for name, rep in reports.items():
        if name not in skipped:
            assert rep["syncs_total"] <= rep["budget"], name
    assert np.all([reports[n]["shared_outputs"] >= 6 for n in
                   entrypoints.DONATION_CONTRACTS])
