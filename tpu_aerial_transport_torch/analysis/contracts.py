"""Tier B of the port's analysis: the entry-point registry and the
contracts every registered entry point is held to.

:data:`REGISTRY` is the counterpart of the JAX package's
``analysis/contracts.py`` REGISTRY, with its 35 names. Each entry has a
builder of its callable and of fresh arguments at a tiny size. The AOT
bundles (``aot/``) iterate it: one bundle variant per entry and shape
signature.

A builder takes the device and returns ``(fn, make_args)``: ``fn`` the
callable with its statics closed over, ``make_args()`` a fresh argument
tuple on that device (two calls give independent trees). The port's
controllers and rollouts carry a leading scenario axis, so states are
stacked to 2 scenarios (the serving and scenario entries to their own
batch). Differences from the JAX registry, by what the port is:

- ``*_pallas`` entries launch the hand-written CUDA kernels and need the
  card (``needs="cuda"``); ``*_interpret`` entries run the kernels' plain
  versions (``ops.admm_kernel.*_reference``) on any device;
- the meshes put their shards on one card, so the ``parallel.mesh`` and
  ``parallel.ring`` entries need one device, not four;
- ``parallel.pods:pods_control_step`` needs a process group of two or more
  processes (``needs="process_group"``).

:func:`run_contracts` builds each entry that ``skip_reason(device)``
allows, calls it twice with fresh arguments, and holds the second call to
the contracts below, in their torch meaning (the JAX package's TC101 to
TC106 check a jitted program's lowering; eager PyTorch has none):

- **TC101 no rebuild** (JAX: no retrace): the second call grows neither the
  process's CUDA-graph captures (``harness/cuda_graph.py
  PROCESS_CAPTURES``), nor its kernel builds (``ops/_build.py
  nvcc_builds()``), nor a per-shape cache the entry's callable holds (a
  ``GraphedFn``'s graphs, a serving family's templates: the attributes in
  :data:`CACHE_ATTRS`). Growth means something keyed on a per-call object
  is rebuilt every call.
- **TC102 no float64**: a ``TorchDispatchMode`` sees every op of the
  call; an op with a float64 or complex128 output is a finding that names
  it.
- **TC103 host syncs within budget** (JAX: no host callback): in eager
  PyTorch the host round trip is the synchronisation. The same mode counts
  the ops that read a device value on the host (:data:`SYNC_OPS`, copies
  from the card to the host, boolean-mask indexing) and holds the count to
  the entry's ``entrypoints.SYNC_BUDGETS`` budget; an entry with no budget
  is a finding. On the card the call also runs under
  ``torch.cuda.set_sync_debug_mode("warn")``: the warnings, the card's own
  count, may exceed the dispatched count only by the entry's
  ``card_only`` syncs, those a library call makes inside itself (an SVD
  in cuSOLVER).
- **TC104 has no counterpart**: the TPU's (8, 128) sublane tile means
  nothing to the port's float32 CUDA-core kernels, whose layouts are
  decided on the host and held by ``tests/test_torch_kernel_layout.py``.
- **TC105 donation**: for each entry of ``entrypoints.DONATION_CONTRACTS``,
  at least that many output tensors share storage
  (``untyped_storage().data_ptr()``) with an argument tensor. The table is
  empty: an eager call returns new tensors, and the port's one donated
  carry, ``jit_control_step(donate=True)``, is not a registry entry.
- **TC106's counterpart is the card run itself**: ``chip_smoke.py`` runs
  every registered entry, the ``needs="cuda"`` ones included, on the card
  (``run_contracts(device="cuda")``). Tier-1 has none: its host has no
  ``nvcc``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

NEEDS = ("", "cuda", "process_group")


@dataclasses.dataclass(frozen=True)
class Contract:
    """One registered entry point. ``build(device)`` returns ``(fn,
    make_args)``; ``needs`` names what the host must have to build it."""

    name: str
    build: Callable[[object], tuple[Callable, Callable[[], tuple]]]
    needs: str = ""

    def skip_reason(self, device) -> str:
        """Why this entry cannot be built on ``device`` here ("" when it
        can)."""
        if self.needs == "cuda" and torch.device(device).type != "cuda":
            return ("needs a CUDA device: it launches a hand-written kernel "
                    "(its plain version is the *_interpret twin)")
        if self.needs == "process_group":
            from tpu_aerial_transport_torch.parallel import pods

            if int(os.environ.get(pods.NUM_PROCESSES_ENV) or 0) < 2:
                return ("needs a process group of two or more processes "
                        "(TAT_PODS_* as tools/pods_local.py exports them)")
        return ""


REGISTRY: dict[str, Contract] = {}


def _register(name: str, **kw):
    if kw.get("needs", "") not in NEEDS:
        raise ValueError(kw)

    def deco(build):
        REGISTRY[name] = Contract(name=name, build=build, **kw)
        return build

    return deco


# ----------------------------------------------------------------------
# Argument builders.
# ----------------------------------------------------------------------

S = 2  # scenarios of the batched entries' arguments.


def _stack(tree, n=S):
    from tpu_aerial_transport_torch.harness.rollout import stack_scenarios

    return stack_scenarios(tree, n)


def _acc(device):
    z = torch.zeros(3, dtype=torch.float32, device=device)
    return (z, z.clone())


def _rqp_bits(device, n=4):
    from tpu_aerial_transport_torch.harness import setup

    return setup.rqp_setup(n, device=device)


def _states(device, n=4):
    return _stack(_rqp_bits(device, n)[2])


def _control_bits(mod_name: str, device, forest=None, **cfg_kw):
    """C-ADMM or DD at n = 4 (max_iter 2, inner 4, padded operators):
    ``(fn, make_args)`` of one batched control step."""
    from tpu_aerial_transport_torch.control import cadmm, centralized, dd

    mod = cadmm if mod_name == "cadmm" else dd
    params, col, _ = _rqp_bits(device)
    kw = dict(max_iter=2, inner_iters=4, pad_operators=True, device=device)
    kw.update(cfg_kw)
    cfg = mod.make_config(params, col.collision_radius, col.max_deceleration,
                          **kw)
    f_eq = centralized.equilibrium_forces(params)
    plan = (cadmm.make_plan(params, cfg) if mod is cadmm
            else dd.make_dd_plan(params, cfg))
    init = cadmm.init_cadmm_state if mod is cadmm else dd.init_dd_state

    def fn(cs, s, a):
        return mod.control(params, cfg, f_eq, cs, s, a, forest, plan=plan)

    def make_args():
        return (_stack(init(params, cfg, f_eq)), _states(device),
                _acc(device))

    return fn, make_args


@_register("control.centralized:control")
def _build_centralized(device):
    from tpu_aerial_transport_torch.control import centralized

    params, col, _ = _rqp_bits(device)
    cfg = centralized.make_config(params, col.collision_radius,
                                  col.max_deceleration, solver_iters=10)
    f_eq = centralized.equilibrium_forces(params)

    def fn(cs, s, a):
        return centralized.control(params, cfg, f_eq, cs, s, a)

    def make_args():
        return (_stack(centralized.init_ctrl_state(params, cfg, f_eq)),
                _states(device), _acc(device))

    return fn, make_args


@_register("control.cadmm:control")
def _build_cadmm(device):
    return _control_bits("cadmm", device)


@_register("control.cadmm:control_forest")
def _build_cadmm_forest(device):
    from tpu_aerial_transport_torch.envs import forest as forest_mod

    return _control_bits("cadmm", device,
                         forest=forest_mod.make_forest(0, device=device))


def _env_query_bits(env_query: str, device):
    """The environment query (``envs.forest.collision_cbf_rows``) on the
    seed-0 200-slot world; the bucketed twin's grid is rebuilt by each
    ``make_args`` call."""
    from tpu_aerial_transport_torch.envs import forest as forest_mod
    from tpu_aerial_transport_torch.envs import spatial

    vision_radius = 6.0

    def fn(forest, xl, vl):
        return forest_mod.collision_cbf_rows(
            forest, xl, vl, vision_radius - 5.0, 2.0, vision_radius,
            0.1, 1.5, 10, env_query=env_query)

    def make_args():
        forest = forest_mod.make_forest(0, device=device)
        if env_query == "bucketed":
            forest = spatial.with_grid(forest,
                                       vision_radius + forest.bark_radius)
        return (forest,
                torch.tensor([28.0, 1.0, 2.0], device=device),
                torch.tensor([0.5, 0.2, 0.0], device=device))

    return fn, make_args


@_register("envs.spatial:env_query_bucketed")
def _build_env_query_bucketed(device):
    return _env_query_bits("bucketed", device)


@_register("envs.spatial:env_query_dense")
def _build_env_query_dense(device):
    return _env_query_bits("dense", device)


@_register("control.dd:control")
def _build_dd(device):
    return _control_bits("dd", device)


@_register("control.rp_cadmm:control")
def _build_rp_cadmm(device):
    from tpu_aerial_transport_torch.control import rp_cadmm, rp_centralized
    from tpu_aerial_transport_torch.harness import setup

    params, _, _ = setup.rp_setup(3, device=device)
    cfg = rp_cadmm.make_config(params, max_iter=2, inner_iters=4)
    f_eq = rp_centralized.equilibrium_forces(params)

    def fn(cs, s, a):
        return rp_cadmm.control(params, cfg, f_eq, cs, s, a)

    def make_args():
        return (_stack(rp_cadmm.init_state(params, cfg, f_eq)),
                _stack(setup.rp_setup(3, device=device)[2]), _acc(device))

    return fn, make_args


@_register("control.rp_centralized:control")
def _build_rp_centralized(device):
    from tpu_aerial_transport_torch.control import rp_centralized
    from tpu_aerial_transport_torch.harness import setup

    params, _, _ = setup.rp_setup(3, device=device)
    cfg = rp_centralized.make_config(params, solver_iters=10)
    f_eq = rp_centralized.equilibrium_forces(params)

    def fn(cs, s, a):
        return rp_centralized.control(params, cfg, f_eq, cs, s, a)

    def make_args():
        return (_stack(rp_centralized.init_ctrl_state(params, cfg)),
                _stack(setup.rp_setup(3, device=device)[2]), _acc(device))

    return fn, make_args


@_register("control.pmrl_centralized:control")
def _build_pmrl(device):
    from tpu_aerial_transport_torch.control import pmrl_centralized
    from tpu_aerial_transport_torch.harness import setup

    params, _, _ = setup.pmrl_setup(3, device=device)
    cfg = pmrl_centralized.make_config(params, solver_iters=10)

    def fn(cs, s, a):
        return pmrl_centralized.control(params, cfg, cs, s, a)

    def make_args():
        states = _stack(setup.pmrl_setup(3, device=device)[2])
        return (pmrl_centralized.init_ctrl_state(params, cfg, states),
                states, _acc(device))

    return fn, make_args


def _socp_problem(device, nv=8, n_box=6, soc=(4,), batch=None):
    """The JAX registry's seeded conic QP (``default_rng(0)``), with a
    leading batch of ``batch`` copies when given."""
    rng = np.random.default_rng(0)
    L = rng.standard_normal((nv, nv))
    m = n_box + sum(soc)
    arrays = (L @ L.T + np.eye(nv), rng.standard_normal(nv),
              rng.standard_normal((m, nv)) * 0.5,
              rng.uniform(-2.0, -0.5, n_box), rng.uniform(0.5, 2.0, n_box))
    out = tuple(torch.as_tensor(a, dtype=torch.float32, device=device)
                for a in arrays)
    if batch is not None:
        out = tuple(t.expand((batch,) + t.shape).clone() for t in out)
    return out


@_register("ops.socp:solve_socp")
def _build_socp(device):
    from tpu_aerial_transport_torch.ops import socp

    def fn(P, q, A, lb, ub):
        return socp.solve_socp(P, q, A, lb, ub, n_box=6, soc_dims=(4,),
                               iters=20, fused="scan")

    return fn, lambda: _socp_problem(device)


@_register("ops.socp:solve_socp_padded")
def _build_socp_padded(device):
    from tpu_aerial_transport_torch.ops import socp

    def fn(P, q, A, lb, ub):
        return socp.solve_socp_padded(P, q, A, lb, ub, n_box=6,
                                      soc_dims=(4,), iters=20, fused="scan")

    return fn, lambda: _socp_problem(device)


def _chunk_operands(device, B=2, nv=8, n_box=6, soc_dims=(4,)):
    """Seeded operands of the chunk kernel (``admm_chunk_lanes``)."""
    rng = np.random.default_rng(0)
    m = n_box + sum(soc_dims)
    d = nv + m

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return (t(np.zeros((B, nv))), t(np.zeros((B, m))), t(np.zeros((B, m))),
            t(rng.standard_normal((B, d, d)) * 0.1),
            t(rng.standard_normal((B, d))), t(np.ones((B, m))),
            t(-np.ones((B, n_box))), t(np.ones((B, n_box))),
            t(np.zeros((B, m))))


@_register("ops.admm_kernel:solve_socp_interpret")
def _build_socp_interpret(device):
    """The chunk kernel's plain version: 8 iterations over 2 lanes."""
    from tpu_aerial_transport_torch.ops import admm_kernel

    def fn(*ops):
        return admm_kernel.admm_chunk_lanes_reference(
            *ops, nv=8, n_box=6, soc_dims=(4,), iters=8, alpha=1.6)

    return fn, lambda: _chunk_operands(device)


def _fused_operands(device, early: bool):
    """The JAX registry's whole-solve kernel operands at the C-ADMM padded
    dims (B 8, nv 16, m 32, n_box 24, SOC (4, 4)), kernel order ``(K2,
    Minv, A, P, q, rho, lb, ub, shift, x, y, z[, active])``."""
    B, nv, m, n_box = 8, 16, 32, 24
    d = nv + m
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    out = (t(rng.standard_normal((B, d, d)) * 0.1),
           t(rng.standard_normal((B, nv, nv)) * 0.1),
           t(rng.standard_normal((B, m, nv)) * 0.1),
           t(rng.standard_normal((B, nv, nv)) * 0.1),
           t(rng.standard_normal((B, nv))), t(np.ones((B, m))),
           t(-np.ones((B, n_box))), t(np.ones((B, n_box))),
           t(np.zeros((B, m))), t(np.zeros((B, nv))), t(np.zeros((B, m))),
           t(np.zeros((B, m))))
    return out + ((t(np.ones(B), torch.bool),) if early else ())


def _fused_build(device, early: bool, plain: bool):
    from tpu_aerial_transport_torch.ops import admm_kernel

    solve = (admm_kernel.fused_solve_lanes_reference if plain
             else admm_kernel.fused_solve_lanes)
    kw = dict(nv=16, n_box=24, soc_dims=(4, 4), alpha=1.6)
    kw.update(dict(iters=8, check_every=3, tol=1e-3) if early
              else dict(iters=4))

    def fn(K2, Minv, A, P, q, rho, lb, ub, shift, x, y, z, *active):
        return solve(x, y, z, K2, Minv, A, P, q, rho, lb, ub, shift,
                     *active, **kw)

    return fn, lambda: _fused_operands(device, early)


@_register("ops.admm_kernel:fused_solve_interpret")
def _build_fused_solve_interpret(device):
    return _fused_build(device, early=False, plain=True)


@_register("ops.admm_kernel:fused_solve_pallas", needs="cuda")
def _build_fused_solve_pallas(device):
    return _fused_build(device, early=False, plain=False)


@_register("ops.admm_kernel:fused_solve_earlyexit_interpret")
def _build_fused_solve_earlyexit_interpret(device):
    return _fused_build(device, early=True, plain=True)


@_register("ops.admm_kernel:fused_solve_earlyexit_pallas", needs="cuda")
def _build_fused_solve_earlyexit_pallas(device):
    return _fused_build(device, early=True, plain=False)


def _adaptive_cfg_kw():
    # inner_check_every=2 over inner_iters=4: the gated chunk loop and its
    # remainder inside a consensus step.
    return dict(effort="adaptive", inner_check_every=2)


@_register("control.cadmm:control_adaptive")
def _build_cadmm_adaptive(device):
    return _control_bits("cadmm", device, **_adaptive_cfg_kw())


@_register("control.dd:control_adaptive")
def _build_dd_adaptive(device):
    return _control_bits("dd", device, **_adaptive_cfg_kw())


def _rollout_bits(device):
    """The centralized controller at n = 4 (10 solver iterations) with the
    PD low level: ``(params, cfg, f_eq, llc, hl)``."""
    from tpu_aerial_transport_torch.control import centralized, lowlevel

    params, col, _ = _rqp_bits(device)
    cfg = centralized.make_config(params, col.collision_radius,
                                  col.max_deceleration, solver_iters=10)
    f_eq = centralized.equilibrium_forces(params)
    llc = lowlevel.make_lowlevel_controller("pd", params)

    def hl(cs, s, a):
        return centralized.control(params, cfg, f_eq, cs, s, a)

    return params, cfg, f_eq, llc, hl


def _rollout_args(device, params, cfg, f_eq, n=S):
    from tpu_aerial_transport_torch.control import centralized

    return (_stack(_rqp_bits(device)[2], n),
            _stack(centralized.init_ctrl_state(params, cfg, f_eq), n))


@_register("harness.rollout:rollout")
def _build_rollout(device):
    from tpu_aerial_transport_torch.harness import rollout as h_rollout

    params, cfg, f_eq, llc, hl = _rollout_bits(device)

    def fn(s0, cs0):
        return h_rollout.rollout(hl, llc.control, params, s0, cs0,
                                 n_hl_steps=2, hl_rel_freq=2)

    return fn, lambda: _rollout_args(device, params, cfg, f_eq)


@_register("harness.rollout:rollout_donated")
def _build_rollout_donated(device):
    """``jit_rollout`` (the JAX entry's donated jit): the substeps replayed
    from a CUDA graph on the card."""
    from tpu_aerial_transport_torch.harness import rollout as h_rollout

    params, cfg, f_eq, llc, hl = _rollout_bits(device)
    fn = h_rollout.jit_rollout(hl, llc.control, params, n_hl_steps=2,
                               hl_rel_freq=2)
    return fn, lambda: _rollout_args(device, params, cfg, f_eq)


@_register("harness.rollout:chunked_rollout")
def _build_chunked_rollout(device):
    """The chunked rollout's chunk ``(carry, i0)``; successive
    ``make_args`` calls pass successive chunk offsets (every chunk is one
    program)."""
    from tpu_aerial_transport_torch.harness import rollout as h_rollout

    params, cfg, f_eq, llc, hl = _rollout_bits(device)
    x0 = _rqp_bits(device)[2].xl

    def acc_des_fn(state, t):
        del t
        dvl = -1.0 * state.vl - 1.0 * (state.xl - x0)
        return (dvl, torch.zeros_like(dvl)), x0, torch.zeros_like(x0)

    run = h_rollout.make_chunked_rollout(
        hl, llc.control, params, n_hl_steps=4, n_chunks=2, hl_rel_freq=2,
        acc_des_fn=acc_des_fn)
    chunk_idx = itertools.count()

    def make_args():
        c = next(chunk_idx) % run.n_chunks
        carry = run.init_carry(*_rollout_args(device, params, cfg, f_eq))
        return (carry, h_rollout.chunk_index_offset(c, run.chunk_len))

    return run.chunk_jit, make_args


@_register("harness.rollout:rollout_telemetry")
def _build_rollout_telemetry(device):
    from tpu_aerial_transport_torch.harness import rollout as h_rollout
    from tpu_aerial_transport_torch.obs import telemetry as telemetry_mod

    params, cfg, f_eq, llc, hl = _rollout_bits(device)
    tcfg = telemetry_mod.TelemetryConfig()

    def fn(s0, cs0):
        return h_rollout.rollout(hl, llc.control, params, s0, cs0,
                                 n_hl_steps=2, hl_rel_freq=2, telemetry=tcfg)

    return fn, lambda: _rollout_args(device, params, cfg, f_eq)


def _resilient_bits(device, track_agent_stats=False):
    """Health-aware C-ADMM at n = 4 with agent 1 failing at step 1 and a
    30 % message drop: ``(params, cfg, f_eq, hl, llc, sched)``."""
    from tpu_aerial_transport_torch.control import cadmm, centralized
    from tpu_aerial_transport_torch.control import lowlevel
    from tpu_aerial_transport_torch.resilience import faults as faults_mod
    from tpu_aerial_transport_torch.resilience import prng
    from tpu_aerial_transport_torch.resilience import rollout as r_rollout

    params, col, _ = _rqp_bits(device)
    cfg = cadmm.make_config(
        params, col.collision_radius, col.max_deceleration, max_iter=2,
        inner_iters=4, pad_operators=True, device=device,
        track_agent_stats=track_agent_stats)
    f_eq = centralized.equilibrium_forces(params)
    sched = faults_mod.make_schedule(
        4, t_fail={1: 1}, drop_rate=0.3, key=prng.prng_key(0, device=device),
        device=device)
    hl = r_rollout.make_cadmm_hl_step(params, cfg)
    llc = lowlevel.make_lowlevel_controller("pd", params)
    return params, cfg, f_eq, hl, llc, sched


def _resilient_args(device, params, cfg, f_eq):
    from tpu_aerial_transport_torch.control import cadmm

    return (_states(device), _stack(cadmm.init_cadmm_state(params, cfg,
                                                           f_eq)))


@_register("resilience.rollout:resilient_rollout")
def _build_resilient(device):
    from tpu_aerial_transport_torch.resilience import rollout as r_rollout

    params, cfg, f_eq, hl, llc, sched = _resilient_bits(device)

    def fn(s0, cs0):
        return r_rollout.resilient_rollout(
            hl, llc.control, params, s0, cs0, n_hl_steps=2, hl_rel_freq=2,
            faults=sched)

    return fn, lambda: _resilient_args(device, params, cfg, f_eq)


@_register("resilience.rollout:resilient_rollout_donated")
def _build_resilient_donated(device):
    from tpu_aerial_transport_torch.resilience import rollout as r_rollout

    params, cfg, f_eq, hl, llc, sched = _resilient_bits(device)
    fn = r_rollout.jit_resilient_rollout(
        hl, llc.control, params, n_hl_steps=2, hl_rel_freq=2, faults=sched)
    return fn, lambda: _resilient_args(device, params, cfg, f_eq)


@_register("resilience.rollout:resilient_rollout_telemetry")
def _build_resilient_telemetry(device):
    from tpu_aerial_transport_torch.obs import telemetry as telemetry_mod
    from tpu_aerial_transport_torch.resilience import rollout as r_rollout

    params, cfg, f_eq, hl, llc, sched = _resilient_bits(
        device, track_agent_stats=True)
    tcfg = telemetry_mod.TelemetryConfig(track_agents=True)

    def fn(s0, cs0):
        return r_rollout.resilient_rollout(
            hl, llc.control, params, s0, cs0, n_hl_steps=2, hl_rel_freq=2,
            faults=sched, telemetry=tcfg)

    return fn, lambda: _resilient_args(device, params, cfg, f_eq)


def _sharded_cadmm(device, **cfg_kw):
    """Agent-sharded C-ADMM over 4 shards (n = 4) on one device."""
    from tpu_aerial_transport_torch.control import cadmm, centralized
    from tpu_aerial_transport_torch.parallel import mesh as mesh_mod

    params, col, _ = _rqp_bits(device)
    cfg = cadmm.make_config(
        params, col.collision_radius, col.max_deceleration, max_iter=2,
        inner_iters=4, pad_operators=True, device=device, **cfg_kw)
    f_eq = centralized.equilibrium_forces(params)
    step = mesh_mod.cadmm_control_sharded(params, cfg, f_eq,
                                          mesh_mod.make_mesh({"agent": 4}))

    def make_args():
        return (_stack(cadmm.init_cadmm_state(params, cfg, f_eq)),
                _states(device), _acc(device))

    return step, make_args


@_register("parallel.mesh:cadmm_control_sharded")
def _build_mesh_cadmm(device):
    return _sharded_cadmm(device, consensus_impl="allreduce")


@_register("parallel.mesh:cadmm_control_sharded_ring")
def _build_mesh_cadmm_ring(device):
    return _sharded_cadmm(device, consensus_impl="ring")


def _ring_args(device, d=4):
    rng = np.random.default_rng(0)
    return (torch.as_tensor(rng.standard_normal((d, 6, 3)),
                            dtype=torch.float32, device=device),)


@_register("parallel.ring:consensus_exchange")
def _build_ring_exchange(device):
    """The exchange's three faces (sum, max, gather) on the ring over 4
    stacked shards, with a payload of 18 elements a shard."""
    from tpu_aerial_transport_torch.parallel import ring as ring_mod

    d = 4

    def fn(x):
        s = ring_mod.consensus_exchange(x, axis_size=d, op="sum",
                                        impl="ring")
        mx = ring_mod.consensus_exchange(x.amax(dim=(1, 2)), axis_size=d,
                                         op="max", impl="ring")
        g = ring_mod.consensus_gather(x, axis_size=d, impl="ring")
        return s, mx, g

    return fn, lambda: _ring_args(device, d)


@_register("parallel.ring:consensus_exchange_pallas", needs="cuda")
def _build_ring_exchange_pallas(device):
    """The ring-sum kernel (``csrc/ring_sum.cu``) over 4 stacked shards."""
    from tpu_aerial_transport_torch.parallel import ring as ring_mod

    def fn(x):
        return ring_mod.consensus_exchange(x, axis_size=4, op="sum",
                                           impl="pallas_ring")

    return fn, lambda: _ring_args(device)


@_register("parallel.pods:pods_control_step", needs="process_group")
def _build_pods_step(device):
    """The 2-D (scenario, agent) pods-mesh C-ADMM step over the process
    group the ``TAT_PODS_*`` variables describe: 2 agent shards, a
    scenario shard a process, 4 scenarios a process."""
    from tpu_aerial_transport_torch.control import cadmm, centralized
    from tpu_aerial_transport_torch.parallel import pods

    group = pods.initialize()
    params, col, _ = _rqp_bits(device)
    cfg = cadmm.make_config(
        params, col.collision_radius, col.max_deceleration, max_iter=2,
        inner_iters=4, pad_operators=True, device=device)
    f_eq = centralized.equilibrium_forces(params)
    world = 1 if group is None else group.size()
    mesh = pods.make_pods_mesh(pods.PodsSpec(world, 2, world), group,
                               device=device)
    step = pods.pods_control_step(params, cfg, f_eq, mesh, None, "cadmm")

    def make_args():
        return (_stack(cadmm.init_cadmm_state(params, cfg, f_eq), 4),
                _stack(_rqp_bits(device)[2], 4), _acc(device))

    return step, make_args


@_register("parallel.mesh:scenario_rollout")
def _build_mesh_scenarios(device):
    """The batched rollout under the scenario tier (``run.batched_jit``,
    the JAX contract's), 2 scenarios over a 2-shard scenario mesh."""
    from tpu_aerial_transport_torch.harness import rollout as h_rollout
    from tpu_aerial_transport_torch.parallel import mesh as mesh_mod

    params, cfg, f_eq, llc, hl = _rollout_bits(device)

    def rollout_fn(s0, cs0):
        return h_rollout.rollout(hl, llc.control, params, s0, cs0,
                                 n_hl_steps=2, hl_rel_freq=2)

    run = mesh_mod.scenario_rollout(rollout_fn,
                                    mesh_mod.make_mesh({"scenario": 2}))
    return run.batched_jit, lambda: _rollout_args(device, params, cfg, f_eq)


def _serving_chunk_build(canonical: str, device):
    """The canonical family's batched chunk at the smallest shape bucket
    (``serving/batcher.py``, the factory the server uses, so bundle
    signatures match served batches by construction); ``make_args``
    cycles chunk offsets."""
    from tpu_aerial_transport_torch.harness import rollout as h_rollout
    from tpu_aerial_transport_torch.serving import batcher

    fam = batcher.make_family(canonical, device=device)
    bucket = batcher.DEFAULT_BUCKETS[0]
    chunk_idx = itertools.count()

    def make_args():
        c = next(chunk_idx) % 4
        return (_copy(fam.batched_template(bucket)),
                h_rollout.chunk_index_offset(c, fam.chunk_len))

    return fam.batched_fn, make_args


def _copy(tree):
    from tpu_aerial_transport_torch.tree import tree_map

    return tree_map(lambda t: t.clone(), tree)


@_register("serving.batcher:serving_chunk")
def _build_serving_chunk(device):
    return _serving_chunk_build("cadmm4", device)


@_register("serving.batcher:serving_chunk_centralized")
def _build_serving_chunk_centralized(device):
    return _serving_chunk_build("centralized4", device)


def _lane_surgery_build(canonical: str, device):
    """The device boundary lane surgery (``serving/lanes.py``) on the
    family's batched carry at the smallest shape bucket: one late-join
    lane and one filler reset a call."""
    from tpu_aerial_transport_torch.serving import batcher
    from tpu_aerial_transport_torch.serving import lanes
    from tpu_aerial_transport_torch.serving import queue as squeue

    fam = batcher.make_family(canonical, device=device)
    bucket = batcher.DEFAULT_BUCKETS[0]

    def make_args():
        carry = _copy(fam.batched_template(bucket))
        req = squeue.ScenarioRequest(
            family=canonical, horizon=fam.chunk_len,
            x0=(0.1, -0.2, 0.3), v0=(0.01, 0.02, -0.03))
        template_b = _copy(fam.batched_template(bucket))
        return (carry,) + lanes.make_surgery_args(
            template_b, [(0, req)], [1], bucket)

    return lanes.lane_surgery, make_args


@_register("serving.lanes:lane_surgery")
def _build_lane_surgery(device):
    return _lane_surgery_build("cadmm4", device)


@_register("serving.lanes:lane_surgery_centralized")
def _build_lane_surgery_centralized(device):
    return _lane_surgery_build("centralized4", device)


# ----------------------------------------------------------------------
# Checks.
# ----------------------------------------------------------------------

# Run by tier-1 on every commit (tests/test_torch_contracts.py): the solver
# core, one consensus controller and one rollout, a few seconds on the CPU.
# The whole registry runs under -m slow, from ``tools/lint.py --contracts``
# and on the card from chip_smoke.py.
FAST_SUBSET = (
    "ops.socp:solve_socp",
    "ops.socp:solve_socp_padded",
    "control.cadmm:control",
    "harness.rollout:rollout",
)

# Ops that read a value of their input's device on the host (TC103): a
# scalar read (``.item()``, ``bool(t)``), the error check behind
# ``torch.linalg.inv``, and the ops that size their output on the host.
SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten._linalg_check_errors",
    "aten.nonzero", "aten.masked_select", "aten._unique", "aten._unique2",
    "aten.unique_dim", "aten.unique_consecutive",
})
_INDEX_OPS = frozenset({"aten.index", "aten.index_put", "aten.index_put_",
                        "aten._index_put_impl_"})
# The dtypes TC102 looks for.
_WIDE = (torch.float64, torch.complex128)  # torchlint: disable=TL004
# Attributes of the objects an entry's callable reaches that hold a
# per-shape cache (TC101): a GraphedFn's graphs, a serving family's
# batched templates.
CACHE_ATTRS = ("_graphs", "_templates_b", "_templates_dev")


def _tensors(obj) -> list:
    """The tensors of a tree of tuples, lists, dicts and dataclasses."""
    out = []
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(x[k] for k in sorted(x, key=str, reverse=True))
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name)
                         for f in reversed(dataclasses.fields(x)))
    return out


def sync_kind(func, args, kwargs, device_type: str = "cpu") -> str | None:
    """The name TC103 counts ``func(*args, **kwargs)`` under, or None when
    the op does not make the host wait for the call's device
    (``device_type``): a read of a device value on the host, or a copy
    between host and card (PyTorch synchronises the stream after a
    blocking one, either way). On the CPU every such read counts, as the
    stand-in for the card's synchronisation; on the card a read of a host
    tensor does not."""
    name = str(func.overloadpacket)
    if name in SYNC_OPS:
        first = args[0] if args else None
        if (isinstance(first, torch.Tensor)
                and first.device.type == device_type):
            return name
        return None
    if name == "aten._to_copy":
        dst = kwargs.get("device")
        src = args[0].device.type
        if (dst is not None and torch.device(dst).type != src
                and not kwargs.get("non_blocking", False)):
            return "copy_to_host" if src != "cpu" else "copy_from_host"
    elif name == "aten.copy_":
        dst, src = args[0].device.type, args[1].device.type
        blocking = not (len(args) > 2 and args[2])
        if dst != src and blocking:
            return "copy_to_host" if src != "cpu" else "copy_from_host"
        if device_type == "cpu" and args[0].dim() == 0 and args[1].dim() == 0:
            # A Python scalar written into one element: on the card a copy
            # from the host.
            return "copy_from_host"
    elif name == "aten.lift_fresh":
        # torch.tensor(host data, device=...) on the call's device.
        if device_type != "cpu" and args[0].device.type == device_type:
            return "copy_from_host"
    elif name in _INDEX_OPS:
        idx = args[1] if len(args) > 1 else ()
        if any(isinstance(t, torch.Tensor)
               and t.dtype in (torch.bool, torch.uint8) for t in idx):
            return "bool_mask_index"
    return None


class OpWatch(TorchDispatchMode):
    """Counts, over the ops run inside it (``with OpWatch(device_type):``),
    the host synchronisations (:func:`sync_kind`) and the ops with a
    float64 or complex128 output."""

    def __init__(self, device_type: str = "cpu"):
        super().__init__()
        self.device_type = device_type
        self.syncs: dict[str, int] = {}
        self.wide: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = sync_kind(func, args, kwargs, self.device_type)
        if kind is not None:
            self.syncs[kind] = self.syncs.get(kind, 0) + 1
        out = func(*args, **kwargs)
        if any(t.dtype in _WIDE for t in _tensors(out)):
            op = str(func)
            self.wide[op] = self.wide.get(op, 0) + 1
        return out


def _cache_sizes(root, depth: int = 4) -> int:
    """The entries of every per-shape cache (:data:`CACHE_ATTRS`) reachable
    from ``root`` through closures, function attributes, bound methods,
    instance attributes and tuples, ``depth`` hops deep."""
    import types

    seen: set[int] = set()
    total = 0
    frontier = [root]
    for _ in range(depth):
        nxt = []
        for obj in frontier:
            if id(obj) in seen or isinstance(obj, (torch.Tensor, type,
                                                   types.ModuleType)):
                continue
            seen.add(id(obj))
            if isinstance(obj, (tuple, list)):
                nxt.extend(obj)
                continue
            if isinstance(obj, types.MethodType):
                nxt.extend((obj.__func__, obj.__self__))
                continue
            if isinstance(obj, types.FunctionType):
                nxt.extend(c.cell_contents for c in obj.__closure__ or ()
                           if _cell_full(c))
            attrs = getattr(obj, "__dict__", None)
            if not isinstance(attrs, dict):
                continue
            for attr in CACHE_ATTRS:
                if isinstance(attrs.get(attr), dict):
                    total += len(attrs[attr])
            nxt.extend(attrs.values())
        frontier = nxt
    return total


def _cell_full(cell) -> bool:
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


def _launches() -> dict[str, int]:
    """Every kernel launch counter of the port, by kernel name."""
    from tpu_aerial_transport_torch.ops import admm_kernel
    from tpu_aerial_transport_torch.parallel import ring

    out = dict(admm_kernel.KERNEL_LAUNCHES)
    out.update(admm_kernel.CHUNK_LAUNCHES)
    out["ring_sum_kernel"] = ring.LAUNCHES["ring_sum"]
    return out


def _rebuild_counters(fn) -> dict[str, int]:
    from tpu_aerial_transport_torch.harness import cuda_graph
    from tpu_aerial_transport_torch.ops import _build

    return {"captures": cuda_graph.PROCESS_CAPTURES["captures"],
            "builds": _build.nvcc_builds(), "cache": _cache_sizes(fn)}


def budget_of(contract: Contract) -> tuple[int, int] | None:
    """The entry's TC103 budgets, ``(dispatched, card_only)``, or None when
    ``entrypoints.SYNC_BUDGETS`` has no entry for it."""
    from tpu_aerial_transport_torch.analysis import entrypoints

    row = entrypoints.SYNC_BUDGETS.get(contract.name)
    if row is None:
        return None
    return row["budget"], row.get("card_only", 0)


def sync_findings(syncs: dict, budgets: tuple[int, int] | None,
                  card_warnings: int | None, sites: dict) -> list[str]:
    """TC103's messages for one call: ``syncs`` the dispatched host syncs
    by kind, ``budgets`` the entry's ``(dispatched, card_only)``
    (:func:`budget_of`), ``card_warnings`` the card's own count
    (``set_sync_debug_mode``; None off the card) at ``sites``. The
    dispatched count is held to its budget; on the card the warnings may
    exceed it by the card-only syncs and no more."""
    if budgets is None:
        return ["no entrypoints.SYNC_BUDGETS entry: every registered entry "
                "states its host-sync budget"]
    budget, card_only = budgets
    n_sync = sum(syncs.values())
    out = []
    if n_sync > budget:
        out.append(f"{n_sync} host syncs {dict(syncs)} over the budget "
                   f"{budget}")
    if card_warnings is not None and card_warnings - n_sync > card_only:
        out.append(f"{card_warnings} synchronizing-operation warnings of "
                   f"torch.cuda.set_sync_debug_mode at {sites}, "
                   f"{card_warnings - n_sync} beyond the {n_sync} "
                   f"dispatched: over the card-only budget {card_only}")
    return out


def _sync_site_recorder(sites: dict):
    """A ``warnings.showwarning`` that counts each synchronizing-operation
    warning of ``torch.cuda.set_sync_debug_mode`` under the innermost
    frame of the port (outside ``analysis/``) that made it, ``"path:line"``
    (``"outside:file:line"`` when the entry has no frame on the stack)."""
    import traceback

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        # A warning with no frame of the entry on its stack came from the
        # harness around the call: kept apart, not the entry's.
        site = f"outside:{os.path.basename(filename)}:{lineno}"
        for fr in reversed(traceback.extract_stack()[:-1]):
            f = fr.filename.replace(os.sep, "/")
            if ("tpu_aerial_transport_torch/" in f
                    and "/analysis/" not in f):
                site = (f"{f.split('tpu_aerial_transport_torch/')[-1]}:"
                        f"{fr.lineno}")
                break
        sites[site] = sites.get(site, 0) + 1

    return show


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_entry(contract: Contract, device="cpu",
                disabled: frozenset[str] = frozenset(),
                report: dict | None = None) -> list:
    """Run the contracts for one registry entry on ``device``: build it,
    call it once, call it again with fresh arguments under the op watch,
    and hold the second call to TC101, TC102, TC103 and TC105. An entry the
    device cannot build (``skip_reason``) gives no finding. ``report``,
    when given, is filled with what was counted: ``syncs`` (by kind),
    ``syncs_total``, ``sync_debug_warnings`` (on the card) and
    ``sync_sites`` (their places in the port), ``budget``, ``card_only``,
    ``rebuilds``, ``launches`` (by kernel, second call), ``wide_ops``,
    ``shared_outputs``, ``seconds``."""
    import time
    import warnings

    from tpu_aerial_transport_torch.analysis import entrypoints
    from tpu_aerial_transport_torch.analysis.rules import Finding

    path = f"contracts:{contract.name}"
    report = {} if report is None else report
    skip = contract.skip_reason(device)
    if skip:
        report["skipped"] = skip
        return []
    t0 = time.perf_counter()
    out: list = []

    def finding(rule, message):
        if rule not in disabled:
            out.append(Finding(rule=rule, path=path, line=0, col=0,
                               message=message))

    fn, make_args = contract.build(torch.device(device))
    fn(*make_args())
    _sync(device)
    args = make_args()
    _sync(device)
    before = _rebuild_counters(fn)
    launches0 = _launches()
    on_card = torch.device(device).type == "cuda"
    watch = OpWatch(torch.device(device).type)
    sites: dict[str, int] = {}
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = _sync_site_recorder(sites)
        if on_card:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with watch:
                result = fn(*args)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode("default")
    _sync(device)
    after = _rebuild_counters(fn)
    launches1 = _launches()
    debug_warnings = sum(v for k, v in sites.items()
                         if not k.startswith("outside:"))

    grown = {k: (before[k], after[k]) for k in before
             if after[k] != before[k]}
    if grown:
        finding("TC101", "the second call with fresh arguments rebuilt "
                f"{grown} (before, after): something keyed on a per-call "
                "object is rebuilt every call")
    if watch.wide:
        finding("TC102", "ops with a float64/complex128 output: "
                f"{dict(sorted(watch.wide.items()))}")
    n_sync = sum(watch.syncs.values())
    budgets = budget_of(contract)
    budget, card_only = budgets or (None, None)
    for message in sync_findings(watch.syncs, budgets,
                                 debug_warnings if on_card else None,
                                 sites):
        finding("TC103", message)
    minimum = entrypoints.DONATION_CONTRACTS.get(contract.name, 0)
    ptrs = {t.untyped_storage().data_ptr() for t in _tensors(args)}
    shared = sum(t.untyped_storage().data_ptr() in ptrs
                 for t in _tensors(result))
    if shared < minimum:
        finding("TC105", f"{shared} output tensors share storage with an "
                f"argument, expected >= {minimum}: the carry went "
                "copy-in/copy-out")
    report.update(
        syncs=dict(watch.syncs), syncs_total=n_sync,
        sync_debug_warnings=debug_warnings if on_card else None,
        budget=budget, card_only=card_only,
        rebuilds={k: after[k] - before[k] for k in before},
        launches={k: launches1[k] - launches0[k] for k in launches1
                  if launches1[k] != launches0[k]},
        sync_sites=dict(sorted(sites.items())),
        wide_ops=dict(watch.wide), shared_outputs=shared,
        seconds=time.perf_counter() - t0)
    return out


def run_contracts(names=None, device="cpu",
                  disabled: frozenset[str] = frozenset(),
                  reports: dict | None = None) -> list:
    """Run the contracts for ``names`` (default: the whole registry) on
    ``device``; ``reports``, when given, maps each name to its
    :func:`check_entry` report."""
    selected = names if names is not None else sorted(REGISTRY)
    out: list = []
    for name in selected:
        rep: dict = {}
        out.extend(check_entry(REGISTRY[name], device, disabled, rep))
        if reports is not None:
            reports[name] = rep
    return out
