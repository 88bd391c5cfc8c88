"""The entry-point registry: every public entry point of the port, with a
builder of its callable and of fresh arguments at a tiny size.

Counterpart of the JAX package's ``analysis/contracts.py`` REGISTRY, with
its 35 names. Only the registry is ported: the JAX trace contracts (TC101
to TC106) check jitted programs and wait with the rest of ``analysis/``.
The AOT bundles (``aot/``) iterate it: one bundle variant per entry and
shape signature.

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
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable

import numpy as np
import torch

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
