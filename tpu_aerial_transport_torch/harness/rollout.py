"""The batched rollouts: Monte-Carlo distributed MPC in the forest.

Counterpart of the JAX package's bench workloads (``bench.py`` ``build``,
``make_mpc_step``, ``_scenario_batch`` and ``_substeps``): each MPC step of
every scenario runs the environment queries, a controller -- consensus ADMM
(``"cadmm"``, the headline; per-agent vision cones), dual decomposition
(``"dd"``) or the centralized QP (``"centralized"``, the forest query
around the payload) -- and ten 1 kHz low-level SO(3) control + physics
substeps. All ``S`` scenarios advance together; state leaves carry the
leading scenario axis. With ``shards > 1`` C-ADMM and DD run agent-sharded
(``parallel.mesh``): the agents split into that many blocks on one card,
their consensus reductions exchanged by ``consensus_impl``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.control import cadmm, centralized, dd, lowlevel
from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.harness import setup
from tpu_aerial_transport_torch.models import rqp
from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.parallel import mesh as mesh_mod

N_AGENTS = 8
N_SCENARIOS = 256
# The JAX bench's inner-iteration knees (bench.py:257-263): C-ADMM 20, DD 40.
INNER_ITERS = {"cadmm": 20, "dd": 40}
CONTROLLERS = ("cadmm", "dd", "centralized")
# The centralized controller's solver budget in the JAX bench (bench.py:319).
CENTRALIZED_SOLVER_ITERS = 120


def substeps(params, ll, state, f_des, n_sub: int = 10, dt: float = 1e-3):
    """``n_sub`` steps of 1 kHz low-level control + physics."""
    with phases.scope(phases.DYNAMICS):
        for _ in range(n_sub):
            f, M = ll.control(state, f_des)
            state = rqp.integrate(params, state, (f, M), dt)
    return state


def make_mpc_step(controller: str, n: int, max_iter: int = 20,
                  inner_iters: int | None = None,
                  pad_operators: bool | None = None, socp_fused: str = "auto",
                  inner_tol: float = 0.0, effort: str = "auto",
                  socp_precision: str = "auto", tau_incr: float = 1.0,
                  inner_iters_warm: int = 0, reduced_qp: bool | None = None,
                  shards: int = 1, consensus_impl: str = "auto",
                  device="cuda"):
    """``(mpc_step(css, states) -> (css, states, stats), cs0, state0)`` for
    the bench set-up: ``rqp_setup(n)``, forest seed 0, PD low level,
    ``acc_des = ((0.3, 0, 0), 0)``, ``controller`` ``"cadmm"``, ``"dd"``
    (the JAX bench's ``inner_iters`` 20 and 40; the solver knobs apply to
    these two, ``tau_incr`` and ``inner_iters_warm`` to C-ADMM only) or
    ``"centralized"`` (``solver_iters=120``); ``reduced_qp`` is C-ADMM's
    agent-QP formulation (None: Schur-reduced from n = 4, as the JAX
    package picks). ``shards > 1`` runs C-ADMM or
    DD agent-sharded over that many blocks (``n % shards == 0``), the
    exchanges by ``consensus_impl`` (``parallel.ring.resolve_consensus``);
    ``shards=1`` is the single program, which takes no ``consensus_impl``
    but ``"auto"``. ``cs0``/``state0`` are one scenario's (no scenario
    axis); ``mpc_step`` takes and returns batched ones."""
    if controller not in CONTROLLERS:
        raise ValueError(
            f"controller={controller!r}: expected one of {CONTROLLERS}")
    cadmm_kw = dict(tau_incr=tau_incr, inner_iters_warm=inner_iters_warm,
                    reduced_qp=reduced_qp)
    if controller != "cadmm" and (tau_incr != 1.0 or inner_iters_warm
                                  or reduced_qp is not None):
        raise ValueError(f"{cadmm_kw} are C-ADMM options, not {controller}'s")
    if controller == "centralized" and (shards != 1
                                        or consensus_impl != "auto"):
        raise ValueError("the centralized controller has no agents to "
                         f"shard (shards={shards}, "
                         f"consensus_impl={consensus_impl!r})")
    cadmm.check_shards(n, shards)
    if shards == 1 and consensus_impl != "auto":
        raise ValueError(f"consensus_impl={consensus_impl!r} needs shards > "
                         "1: a single program makes no exchange")
    dev = resolve_device(device)
    params, col, state0 = setup.rqp_setup(n, device=dev)
    forest = forest_mod.make_forest(seed=0, device=dev)
    f_eq = centralized.equilibrium_forces(params)
    ll = lowlevel.make_lowlevel_controller("pd", params)
    dvl_des = torch.zeros(3, dtype=torch.float32, device=dev)
    dvl_des[0] = 0.3
    acc_des = (dvl_des, torch.zeros(3, dtype=torch.float32, device=dev))
    if controller == "centralized":
        cfg = centralized.make_config(
            params, col.collision_radius, col.max_deceleration,
            solver_iters=CENTRALIZED_SOLVER_ITERS)
        cs0 = centralized.init_ctrl_state(params, cfg, f_eq)

        def central_step(css, states):
            with phases.scope(phases.CBF_ROWS):
                env_cbf = forest_mod.collision_cbf_rows(
                    forest, states.xl, states.vl, col.collision_radius,
                    col.max_deceleration, cfg.vision_radius, cfg.dist_eps,
                    cfg.alpha_env_cbf, cfg.n_env_cbfs)
            f_des, css, stats = centralized.control(
                params, cfg, f_eq, css, states, acc_des, env_cbf)
            return css, substeps(params, ll, states, f_des), stats

        return central_step, cs0, state0
    mod = cadmm if controller == "cadmm" else dd
    cfg = mod.make_config(
        params, col.collision_radius, col.max_deceleration,
        max_iter=max_iter,
        inner_iters=(inner_iters if inner_iters is not None
                     else INNER_ITERS[controller]),
        pad_operators=pad_operators, socp_fused=socp_fused,
        inner_tol=inner_tol, effort=effort, socp_precision=socp_precision,
        consensus_impl=consensus_impl, device=dev,
        **(cadmm_kw if controller == "cadmm" else {}),
    )
    if controller == "cadmm":
        cs0 = cadmm.init_cadmm_state(params, cfg, f_eq)
        plan = cadmm.make_plan(params, cfg)
    else:
        cs0 = dd.init_dd_state(params, cfg, f_eq)
        plan = dd.make_dd_plan(params, cfg)

    def control(css, states, acc_des):
        return mod.control(params, cfg, f_eq, css, states, acc_des, forest,
                           shards=shards, plan=plan)

    if shards > 1:
        control = mesh_mod.sharded_step(control, n, shards)

    def mpc_step(css, states):
        f_app, css, stats = control(css, states, acc_des)
        return css, substeps(params, ll, states, f_app), stats

    return mpc_step, cs0, state0


def stack_scenarios(tree, n_scenarios: int):
    """Repeat one scenario's state (a tensor, dataclass or NamedTuple of
    tensors) along a new leading scenario axis."""
    if isinstance(tree, torch.Tensor):
        return tree.expand((n_scenarios,) + tree.shape).clone()
    if isinstance(tree, tuple):
        return type(tree)(*(stack_scenarios(t, n_scenarios) for t in tree))
    fields = {k: stack_scenarios(v, n_scenarios)
              for k, v in vars(tree).items()}
    return type(tree)(**fields)


def scenario_batch(state0: rqp.RQPState, n_scenarios: int) -> rqp.RQPState:
    """The headline's seeded scenario batch: payload positions
    ``N(0, 2^2) + (5, 0, 2)`` from ``numpy.random.default_rng(0)``, every
    payload moving at (0.5, 0, 0) m/s, everything else from ``state0``."""
    xs = (np.random.default_rng(0).normal(size=(n_scenarios, 3)) * 2.0
          + np.array([5.0, 0.0, 2.0]))
    states = stack_scenarios(state0, n_scenarios)
    dev = state0.xl.device
    vl = torch.zeros((n_scenarios, 3), dtype=torch.float32, device=dev)
    vl[:, 0] = 0.5
    return states.replace(
        xl=torch.as_tensor(xs, dtype=torch.float32, device=dev), vl=vl,
    )


def rollout(mpc_step, css, states, n_steps: int):
    """``n_steps`` MPC steps of every scenario: ``-> (css, states,
    iters (n_steps, S))`` with the per-step consensus iteration counts."""
    iters = []
    for _ in range(n_steps):
        css, states, stats = mpc_step(css, states)
        iters.append(stats.iters)
    return css, states, torch.stack(iters)


def build(n: int = N_AGENTS, n_scenarios: int = N_SCENARIOS,
          max_iter: int = 20, inner_iters: int | None = None,
          pad_operators: bool | None = None, device="cuda", *,
          controller: str = "cadmm", socp_fused: str = "auto",
          inner_tol: float = 0.0, effort: str = "auto",
          socp_precision: str = "auto", tau_incr: float = 1.0,
          inner_iters_warm: int = 0, reduced_qp: bool | None = None,
          shards: int = 1, consensus_impl: str = "auto"):
    """A bench workload: ``(run(css, states, n_steps), css, states)`` with
    ``controller`` at ``n`` agents over ``n_scenarios`` seeded scenarios;
    the defaults are the headline (C-ADMM, fixed effort, whole-solve
    kernel route, float32 operators, one program). ``shards`` and
    ``consensus_impl`` shard the agents (:func:`make_mpc_step`)."""
    mpc_step, cs0, state0 = make_mpc_step(
        controller, n, max_iter=max_iter, inner_iters=inner_iters,
        pad_operators=pad_operators, socp_fused=socp_fused,
        inner_tol=inner_tol, effort=effort, socp_precision=socp_precision,
        tau_incr=tau_incr, inner_iters_warm=inner_iters_warm,
        reduced_qp=reduced_qp, shards=shards, consensus_impl=consensus_impl,
        device=device,
    )
    states = scenario_batch(state0, n_scenarios)
    css = stack_scenarios(cs0, n_scenarios)

    def run(css, states, n_steps):
        return rollout(mpc_step, css, states, n_steps)

    return run, css, states
