"""The batched rollouts: Monte-Carlo distributed MPC in the forest.

Counterpart of the JAX package's ``harness/rollout.py`` and of its bench
workloads (``bench.py`` ``build``, ``make_mpc_step``, ``_scenario_batch``
and ``_substeps``). Each MPC step of every scenario runs the environment
queries, a controller -- consensus ADMM (``"cadmm"``, the headline;
per-agent vision cones), dual decomposition (``"dd"``) or the centralized
QP (``"centralized"``, the forest query around the payload) -- and ten
1 kHz low-level SO(3) control + physics substeps. All ``S`` scenarios
advance together; state leaves carry the leading scenario axis. With
``shards > 1`` C-ADMM and DD run agent-sharded (``parallel.mesh``); with
``buckets >= 2`` the batch runs congestion-bucketed
(``harness.bucketing``).

Two loops: :func:`run_steps` (inside :func:`build`) is the bench's,
``n_steps`` MPC steps returning the iteration counts; :func:`rollout` is
the reference example's main loop, the logged two-rate rollout with a
reference trajectory (:func:`make_forest_acc_des`) and one
:class:`RQPLogStep` a step. On the card :func:`build` and
:func:`jit_rollout` replay the substeps from a CUDA graph
(``harness.cuda_graph``), the counterpart of the JAX package's compiled
scan; ``cuda_graph=False`` on :func:`build` runs them eagerly, as
:func:`rollout` does. Both rollouts take ``telemetry=`` (``obs.telemetry``):
the run-health accumulator folded each step, returned as a fourth value.
The fault-aware rollout with its fallback ladder and NaN quarantine is
``resilience.rollout``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple

import numpy as np
import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.control import cadmm, centralized, dd, lowlevel
from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.harness import bucketing, setup
from tpu_aerial_transport_torch.harness.cuda_graph import GraphedFn
from tpu_aerial_transport_torch.models import rqp
from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.obs import telemetry as telemetry_mod
from tpu_aerial_transport_torch.parallel import mesh as mesh_mod
from tpu_aerial_transport_torch.tree import tree_map

N_AGENTS = 8
N_SCENARIOS = 256
# The JAX bench's inner-iteration knees (bench.py:257-263): C-ADMM 20, DD 40.
INNER_ITERS = {"cadmm": 20, "dd": 40}
CONTROLLERS = ("cadmm", "dd", "centralized")
# The centralized controller's solver budget in the JAX bench (bench.py:319).
CENTRALIZED_SOLVER_ITERS = 120
# The congestion metric's radius beyond the collision radius, in m, as the
# JAX bench sets it for ``buckets >= 2`` (bench.py:362-375).
BUCKET_METRIC_MARGIN = 5.0


def make_substeps(params, ll_control: Callable, n_sub: int = 10,
                  dt: float = 1e-3, cuda_graph: bool = True,
                  scaled: bool = False) -> Callable:
    """``substeps(state, f_des) -> state``: ``n_sub`` steps of 1 kHz
    low-level control ``ll_control(state, f_des) -> (f, M)`` + physics, in
    the ``tat.dynamics`` scope. With ``cuda_graph`` the loop is a
    :class:`GraphedFn` (replayed from a CUDA graph for states on the card,
    called as it is on the CPU), reachable as ``substeps.graph`` (None
    without). ``scaled``: ``substeps(state, f_des, thrust_scale)`` with
    ``ll_control(state, f_des, thrust_scale)``, the fault-aware form; the
    scale is an input of the graph, as the forces are."""

    def body(state, f_des):
        for _ in range(n_sub):
            state = rqp.integrate(params, state, ll_control(state, f_des), dt)
        return state

    def scaled_body(state, inputs):
        f_des, thrust_scale = inputs
        for _ in range(n_sub):
            state = rqp.integrate(
                params, state, ll_control(state, f_des, thrust_scale), dt)
        return state

    fn = scaled_body if scaled else body
    if cuda_graph:
        fn = GraphedFn(fn)

    def substeps(state, f_des, thrust_scale=None):
        with phases.scope(phases.DYNAMICS):
            return fn(state, (f_des, thrust_scale) if scaled else f_des)

    substeps.graph = fn if cuda_graph else None
    return substeps


class Controller(NamedTuple):
    """A controller on the bench set-up (:func:`make_controller`)."""

    control: Callable  # (css, states, acc_des) -> (f_des, css, stats).
    cs0: object  # one scenario's controller state (no scenario axis).
    state0: rqp.RQPState  # one scenario's initial state.
    params: rqp.RQPParams
    ll: lowlevel.LowLevelController
    forest: forest_mod.Forest
    col: rqp.RQPCollision
    cfg: object  # the controller's config (C-ADMM, DD or centralized).


def make_controller(controller: str, n: int, max_iter: int = 20,
                    inner_iters: int | None = None,
                    pad_operators: bool | None = None,
                    socp_fused: str = "auto", inner_tol: float = 0.0,
                    effort: str = "auto", socp_precision: str = "auto",
                    tau_incr: float = 1.0, inner_iters_warm: int = 0,
                    reduced_qp: bool | None = None, shards: int = 1,
                    consensus_impl: str = "auto",
                    forest: forest_mod.Forest | None = None,
                    track_agent_stats: bool = False,
                    device="cuda") -> Controller:
    """The bench set-up's high-level controller: ``rqp_setup(n)``, the
    forest given (None: the seed-0 mountain world; a city-scale world
    carries its grid, ``envs.spatial.with_grid``, and C-ADMM and DD resolve
    their environment query from the world under ``env_query="auto"``),
    the PD low level; ``controller`` ``"cadmm"``, ``"dd"`` (the
    JAX bench's ``inner_iters`` 20 and 40; the solver knobs apply to these
    two, ``tau_incr`` and ``inner_iters_warm`` to C-ADMM only) or
    ``"centralized"`` (``solver_iters=120``); ``reduced_qp`` is C-ADMM's
    agent-QP formulation (None: Schur-reduced from n = 4, as the JAX
    package picks). ``shards > 1`` runs C-ADMM or DD agent-sharded over
    that many blocks (``n % shards == 0``), the exchanges by
    ``consensus_impl`` (``parallel.ring.resolve_consensus``); ``shards=1``
    is the single program, which takes no ``consensus_impl`` but
    ``"auto"``. ``track_agent_stats`` (C-ADMM and DD) puts every agent's
    exit-time QP residual on the stats, for the run-health telemetry's
    ``track_agents``. ``control`` takes and returns batched states and an
    ``acc_des`` shared (``(3,)`` each) or per scenario (``(S, 3)``)."""
    if controller not in CONTROLLERS:
        raise ValueError(
            f"controller={controller!r}: expected one of {CONTROLLERS}")
    cadmm_kw = dict(tau_incr=tau_incr, inner_iters_warm=inner_iters_warm,
                    reduced_qp=reduced_qp)
    if controller != "cadmm" and (tau_incr != 1.0 or inner_iters_warm
                                  or reduced_qp is not None):
        raise ValueError(f"{cadmm_kw} are C-ADMM options, not {controller}'s")
    if controller == "centralized" and track_agent_stats:
        raise ValueError("track_agent_stats: the centralized controller "
                         "has no agent solves")
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
    if forest is None:
        forest = forest_mod.make_forest(seed=0, device=dev)
    f_eq = centralized.equilibrium_forces(params)
    ll = lowlevel.make_lowlevel_controller("pd", params)
    if controller == "centralized":
        cfg = centralized.make_config(
            params, col.collision_radius, col.max_deceleration,
            solver_iters=CENTRALIZED_SOLVER_ITERS)
        cs0 = centralized.init_ctrl_state(params, cfg, f_eq)

        def control(css, states, acc_des):
            with phases.scope(phases.CBF_ROWS):
                env_cbf = forest_mod.collision_cbf_rows(
                    forest, states.xl, states.vl, col.collision_radius,
                    col.max_deceleration, cfg.vision_radius, cfg.dist_eps,
                    cfg.alpha_env_cbf, cfg.n_env_cbfs)
            return centralized.control(params, cfg, f_eq, css, states,
                                       acc_des, env_cbf)

        return Controller(control, cs0, state0, params, ll, forest, col, cfg)
    mod = cadmm if controller == "cadmm" else dd
    cfg = mod.make_config(
        params, col.collision_radius, col.max_deceleration,
        max_iter=max_iter,
        inner_iters=(inner_iters if inner_iters is not None
                     else INNER_ITERS[controller]),
        pad_operators=pad_operators, socp_fused=socp_fused,
        inner_tol=inner_tol, effort=effort, socp_precision=socp_precision,
        consensus_impl=consensus_impl, track_agent_stats=track_agent_stats,
        device=dev, **(cadmm_kw if controller == "cadmm" else {}),
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
    return Controller(control, cs0, state0, params, ll, forest, col, cfg)


def make_mpc_step(controller: str, n: int, *, buckets: int = 0,
                  cuda_graph: bool = True, **controller_kw):
    """``(mpc_step(css, states) -> (css, states, stats), cs0, state0)`` for
    the bench set-up (:func:`make_controller`, whose keywords pass
    through) with ``acc_des = ((0.3, 0, 0), 0)`` and the ten substeps
    (:func:`make_substeps`, from a CUDA graph on the card unless
    ``cuda_graph=False``; ``mpc_step.substeps`` is that function).
    ``buckets >= 2`` runs the step congestion-bucketed
    (``bucketing.bucketed_step``, the JAX bench's ``--buckets``: trees
    within the collision radius + 5 m of the payload; the batch must
    divide); 0 is the one batched step. ``cs0``/``state0`` are one
    scenario's (no scenario axis); ``mpc_step`` takes and returns batched
    ones."""
    ctl = make_controller(controller, n, **controller_kw)
    dev = ctl.params.r.device
    dvl_des = torch.zeros(3, dtype=torch.float32, device=dev)
    dvl_des[0] = 0.3
    acc_des = (dvl_des, torch.zeros(3, dtype=torch.float32, device=dev))
    substeps = make_substeps(ctl.params, ctl.ll.control,
                             cuda_graph=cuda_graph)

    def step(css, states):
        f_des, css, stats = ctl.control(css, states, acc_des)
        return css, substeps(states, f_des), stats

    mpc_step = step
    if buckets >= 2:
        metric = bucketing.env_congestion_metric(
            ctl.forest, ctl.col.collision_radius + BUCKET_METRIC_MARGIN)
        mpc_step = bucketing.bucketed_step(step, metric, buckets)
    mpc_step.substeps = substeps
    return mpc_step, ctl.cs0, ctl.state0


def stack_scenarios(tree, n_scenarios: int):
    """Repeat one scenario's state (a tree of tensors) along a new leading
    scenario axis."""
    return tree_map(
        lambda t: t.expand((n_scenarios,) + t.shape).clone(), tree)


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


def run_steps(mpc_step, css, states, n_steps: int):
    """The bench loop: ``n_steps`` MPC steps of every scenario ``-> (css,
    states, iters (n_steps, S))`` with the per-step consensus iteration
    counts (``bench.py build()``'s scan)."""
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
          shards: int = 1, consensus_impl: str = "auto", buckets: int = 0,
          cuda_graph: bool = True):
    """A bench workload: ``(run(css, states, n_steps), css, states)`` with
    ``controller`` at ``n`` agents over ``n_scenarios`` seeded scenarios;
    the defaults are the headline (C-ADMM, fixed effort, whole-solve
    kernel route, float32 operators, one program, one batch, the substeps
    from a CUDA graph on the card). ``shards``/``consensus_impl``,
    ``buckets`` and ``cuda_graph`` as in :func:`make_mpc_step`;
    ``run.mpc_step`` is the step."""
    mpc_step, cs0, state0 = make_mpc_step(
        controller, n, max_iter=max_iter, inner_iters=inner_iters,
        pad_operators=pad_operators, socp_fused=socp_fused,
        inner_tol=inner_tol, effort=effort, socp_precision=socp_precision,
        tau_incr=tau_incr, inner_iters_warm=inner_iters_warm,
        reduced_qp=reduced_qp, shards=shards, consensus_impl=consensus_impl,
        device=device, buckets=buckets, cuda_graph=cuda_graph,
    )
    states = scenario_batch(state0, n_scenarios)
    css = stack_scenarios(cs0, n_scenarios)

    def run(css, states, n_steps):
        return run_steps(mpc_step, css, states, n_steps)

    run.mpc_step = mpc_step
    return run, css, states


@dataclass(frozen=True)
class RQPLogStep:
    """One high-level step's log record (the reference example's state
    data and its error and solver sequences). After :func:`rollout` every
    leaf carries a leading time axis and then the scenario axis: ``(T, S,
    ...)``."""

    xl: torch.Tensor
    vl: torch.Tensor
    Rl: torch.Tensor
    wl: torch.Tensor
    R: torch.Tensor
    w: torch.Tensor
    f_des: torch.Tensor
    x_err: torch.Tensor
    v_err: torch.Tensor
    iters: torch.Tensor
    solve_res: torch.Tensor
    collision: torch.Tensor
    min_env_dist: torch.Tensor
    # The fallback-ladder rung taken and the sticky NaN-quarantine flag:
    # zero here; ``resilience.rollout`` fills them.
    fallback_rung: torch.Tensor = field(
        default_factory=lambda: torch.zeros((), dtype=torch.int32))
    quarantined: torch.Tensor = field(
        default_factory=lambda: torch.zeros((), dtype=torch.bool))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def make_forest_acc_des(forest: forest_mod.Forest) -> Callable:
    """The terrain-following constant-velocity reference of the reference
    example, batched over scenarios: ``acc_des_fn(states, t) -> ((dvl_des
    (S, 3), dwl_des (S, 3)), x_ref (S, 3), v_ref (3,))`` with a waypoint
    1.5 m ahead in x at 1.5 m above the terrain, ``v_ref = (0.5, 0, 0)``
    m/s and a PD acceleration whose norm is clamped to 1."""

    def acc_des_fn(states, t):
        del t
        xl, vl = states.xl, states.vl
        ground = forest_mod.ground_height(forest, xl[..., :2])
        x_ref = torch.stack(
            [xl[..., 0] + 1.5, torch.zeros_like(ground), ground + 1.5],
            dim=-1)
        # (0.5, 0, 0) from a fill and a pad: no host-to-device copy a step.
        v_ref = torch.nn.functional.pad(
            torch.full((1,), 0.5, dtype=xl.dtype, device=xl.device), (0, 2))
        dvl_des = -1.0 * (vl - v_ref) - 1.0 * (xl - x_ref)
        norm = _norm(dvl_des)[..., None]
        dvl_des = torch.where(
            norm > 1.0,
            dvl_des / torch.where(norm > 0, norm, torch.ones_like(norm)),
            dvl_des)
        return (dvl_des, torch.zeros_like(dvl_des)), x_ref, v_ref

    return acc_des_fn


def rollout(hl_step: Callable, ll_control: Callable, params: rqp.RQPParams,
            state0: rqp.RQPState, ctrl_state0, n_hl_steps: int,
            hl_rel_freq: int = 10, dt: float = 1e-3,
            acc_des_fn: Callable | None = None, step_offset: int = 0,
            telemetry: telemetry_mod.TelemetryConfig | None = None,
            telem0: telemetry_mod.TelemetryState | None = None):
    """``n_hl_steps`` high-level control periods of every scenario: the
    reference example's two-rate loop, a high-level step then
    ``hl_rel_freq`` substeps of ``dt``.

    Axes: ``state0`` and ``ctrl_state0`` carry the leading scenario axis
    ``S`` on every leaf (the JAX package's ``rollout`` is single-scenario
    and its users ``vmap`` it). ``hl_step(ctrl_state, states, acc_des) ->
    (f_des (S, n, 3), ctrl_state, SolverStats)`` is any controller's step
    (:class:`Controller`'s ``control``); ``ll_control(states, f_des) ->
    (f, M)``; ``acc_des_fn(states, t) -> (acc_des, x_ref, v_ref)``, where
    ``t = i * hl_rel_freq * dt`` (a Python float) for global step ``i =
    step_offset + k``; default: hover at the initial position. The
    substeps run as plain calls (:func:`jit_rollout` replays them from a
    CUDA graph). ``telemetry``: an active ``obs.telemetry.TelemetryConfig``
    folds every step's stats into an accumulator with ``(S, ...)`` leaves,
    starting from ``telem0`` (default: a fresh one); None or an inactive
    config runs the telemetry-less loop.

    Returns ``(final_state, final_ctrl_state, logs)``, plus the final
    accumulator with telemetry active; every leaf of ``logs``
    (:class:`RQPLogStep`) is ``(T, S, ...)``: time first, then scenario
    (``jax.vmap`` of the JAX rollout gives ``(S, T, ...)``)."""
    substeps = make_substeps(params, ll_control, hl_rel_freq, dt,
                             cuda_graph=False)
    return _rollout(hl_step, substeps, state0, ctrl_state0, n_hl_steps,
                    hl_rel_freq, dt, acc_des_fn, step_offset, telemetry,
                    telem0, params.n)


def hover_acc_des(state0: rqp.RQPState) -> Callable:
    """The rollouts' default reference: hover at ``state0``'s payload
    positions (PD on position and velocity)."""
    x0 = state0.xl

    def acc_des_fn(states, t):
        del t
        dvl_des = -1.0 * states.vl - 1.0 * (states.xl - x0)
        return ((dvl_des, torch.zeros_like(dvl_des)), x0,
                torch.zeros(3, dtype=x0.dtype, device=x0.device))

    return acc_des_fn


def _rollout(hl_step, substeps, state0, ctrl_state0, n_hl_steps,
             hl_rel_freq, dt, acc_des_fn, step_offset, telemetry=None,
             telem0=None, n_agents=0):
    """:func:`rollout`'s loop with ``substeps(states, f_des) -> states``
    given, built by :func:`make_substeps` with ``hl_rel_freq`` and
    ``dt``."""
    if acc_des_fn is None:
        acc_des_fn = hover_acc_des(state0)
    S = state0.xl.shape[0]
    dev = state0.xl.device
    tel_on = telemetry is not None and telemetry.active
    tel = telem0
    if tel_on and tel is None:
        tel = telemetry_mod.init_telemetry(telemetry, n_agents,
                                           state0.xl.dtype, dev, batch=(S,))
    state, cs, logs = state0, ctrl_state0, []
    for k in range(n_hl_steps):
        t = (step_offset + k) * hl_rel_freq * dt
        acc_des, x_ref, v_ref = acc_des_fn(state, t)
        f_des, cs, stats = hl_step(cs, state, acc_des)
        state = substeps(state, f_des)
        logs.append(RQPLogStep(
            xl=state.xl, vl=state.vl, Rl=state.Rl, wl=state.wl, R=state.R,
            w=state.w, f_des=f_des, x_err=_norm(x_ref - state.xl),
            v_err=_norm(v_ref - state.vl), iters=stats.iters,
            solve_res=stats.solve_res, collision=stats.collision,
            min_env_dist=stats.min_env_dist,
            fallback_rung=torch.zeros((S,), dtype=torch.int32, device=dev),
            quarantined=torch.zeros((S,), dtype=torch.bool, device=dev),
        ))
        if tel_on:
            with phases.scope(phases.TELEMETRY):
                tel = telemetry_mod.update(telemetry, tel, stats)
    logs = tree_map(lambda *ts: torch.stack(ts), *logs)
    if tel_on:
        return state, cs, logs, tel
    return state, cs, logs


def jit_rollout(hl_step: Callable, ll_control: Callable,
                params: rqp.RQPParams, *, n_hl_steps: int,
                hl_rel_freq: int = 10, dt: float = 1e-3,
                acc_des_fn: Callable | None = None,
                telemetry: telemetry_mod.TelemetryConfig | None = None
                ) -> Callable:
    """The port's counterpart of the JAX package's ``jit_rollout``:
    ``run(state0, ctrl_state0) -> (final_state, final_ctrl_state, logs)``
    (plus the final accumulator with ``telemetry`` active),
    :func:`rollout` with the substeps replayed from one CUDA graph a batch
    shape (captured at the first call, kept across calls) for states on
    the card; on the CPU they run as plain calls. For eager substeps on
    the card call :func:`rollout`. ``run.substeps`` is the substep
    function. Nothing is donated: PyTorch hands back new tensors, and the
    inputs stay valid."""
    substeps = make_substeps(params, ll_control, hl_rel_freq, dt)

    def run(state0, ctrl_state0):
        return _rollout(hl_step, substeps, state0, ctrl_state0, n_hl_steps,
                        hl_rel_freq, dt, acc_des_fn, 0, telemetry, None,
                        params.n)

    run.substeps = substeps
    return run


def logs_to_dict(logs: RQPLogStep, n: int, dt: float, hl_rel_freq: int,
                 forest: forest_mod.Forest | None = None) -> dict:
    """The logs in the reference example's pickle-dict schema (the JAX
    package's ``logs_to_dict``, the same keys), as numpy arrays on the
    host; the time axis is the first, so ``"T"`` reads it."""

    def host(t):
        return t.detach().cpu().numpy()

    out = {
        "n": n,
        "dt": dt,
        "T": float(logs.xl.shape[0] * hl_rel_freq * dt),
        "hl_rel_freq": hl_rel_freq,
        "log_freq": hl_rel_freq,
        "state_seq": {k: host(getattr(logs, k))
                      for k in ("R", "w", "xl", "vl", "Rl", "wl")},
        "x_err_seq": host(logs.x_err),
        "v_err_seq": host(logs.v_err),
        "f_des_seq": host(logs.f_des),
        "iter_seq": host(logs.iters),
        "solve_res_seq": host(logs.solve_res),
        "min_env_dist_seq": host(logs.min_env_dist),
        "collision_seq": host(logs.collision),
        "fallback_rung_seq": host(logs.fallback_rung),
        "quarantined_seq": host(logs.quarantined),
    }
    if forest is not None:
        num = int(forest.num_trees)
        out["num_trees"] = num
        out["tree_pos"] = host(forest.tree_pos[:num])
    return out
