"""Fault-aware receding-horizon rollout: the harness rollout threaded with
fault evaluation, an explicit force-fallback ladder, and per-scenario NaN
quarantine, over the port's explicit scenario axis.

Counterpart of ``tpu_aerial_transport/resilience/rollout.py``; the ladder,
the blackout rule and the sticky quarantine follow its ``hl_body`` line for
line, every select taken per scenario.

**Fallback ladder** (the rung is ``SolverStats.fallback_rung`` and
``RQPLogStep.fallback_rung``):

  0. clean warm-started solve (``ok_frac == 1``, finite forces);
  1. the controller retried and/or substituted equilibrium forces for
     failed agent solves (``ok_frac < 1``), or no alive agent delivered a
     consensus message (a blackout), but the forces are finite;
  2. non-finite forces: hold the previous step's applied forces (and the
     previous controller state, so the poisoned solve does not seed the
     next warm start);
  3. non-finite forces and no finite previous force (the first step, or
     the hold itself poisoned): the equilibrium forces of the alive
     agents, always finite.

**Quarantine**: a scenario whose physics state goes non-finite despite the
ladder freezes at its last finite state and raises its sticky
``quarantined`` flag; the other scenarios are untouched, bit for bit
(every select reads the scenario's own bit), and aggregate statistics can
exclude flagged ones (``utils.stats.compute_aggregate_statistics(...,
valid=~quarantined)``).

``faults=None`` and ``faults=no_faults(n)`` take the nominal branch at the
Python level: no fault op, no extra launch; states and forces are then
bitwise those of ``harness.rollout.rollout``.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpu_aerial_transport_torch.control import cadmm, centralized, dd
from tpu_aerial_transport_torch.harness import rollout as harness
from tpu_aerial_transport_torch.harness.rollout import RQPLogStep, _norm
from tpu_aerial_transport_torch.models import rqp
from tpu_aerial_transport_torch.obs import phases
from tpu_aerial_transport_torch.obs import telemetry as telemetry_mod
from tpu_aerial_transport_torch.resilience import faults as faults_mod
from tpu_aerial_transport_torch.resilience.quarantine import (
    tree_all_finite,
    tree_where,
)
from tpu_aerial_transport_torch.tree import tree_map

RUNG_CLEAN = 0
RUNG_RETRY = 1
RUNG_HOLD = 2
RUNG_EQUILIBRIUM = 3


def make_cadmm_hl_step(params, cfg, forest=None, plan=None,
                       shards: int = 1) -> Callable:
    """Health-aware C-ADMM step ``hl_step(cs, states, acc_des, health=None)
    -> (f_des, cs, stats)`` for :func:`resilient_rollout`: the equilibrium
    forces recomputed each step from the alive mask (the survivors share
    the dead agents' load) and the health masks forwarded into the
    consensus. ``shards=d`` runs the agent-sharded step.
    ``hl_step.prepare_ctrl_state`` seeds the ``held`` snapshot so the
    carry's structure is fixed from the first step."""
    if plan is None:
        plan = cadmm.make_plan(params, cfg)
    f_eq_full = centralized.equilibrium_forces(params)

    def hl_step(cs, state, acc_des, health=None):
        f_eq = (f_eq_full if health is None
                else centralized.equilibrium_forces(params, health.alive))
        return cadmm.control(params, cfg, f_eq, cs, state, acc_des, forest,
                             shards=shards, plan=plan, health=health)

    hl_step.prepare_ctrl_state = lambda cs: cs._replace(held=cs.f)
    return hl_step


def make_dd_hl_step(params, cfg, forest=None, plan=None,
                    shards: int = 1) -> Callable:
    """Health-aware DD step (see :func:`make_cadmm_hl_step`); its
    ``prepare_ctrl_state`` seeds ``held_f``/``held_lam_F``/``held_lam_M``."""
    if plan is None:
        plan = dd.make_dd_plan(params, cfg)
    f_eq_full = centralized.equilibrium_forces(params)

    def hl_step(cs, state, acc_des, health=None):
        f_eq = (f_eq_full if health is None
                else centralized.equilibrium_forces(params, health.alive))
        return dd.control(params, cfg, f_eq, cs, state, acc_des, forest,
                          shards=shards, plan=plan, health=health)

    hl_step.prepare_ctrl_state = lambda cs: cs._replace(
        held_f=cs.f, held_lam_F=cs.lam_F, held_lam_M=cs.lam_M)
    return hl_step


def init_resilient_carry(hl_step: Callable, params: rqp.RQPParams,
                         state0: rqp.RQPState, ctrl_state0,
                         faults: faults_mod.FaultSchedule | None = None,
                         telemetry: telemetry_mod.TelemetryConfig | None
                         = None):
    """The full carry of :func:`resilient_rollout` for a fresh run:
    ``(state, ctrl_state, prev_applied_force (S, n, 3), quarantined (S,)[,
    telemetry_state])``. It holds the ladder's hold force and the sticky
    quarantine flag, so a run resumed from it cannot un-freeze a
    quarantined scenario or re-seed a poisoned warm start. With faults
    active the controller's ``prepare_ctrl_state`` seeds its
    resilience-only fields."""
    if faults is not None and faults.active and hasattr(
            hl_step, "prepare_ctrl_state"):
        ctrl_state0 = hl_step.prepare_ctrl_state(ctrl_state0)
    S, n = state0.xl.shape[0], params.n
    dtype, dev = state0.xl.dtype, state0.xl.device
    carry = (
        state0, ctrl_state0,
        torch.full((S, n, 3), float("nan"), dtype=dtype, device=dev),
        torch.zeros((S,), dtype=torch.bool, device=dev),
    )
    if telemetry is not None and telemetry.active:
        carry = carry + (telemetry_mod.init_telemetry(
            telemetry, n, dtype, dev, batch=(S,)),)
    return carry


def resilient_rollout(hl_step: Callable, ll_control: Callable,
                      params: rqp.RQPParams, state0: rqp.RQPState | None,
                      ctrl_state0, n_hl_steps: int, hl_rel_freq: int = 10,
                      dt: float = 1e-3, acc_des_fn: Callable | None = None,
                      faults: faults_mod.FaultSchedule | None = None,
                      carry0=None, step_offset=0, return_carry: bool = False,
                      telemetry: telemetry_mod.TelemetryConfig | None = None):
    """``n_hl_steps`` high-level control periods of every scenario with
    fault injection, the fallback ladder and NaN quarantine; the substeps
    run as plain calls (:func:`jit_resilient_rollout` replays them from a
    CUDA graph).

    Args:
      hl_step: ``(ctrl_state, states, acc_des, health) -> (f_des (S, n, 3),
        ctrl_state, SolverStats)``, e.g. :func:`make_cadmm_hl_step`;
        ``health`` is None whenever fault injection is inactive, else a
        ``FaultStep`` with ``(S, n)`` masks.
      ll_control: ``(states, f_des[, thrust_scale]) -> (f, M)``; the scale
        is passed only with fault injection active.
      faults: a ``FaultSchedule`` (one for every scenario, or one per
        scenario); None or ``active=False`` runs the nominal program.
      carry0: a carry from :func:`init_resilient_carry` (or from a
        ``return_carry=True`` run): the resume path. ``state0`` and
        ``ctrl_state0`` may then be None and ``acc_des_fn`` must be given.
      step_offset: the global index of the first HL step; the fault
        schedule and the sensor noise read the global step.
      return_carry: return ``(carry, logs)``.
      telemetry: an active ``obs.telemetry.TelemetryConfig`` folds each
        step's post-ladder stats and the quarantine flag into the carry's
        accumulator.

    Returns ``(final_state, final_ctrl_state, logs)`` (``(T, S, ...)`` log
    leaves; ``logs.quarantined[-1]`` is the final flag), plus the final
    accumulator with telemetry active; or ``(carry, logs)``."""
    substeps = harness.make_substeps(
        params, ll_control, hl_rel_freq, dt, cuda_graph=False,
        scaled=faults is not None and faults.active)
    return _resilient_rollout(
        hl_step, substeps, params, state0, ctrl_state0, n_hl_steps,
        hl_rel_freq, dt, acc_des_fn, faults, carry0, step_offset,
        return_carry, telemetry)


def _resilient_rollout(hl_step, substeps, params, state0, ctrl_state0,
                       n_hl_steps, hl_rel_freq, dt, acc_des_fn, faults,
                       carry0, step_offset, return_carry, telemetry):
    """:func:`resilient_rollout`'s loop with the substeps given
    (``harness.rollout.make_substeps``, ``scaled`` when faults are
    active)."""
    active = faults is not None and faults.active
    tel_on = telemetry is not None and telemetry.active
    if carry0 is None:
        carry0 = init_resilient_carry(hl_step, params, state0, ctrl_state0,
                                      faults, telemetry)
    if acc_des_fn is None:
        if state0 is None:
            raise ValueError(
                "acc_des_fn must be explicit when resuming from carry0: "
                "the hover default anchors at state0")
        acc_des_fn = harness.hover_acc_des(state0)
    state, cs, prev_f, quar = carry0[:4]
    tel = carry0[4] if tel_on else None
    S, n = state.xl.shape[0], params.n
    dtype = state.xl.dtype
    f_eq_full = centralized.equilibrium_forces(params)
    logs = []
    for k in range(n_hl_steps):
        i = step_offset + k
        t = i * hl_rel_freq * dt
        if active:
            with phases.scope(phases.FAULTS):
                h = faults_mod.fault_step(faults, i)
                health = faults_mod.FaultStep(*(
                    x.expand(S, n) for x in (h.alive, h.thrust_scale,
                                             h.msg_ok)))
                # Noise-free schedules skip the draws.
                sensed = (faults_mod.apply_sensor_noise(faults, i, state)
                          if faults.noisy else state)
                # Rung 3's healthy-mask equilibrium (the hl_step adapters
                # compute their own copy: the protocol stays
                # controller-agnostic).
                f_eq_t = centralized.equilibrium_forces(params, health.alive)
        else:
            health, sensed, f_eq_t = None, state, f_eq_full
        acc_des, x_ref, v_ref = acc_des_fn(sensed, t)
        f_des, cs_new, stats = hl_step(cs, sensed, acc_des, health)

        # The fallback ladder (rungs 0-3, the module docstring).
        with phases.scope(phases.FALLBACK):
            finite_f = tree_all_finite(f_des)
            if active:
                prev_hold = prev_f * health.alive.to(dtype)[..., None]
            else:
                prev_hold = prev_f
            prev_ok = tree_all_finite(prev_hold)
            retried = stats.ok_frac < 1.0
            if active:
                # Blackout: no alive agent delivered a message, so the
                # masked residual is vacuously 0 -- a degraded step.
                retried = retried | ~torch.any(health.alive & health.msg_ok,
                                               dim=-1)
            # torch.where does not propagate the unselected branch's NaNs.
            f_used = torch.where(
                finite_f[:, None, None], f_des,
                torch.where(prev_ok[:, None, None], prev_hold, f_eq_t))
            rung = torch.where(
                finite_f,
                torch.where(retried, RUNG_RETRY, RUNG_CLEAN),
                torch.where(prev_ok, RUNG_HOLD, RUNG_EQUILIBRIUM),
            ).to(torch.int32)
            stats = stats.replace(fallback_rung=rung)
            # A poisoned solve must not seed the next warm start.
            cs_next = tree_where(tree_all_finite(cs_new), cs_new, cs)

        if active:
            new_state = substeps(state, f_used, health.thrust_scale)
        else:
            new_state = substeps(state, f_used)

        # The per-scenario NaN quarantine (sticky).
        with phases.scope(phases.FALLBACK):
            quar_new = quar | ~tree_all_finite(new_state)
            new_state = tree_where(quar_new, state, new_state)
            cs_next = tree_where(quar_new, cs, cs_next)
            prev_next = torch.where(quar_new[:, None, None], prev_f, f_used)

        logs.append(RQPLogStep(
            xl=new_state.xl, vl=new_state.vl, Rl=new_state.Rl,
            wl=new_state.wl, R=new_state.R, w=new_state.w, f_des=f_used,
            x_err=_norm(x_ref - new_state.xl),
            v_err=_norm(v_ref - new_state.vl), iters=stats.iters,
            solve_res=stats.solve_res, collision=stats.collision,
            min_env_dist=stats.min_env_dist,
            fallback_rung=stats.fallback_rung, quarantined=quar_new,
        ))
        if tel_on:
            with phases.scope(phases.TELEMETRY):
                tel = telemetry_mod.update(telemetry, tel, stats,
                                           quarantined=quar_new)
        state, cs, prev_f, quar = new_state, cs_next, prev_next, quar_new
    logs = tree_map(lambda *ts: torch.stack(ts), *logs)
    carry = (state, cs, prev_f, quar) + ((tel,) if tel_on else ())
    if return_carry:
        return carry, logs
    if tel_on:
        return state, cs, logs, tel
    return state, cs, logs


def jit_resilient_rollout(hl_step: Callable, ll_control: Callable,
                          params: rqp.RQPParams, *, n_hl_steps: int,
                          hl_rel_freq: int = 10, dt: float = 1e-3,
                          acc_des_fn: Callable | None = None,
                          faults: faults_mod.FaultSchedule | None = None,
                          telemetry: telemetry_mod.TelemetryConfig | None
                          = None) -> Callable:
    """The fault-aware twin of ``harness.rollout.jit_rollout``:
    ``run(state0, ctrl_state0)`` as :func:`resilient_rollout` returns, with
    the substeps replayed from one CUDA graph a batch shape for states on
    the card (the thrust scale an input of the graph under faults); on the
    CPU they run as plain calls. ``prepare_ctrl_state`` runs inside
    ``run``, so the controller state passed in is always the nominal one.
    ``run.substeps`` is the substep function."""
    substeps = harness.make_substeps(
        params, ll_control, hl_rel_freq, dt,
        scaled=faults is not None and faults.active)

    def run(state0, ctrl_state0):
        return _resilient_rollout(
            hl_step, substeps, params, state0, ctrl_state0, n_hl_steps,
            hl_rel_freq, dt, acc_des_fn, faults, None, 0, False, telemetry)

    run.substeps = substeps
    return run
