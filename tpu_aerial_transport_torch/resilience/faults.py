"""Fault schedules: per-agent fault injection for the batched rollouts.

Counterpart of ``tpu_aerial_transport/resilience/faults.py``. A
:class:`FaultSchedule` describes, per agent:

- **actuator degradation**: from HL step ``t_degrade[i]`` on, agent i's
  thrust and moment authority is scaled by ``thrust_scale[i]``;
- **full agent loss**: at HL step ``t_fail[i]`` agent i dies -- zero thrust,
  zero moment, its consensus contributions masked and its duals frozen;
- **state-sensor noise**: Gaussian noise of std ``noise_std`` on the payload
  position/velocity and the quadrotors' body rates the *controller* sees
  (the physics integrates the true state);
- **consensus-message dropout**: per block of ``drop_hold`` HL steps, each
  agent's outgoing consensus message is dropped with probability
  ``drop_rate``; while dropped, its peers hold its last delivered value.

All randomness is stateless -- Threefry of the schedule's ``key`` folded with
the HL step (:mod:`.prng`, the JAX package's bits for the same key) -- so a
replayed or resumed run draws identical faults.

Batching: a schedule holds one schedule for every scenario (leaves ``(n,)``,
scalars ``()``, key ``(2,)``) or one per scenario (leaves ``(S, n)``,
scalars ``(S,)``, key ``(S, 2)``; :func:`stack_schedules`), what
``jax.vmap`` over stacked schedules gives in the JAX package. ``active``
and ``noisy`` are Python bools, the JAX package's static fields: with
:func:`no_faults` (``active=False``) every consumer takes its nominal path
at the Python level.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.resilience import prng
from tpu_aerial_transport_torch.tree import tree_map

# HL-step index for "never": ``t < NEVER`` for any reachable step.
NEVER = 2 ** 31 - 1


@dataclass(frozen=True)
class FaultStep:
    """One HL step's evaluated health, per agent (``(..., n)`` leaves)."""

    alive: torch.Tensor  # bool: False once t >= t_fail.
    thrust_scale: torch.Tensor  # float: 0 for dead agents.
    msg_ok: torch.Tensor  # bool: consensus message delivered this step.

    def replace(self, **kw) -> "FaultStep":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class FaultSchedule:
    """A run's fault description (see the module docstring)."""

    t_fail: torch.Tensor  # (..., n) int32 HL step of agent loss.
    t_degrade: torch.Tensor  # (..., n) int32 onset of degradation.
    thrust_scale: torch.Tensor  # (..., n) scale once degraded.
    drop_rate: torch.Tensor  # (...) per-(block, agent) dropout probability.
    drop_hold: torch.Tensor  # (...) int32 HL steps a dropout draw holds.
    noise_std: torch.Tensor  # (...) sensor-noise std [m, m/s, rad/s].
    key: torch.Tensor  # (..., 2) int64 Threefry key words.
    # False: every consumer takes its nominal path.
    active: bool = True
    # False: apply_sensor_noise is skipped (no draws); set with noise_std.
    noisy: bool = True

    @property
    def n(self) -> int:
        return self.t_fail.shape[-1]

    def replace(self, **kw) -> "FaultSchedule":
        return dataclasses.replace(self, **kw)


def make_schedule(n: int, *, t_fail=None, t_degrade=None, thrust_scale=None,
                  drop_rate: float = 0.0, drop_hold: int = 1,
                  noise_std: float = 0.0, key=None, dtype=torch.float32,
                  device="cuda") -> FaultSchedule:
    """One schedule on ``device``. ``t_fail``/``t_degrade`` take a per-agent
    array or an ``{agent: step}`` dict (unlisted agents never fault);
    ``thrust_scale`` an array or a scalar for every degraded agent;
    ``drop_hold`` is clamped to at least 1; ``key`` defaults to
    ``prng.prng_key(0)``."""
    dev = resolve_device(device)

    def steps(spec):
        out = torch.full((n,), NEVER, dtype=torch.int32, device=dev)
        if spec is None:
            return out
        if isinstance(spec, dict):
            for i, t in spec.items():
                out[int(i)] = int(t)
            return out
        return torch.as_tensor(spec, device=dev).to(torch.int32).reshape(n)

    def scalar(v, dt):
        return torch.as_tensor(v, device=dev).to(dt)

    scale = (torch.ones((n,), dtype=dtype, device=dev) if thrust_scale is None
             else torch.as_tensor(thrust_scale, device=dev).to(dtype)
             .expand(n).clone())
    return FaultSchedule(
        t_fail=steps(t_fail),
        t_degrade=steps(t_degrade),
        thrust_scale=scale,
        drop_rate=scalar(drop_rate, dtype),
        drop_hold=scalar(max(int(drop_hold), 1), torch.int32),
        noise_std=scalar(noise_std, dtype),
        key=(prng.prng_key(0, dev) if key is None
             else torch.as_tensor(key, device=dev).to(torch.int64)),
        active=True,
        noisy=float(noise_std) != 0.0,
    )


def no_faults(n: int, dtype=torch.float32, device="cuda") -> FaultSchedule:
    """The nominal schedule (``active=False``): every consumer takes its
    fault-free path."""
    return make_schedule(n, dtype=dtype, device=device).replace(active=False)


def stack_schedules(scheds) -> FaultSchedule:
    """One schedule per scenario from a list of single schedules: every
    leaf stacked on a new leading axis; ``active`` and ``noisy`` hold if
    they hold for any member (a member without noise adds exactly 0)."""
    out = tree_map(lambda *ts: torch.stack(ts), *scheds)
    return out.replace(active=any(s.active for s in scheds),
                       noisy=any(s.noisy for s in scheds))


def _per_key(x: torch.Tensor, event_dims: int) -> torch.Tensor:
    """A per-schedule scalar ``(...)`` shaped to broadcast over ``event_dims``
    trailing axes."""
    return x.reshape(x.shape + (1,) * event_dims)


def fault_step(sched: FaultSchedule, t) -> FaultStep:
    """The schedule at HL step ``t`` (a Python int, which costs no
    host-to-device copy, or a 0-dim tensor). Dropout draws hold within each
    block of ``drop_hold`` steps, so a dropped agent stays dropped for
    ``drop_hold`` consecutive steps."""
    if not isinstance(t, int):
        t = t.to(torch.int32)
    alive = sched.t_fail > t
    dtype = sched.thrust_scale.dtype
    scale = torch.where(sched.t_degrade <= t, sched.thrust_scale,
                        torch.ones_like(sched.thrust_scale)) \
        * alive.to(dtype)
    block = t // sched.drop_hold
    drop = prng.bernoulli(
        prng.fold_in(prng.fold_in(sched.key, 1), block), sched.drop_rate,
        (sched.n,))
    return FaultStep(alive=alive, thrust_scale=scale, msg_ok=alive & ~drop)


def apply_sensor_noise(sched: FaultSchedule, t, state):
    """The state the controller senses at HL step ``t``: ``xl``, ``vl`` and
    ``w`` plus ``noise_std`` times standard normals. ``state`` carries the
    scenario axis; a shared schedule draws one noise for every scenario
    (as ``jax.vmap`` over states alone does), a per-scenario one draws each
    scenario's from its own key."""
    k = prng.fold_in(prng.fold_in(sched.key, 2), t)
    ks = prng.split(k, 3)
    std = sched.noise_std.to(state.xl.dtype)

    def noisy(x, i):
        event = x.shape[1:]
        return x + _per_key(std, len(event)) * prng.normal(
            ks[..., i, :], event, x.dtype)

    return state.replace(xl=noisy(state.xl, 0), vl=noisy(state.vl, 1),
                         w=noisy(state.w, 2))
