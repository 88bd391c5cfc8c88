"""Differentiable simulation: gradient-based tuning through the physics, on
torch autograd.

Counterpart of ``tpu_aerial_transport/harness/diff.py``: the two-rate
cascade (the 1 kHz low-level SO(3) PD law inside manifold-integrator
substeps) is differentiated end to end, so controller gains, a physical
parameter (the payload mass) or a plan are tuned by gradient descent
against a rollout loss. The high-level force law is a differentiable
payload-space PD share, not the conic-QP controllers (the JAX module says
why); none of the port's CUDA kernels lies on this path.

- The substeps run eagerly here: the forward-only CUDA graph of
  :mod:`harness.cuda_graph` hides its ops from autograd.
- ``jax.checkpoint`` on the per-MPC-step function becomes
  ``torch.utils.checkpoint.checkpoint`` (non-reentrant, so the step takes
  an ``RQPState`` and a dict; no RNG state stashed, which a CUDA-graph
  capture refuses, and the path draws no random numbers): the backward
  sweep recomputes each step's substeps instead of storing them.
- A loss is ``loss(gains, state0) -> 0-d tensor``; :func:`value_and_grad`
  is ``jax.value_and_grad(loss)(gains, state0)``.
- :func:`tune_gains` is the JAX package's one jitted descent program: on
  the card one descent iteration (value, gradient, update, projection,
  best-iterate select) is captured once into a CUDA graph and replayed
  ``iters + 1`` times; ``graph=False`` runs the same iteration eagerly,
  which is also the CPU path.

Gains are 0-d float32 tensors on the state's device (a tensor elsewhere is
a ValueError: it would copy from the host at every use, which a capture
refuses).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpu_aerial_transport_torch.control import lowlevel as lowlevel_mod
from tpu_aerial_transport_torch.control import so3_tracking
from tpu_aerial_transport_torch.models import rqp
from tpu_aerial_transport_torch.models.rqp import RQPParams, RQPState
from tpu_aerial_transport_torch.ops import lie

OPTIMIZERS = ("sgd", "adam")
# ``optax.adam``'s defaults: b1, b2, eps, eps_root.
ADAM_B1, ADAM_B2, ADAM_EPS, ADAM_EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
# Eager descent iterations on a side stream before the capture: the first
# creates the library handles, workspaces and the autograd engine's device
# thread, which must not happen inside the capture.
WARMUP_ITERS = 1
# Captures and replays of the descent graph, in this process.
GRAPH_COUNTS = {"captures": 0, "replays": 0}


def _on_device(x, dev: torch.device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``dev``: a tensor must already be there;
    a number or array is copied from the host."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(
                f"a gain or parameter on {x.device}, the state on {dev}: make "
                "it on the state's device")
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _checkpointed(fn: Callable) -> Callable:
    def step(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    return step


def substep_rollout(
    params: RQPParams,
    gains: dict,
    state: RQPState,
    f_des: torch.Tensor,
    n_sub: int = 10,
    dt: float = 1e-3,
) -> RQPState:
    """The 1 kHz inner loop under a fixed high-level command: ``n_sub``
    substeps of SO(3)-PD low-level control (gains ``gains["k_R"]``,
    ``gains["k_Omega"]``) + manifold integration, in a Python loop. The one
    rollout every function here shares, so a recorded and a replayed
    trajectory come from the same code."""
    dev = state.xl.device
    ll = so3_tracking.So3PDParams(
        k_R=_on_device(gains["k_R"], dev),
        k_Omega=_on_device(gains["k_Omega"], dev))
    for _ in range(n_sub):
        f, M = lowlevel_mod.lowlevel_control(params.J, ll, state, f_des)
        state = rqp.integrate(params, state, (f, M), dt)
    return state


def payload_pd_forces(
    params: RQPParams,
    f_eq: torch.Tensor,
    state: RQPState,
    xl_ref: torch.Tensor,
    k_p: float = 2.0,
    k_d: float = 2.5,
) -> torch.Tensor:
    """Equilibrium shares plus an equal-share payload-acceleration PD demand
    toward ``xl_ref``: ``f_des_i = f_eq_i + (mT / n) (k_p (xl_ref - xl) -
    k_d vl)``."""
    acc = k_p * (xl_ref - state.xl) - k_d * state.vl
    share = (params.mT / params.n) * acc
    return f_eq + share[None, :]


def make_rollout_loss(
    params: RQPParams,
    f_eq: torch.Tensor,
    xl_ref: torch.Tensor,
    n_steps: int = 50,
    n_sub: int = 10,
    dt: float = 1e-3,
    remat: bool = True,
    k_p: float = 2.0,
    k_d: float = 2.5,
    k_att: float = 0.0,
) -> Callable:
    """``loss(gains, state0) -> 0-d tensor``: the mean over ``n_steps``
    MPC-rate steps of the squared payload position error to ``xl_ref`` plus
    0.1 x the squared payload velocity, and with ``k_att`` the attitude
    term ``k_att sum_i tr(I - Rd_i^T R_i)``. ``remat=True`` checkpoints
    each step, so the backward pass recomputes its substeps."""

    def mpc_step(state: RQPState, gains):
        f_des = payload_pd_forces(params, f_eq, state, xl_ref, k_p, k_d)
        state = substep_rollout(params, gains, state, f_des, n_sub, dt)
        err = state.xl - xl_ref
        cost = torch.sum(err * err) + 0.1 * torch.sum(state.vl * state.vl)
        if k_att:
            qd = f_des / torch.linalg.vector_norm(f_des, dim=-1, keepdim=True)
            Rd = lie.rotation_from_z(qd)
            align = torch.einsum("nij,nij->", Rd, state.R)  # sum tr(Rd^T R)
            cost = cost + k_att * (3.0 * params.n - align)
        return state, cost

    step = _checkpointed(mpc_step) if remat else mpc_step

    def loss(gains, state0: RQPState) -> torch.Tensor:
        state, costs = state0, []
        for _ in range(n_steps):
            state, c = step(state, gains)
            costs.append(c)
        return torch.mean(torch.stack(costs))

    return loss


def simulate_commands(
    params: RQPParams,
    gains: dict,
    f_des_seq: torch.Tensor,
    state0: RQPState,
    n_sub: int = 10,
    dt: float = 1e-3,
    remat: bool = True,
):
    """Roll the model under a recorded command sequence ``f_des_seq (T, n,
    3)`` (the low-level loop still closes on the simulated state): returns
    ``(xl_seq (T, 3), vl_seq (T, 3))`` at the MPC rate."""

    def mpc_step(state: RQPState, f_des):
        return substep_rollout(params, gains, state, f_des, n_sub, dt)

    step = _checkpointed(mpc_step) if remat else mpc_step
    state, xl, vl = state0, [], []
    for f_des in f_des_seq:
        state = step(state, f_des)
        xl.append(state.xl)
        vl.append(state.vl)
    return torch.stack(xl), torch.stack(vl)


def make_sysid_loss(
    m,
    J,
    Jl,
    r,
    gains: dict,
    f_des_seq: torch.Tensor,
    xl_obs: torch.Tensor,
    vl_obs: torch.Tensor,
    n_sub: int = 10,
    dt: float = 1e-3,
) -> Callable:
    """System identification by gradient: ``loss(theta, state0)`` replays
    the recorded commands through a model with payload mass ``ml =
    exp(theta["log_ml"])`` and scores the trajectory mismatch against the
    observations. :func:`models.rqp.rqp_params` rebuilds every derived
    quantity inside the differentiated graph. ``m``, ``J``, ``Jl``, ``r``
    are moved to the recording's device once, here."""
    dev = f_des_seq.device
    m, J, Jl, r = (rqp._f32(v, dev) for v in (m, J, Jl, r))

    def loss(theta, state0: RQPState) -> torch.Tensor:
        params = rqp.rqp_params(m, J, torch.exp(theta["log_ml"]), Jl, r,
                                device=dev)
        xl_seq, vl_seq = simulate_commands(
            params, gains, f_des_seq, state0, n_sub=n_sub, dt=dt)
        exl = xl_seq - xl_obs
        evl = vl_seq - vl_obs
        return torch.mean(torch.sum(exl * exl, -1)
                          + 0.1 * torch.sum(evl * evl, -1))

    return loss


def make_trajopt_loss(
    params: RQPParams,
    f_eq: torch.Tensor,
    goal: torch.Tensor,
    n_steps: int = 40,
    n_sub: int = 10,
    dt: float = 1e-3,
    gains: dict | None = None,
    obstacle_xy: torch.Tensor | None = None,
    obstacle_radius: float = 0.5,
    w_effort: float = 1e-3,
    w_obstacle: float = 30.0,
) -> Callable:
    """Single-shooting trajectory optimisation: ``loss(plan, state0)`` rolls
    the cascade under a per-step payload-acceleration schedule
    ``plan["acc"] (n_steps, 3)`` (:func:`plan_share_forces`) and scores the
    terminal goal distance + 0.1 x the terminal speed squared + control
    effort + a squared hinge on an xy-cylinder of radius
    ``obstacle_radius``. A plan of another horizon is a ValueError. The
    gains default to the reference's 0.25 / 0.075, made on the state's
    device at each call."""

    def mpc_step(state: RQPState, acc, gains):
        state = substep_rollout(
            params, gains, state, plan_share_forces(params, f_eq, acc),
            n_sub, dt)
        cost = w_effort * torch.sum(acc * acc)
        if obstacle_xy is not None:
            d = torch.linalg.vector_norm(state.xl[:2] - obstacle_xy)
            cost = cost + w_obstacle * torch.clamp(
                obstacle_radius - d, min=0.0) ** 2
        return state, cost

    step = _checkpointed(mpc_step)

    def loss(plan, state0: RQPState) -> torch.Tensor:
        if plan["acc"].shape[0] != n_steps:
            raise ValueError(
                f"plan horizon {plan['acc'].shape[0]} != n_steps {n_steps}"
            )
        dev = state0.xl.device
        g = gains or {"k_R": torch.full((), 0.25, device=dev),
                      "k_Omega": torch.full((), 0.075, device=dev)}
        state, costs = state0, []
        for acc in plan["acc"]:
            state, c = step(state, acc, g)
            costs.append(c)
        err = state.xl - goal
        vel = state.vl
        return (torch.sum(err * err) + 0.1 * torch.sum(vel * vel)
                + torch.sum(torch.stack(costs)))

    return loss


def plan_share_forces(params: RQPParams, f_eq: torch.Tensor,
                      acc: torch.Tensor) -> torch.Tensor:
    """The trajopt plan's force law: equilibrium shares plus an equal-share
    payload-acceleration demand."""
    return f_eq + (params.mT / params.n) * acc[None, :]


def value_and_grad(loss: Callable, gains: dict, state0: RQPState):
    """``jax.value_and_grad(loss)(gains, state0)``: the loss (detached) and
    a dict of its gradients in each leaf of ``gains`` (tensors on the
    state's device, or numbers)."""
    dev = state0.xl.device
    leaves = {k: _on_device(v, dev).detach().clone().requires_grad_(True)
              for k, v in gains.items()}
    with torch.enable_grad():
        val = loss(leaves, state0)
        grads = torch.autograd.grad(val, list(leaves.values()))
    return val.detach(), dict(zip(leaves, grads))


class Descent:
    """:func:`tune_gains`'s descent: its static buffers (the gains leaves,
    the optimiser state, the best iterate and its value, a value slot) and
    one iteration on them, so that a CUDA graph of :meth:`iteration`
    replays it (:data:`GRAPH_COUNTS` counts the captures and replays)."""

    def __init__(self, loss, gains0, state0, lr=0.05, min_gain=1e-4,
                 optimizer="sgd"):
        if optimizer not in OPTIMIZERS:
            raise ValueError(optimizer)
        dev = state0.xl.device
        self.loss, self.state0 = loss, state0
        self.lr, self.min_gain, self.adam = lr, min_gain, optimizer == "adam"
        self.gains0 = {k: _on_device(v, dev).detach().clone()
                       for k, v in gains0.items()}
        self.gains = {k: v.clone().requires_grad_(True)
                      for k, v in self.gains0.items()}
        self.best = {k: v.clone() for k, v in self.gains0.items()}
        self.best_val = torch.full((), math.inf, device=dev)
        self.val = torch.zeros((), device=dev)
        self.mu = {k: torch.zeros_like(v) for k, v in self.gains0.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.gains0.items()}
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        self.graph = None

    @torch.no_grad()
    def reset(self):
        """The buffers as a descent starts them."""
        for k, g0 in self.gains0.items():
            self.gains[k].copy_(g0)
            self.best[k].copy_(g0)
            self.mu[k].zero_()
            self.nu[k].zero_()
        self.best_val.fill_(math.inf)
        self.count.zero_()

    def _project(self, g):
        return g if self.min_gain is None else torch.clamp(g, min=self.min_gain)

    def iteration(self):
        """Value and gradient at the current gains, the best-iterate select
        (no host synchronisation), the update and the projection. The value
        lands in ``self.val``."""
        keys = list(self.gains)
        with torch.enable_grad():
            val = self.loss(self.gains, self.state0)
            grads = torch.autograd.grad(val, [self.gains[k] for k in keys])
        with torch.no_grad():
            better = val < self.best_val
            for k in keys:
                self.best[k].copy_(torch.where(better, self.gains[k],
                                               self.best[k]))
            self.best_val.copy_(torch.minimum(self.best_val, val))
            if self.adam:  # optax.adam(lr), in optax's order.
                self.count.add_(1)
                t = self.count.to(torch.float32)
                c1 = 1.0 - torch.pow(ADAM_B1, t)
                c2 = 1.0 - torch.pow(ADAM_B2, t)
            for k, d in zip(keys, grads):
                g = self.gains[k]
                if self.adam:
                    mu = (1.0 - ADAM_B1) * d + ADAM_B1 * self.mu[k]
                    nu = (1.0 - ADAM_B2) * (d * d) + ADAM_B2 * self.nu[k]
                    self.mu[k].copy_(mu)
                    self.nu[k].copy_(nu)
                    u = (mu / c1) / (torch.sqrt(nu / c2 + ADAM_EPS_ROOT)
                                     + ADAM_EPS)
                    new = g + (-self.lr) * u
                else:
                    new = g - self.lr * d
                g.copy_(self._project(new))
            self.val.copy_(val)

    def capture(self):
        """Capture one iteration into a CUDA graph (state on the card),
        after ``WARMUP_ITERS`` eager iterations on a side stream; the
        buffers are reset after the warm-up. A capture that fails raises."""
        if self.state0.xl.device.type != "cuda":
            raise ValueError("Descent.capture: the state is not on the card")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_ITERS):
                self.iteration()
        torch.cuda.current_stream().wait_stream(side)
        self.reset()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.iteration()
        self.graph = graph
        GRAPH_COUNTS["captures"] += 1

    def step(self):
        """One iteration: a replay of the graph once captured, else eager."""
        if self.graph is None:
            self.iteration()
            return
        self.graph.replay()
        GRAPH_COUNTS["replays"] += 1

    def run(self, iters: int):
        """``(best_gains, hist (iters + 1,))`` from the start: ``iters + 1``
        steps, each value copied into ``hist`` by one device op; the last
        step's value is the loss at the final gains and its update is
        discarded."""
        self.reset()
        hist = torch.empty(iters + 1, device=self.val.device)
        for i in range(iters + 1):
            self.step()
            hist[i].copy_(self.val)
        return {k: v.clone() for k, v in self.best.items()}, hist


def tune_gains(
    loss: Callable,
    gains0: dict,
    state0: RQPState,
    lr: float = 0.05,
    iters: int = 30,
    min_gain: float | None = 1e-4,
    optimizer: str = "sgd",
    graph: bool = True,
):
    """Projected gradient descent on ``loss``. ``min_gain`` floors every
    parameter after each step (``None`` for unconstrained parameters such as
    ``make_sysid_loss``'s ``log_ml``). ``optimizer``: ``"sgd"`` or
    ``"adam"`` (``optax.adam(lr)``: b1 0.9, b2 0.999, eps 1e-8,
    bias-corrected); another name is a ValueError.

    Returns ``(best_gains, hist (iters + 1,))``: the best iterate seen, not
    the last, and the loss at each iterate, the last entry the loss at the
    final gains (compared with the best too). Everything stays on the
    state's device: no host synchronisation inside the loop.

    On the card (``graph=True``) one iteration is captured into a CUDA
    graph (:meth:`Descent.capture`) and replayed ``iters + 1`` times, the
    counterpart of the JAX package's one jitted descent program; a capture
    that fails raises. ``graph=False``, and every CPU run, calls the same
    iteration eagerly."""
    d = Descent(loss, gains0, state0, lr, min_gain, optimizer)
    if graph and state0.xl.device.type == "cuda":
        d.capture()
    return d.run(iters)
