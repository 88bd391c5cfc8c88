"""The entry step of the port: one receding-horizon MPC period.

Counterpart of ``__graft_entry__.entry()`` of the JAX package: the RQP system
with n = 3 quadrotors in the seeded forest (seed 0), the centralized
conic-QP controller (``solver_iters=120``), the PD low level and ten 1 kHz
physics steps. One period: the forest's collision CBF rows, the centralized
control step (one early-exit launch of the whole-solve kernel on the card,
d = 67), the low-level control law once, then ten 1 ms steps with its
thrusts and moments held.

    step, (cs0, state0, acc_des) = entry()
    cs, state, stats = step(cs0, state0, acc_des)

``cs0`` and ``state0`` carry a leading scenario axis of size 1 (the port's
controllers are batched over scenarios); ``step`` takes any batch.
"""

from __future__ import annotations

import torch

from tpu_aerial_transport_torch import resolve_device
from tpu_aerial_transport_torch.control import centralized, lowlevel
from tpu_aerial_transport_torch.envs import forest as forest_mod
from tpu_aerial_transport_torch.harness import rollout, setup
from tpu_aerial_transport_torch.models import rqp
from tpu_aerial_transport_torch.obs import phases

N_AGENTS = 3
SOLVER_ITERS = 120


def entry(device="cuda"):
    """``-> (step, (cs0, state0, acc_des))``: ``step(cs, state, acc_des) ->
    (cs, state, stats)`` runs one MPC period on ``device``."""
    dev = resolve_device(device)
    params, col, state0 = setup.rqp_setup(N_AGENTS, device=dev)
    forest = forest_mod.make_forest(seed=0, device=dev)
    cfg = centralized.make_config(
        params, col.collision_radius, col.max_deceleration,
        solver_iters=SOLVER_ITERS,
    )
    f_eq = centralized.equilibrium_forces(params)
    cs0 = centralized.init_ctrl_state(params, cfg, f_eq)
    ll = lowlevel.make_lowlevel_controller("pd", params)

    def step(cs, state, acc_des):
        with phases.scope(phases.CBF_ROWS):
            env_cbf = forest_mod.collision_cbf_rows(
                forest, state.xl, state.vl, col.collision_radius,
                col.max_deceleration, cfg.vision_radius, cfg.dist_eps,
                cfg.alpha_env_cbf, cfg.n_env_cbfs,
            )
        f_des, cs, stats = centralized.control(
            params, cfg, f_eq, cs, state, acc_des, env_cbf)
        with phases.scope(phases.DYNAMICS):
            f, M = ll.control(state, f_des)
            for _ in range(10):
                state = rqp.integrate(params, state, (f, M), 1e-3)
        return cs, state, stats

    dvl_des = torch.zeros(3, dtype=torch.float32, device=dev)
    dvl_des[0] = 0.2
    acc_des = (dvl_des, torch.zeros(3, dtype=torch.float32, device=dev))
    return step, (rollout.stack_scenarios(cs0, 1),
                  rollout.stack_scenarios(state0, 1), acc_des)
