"""Low-level per-quadrotor (thrust, moment) controller for the RQP model.

Counterpart of ``tpu_aerial_transport/control/lowlevel.py``: desired world
forces ``f_des (..., n, 3)`` -> scalar thrusts along each body z-axis and body
moments from the SO(3) PD or sliding-mode law (chosen by the gains' type)
with ``wd = dwd = 0``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_aerial_transport_torch.control import so3_tracking
from tpu_aerial_transport_torch.models.rqp import RQPParams, RQPState
from tpu_aerial_transport_torch.ops import lie


@dataclass(frozen=True)
class LowLevelController:
    J: torch.Tensor  # (n, 3, 3) quad inertias.
    so3_params: so3_tracking.So3PDParams | so3_tracking.So3SMParams

    def control(self, state: RQPState, f_des: torch.Tensor,
                thrust_scale: torch.Tensor | None = None):
        """``f_des (..., n, 3)`` -> ``(f (..., n), M (..., n, 3))``."""
        return lowlevel_control(self.J, self.so3_params, state, f_des,
                                thrust_scale)


def make_lowlevel_controller(so3_controller_type: str,
                             params: RQPParams) -> LowLevelController:
    """The PD (``"pd"``) or sliding-mode (``"sm"``) controller with the
    reference gains; another name is a ValueError."""
    if so3_controller_type == "pd":
        ll = so3_tracking.So3PDParams(k_R=0.25, k_Omega=0.075)
    elif so3_controller_type == "sm":
        ll = so3_tracking.So3SMParams(
            r=0.5, k_R=1.415, l_R=0.707, k_s=0.113, l_s=0.057
        )
    else:
        raise ValueError(
            f"so3_controller_type={so3_controller_type!r}: expected 'pd' or "
            "'sm'")
    return LowLevelController(J=params.J, so3_params=ll)


def lowlevel_control(J, so3_params, state: RQPState, f_des,
                     thrust_scale=None):
    """Batched low-level step. ``thrust_scale``: optional (..., n) actuator
    scale on both thrust and moment (0 = dead agent: zero wrench)."""
    body_z = state.R[..., :, 2]  # R_i e3.
    f = torch.sum(f_des * body_z, dim=-1)

    # A zero desired force keeps the current body axis as the attitude
    # target instead of emitting NaNs.
    norm = torch.sqrt(torch.sum(f_des * f_des, dim=-1, keepdim=True))
    qd = f_des / torch.where(norm > 0, norm, torch.ones_like(norm))
    qd = torch.where(norm > 0, qd, body_z)
    Rd = lie.rotation_from_z(qd)

    wd = torch.zeros_like(state.w)
    dwd = torch.zeros_like(state.w)
    if isinstance(so3_params, so3_tracking.So3PDParams):
        M = so3_tracking.so3_pd_tracking_control(
            state.R, Rd, state.w, wd, dwd, J, so3_params
        )
    else:
        M = so3_tracking.so3_sm_tracking_control(
            state.R, Rd, state.w, wd, dwd, J, so3_params
        )
    if thrust_scale is not None:
        f = f * thrust_scale
        M = M * thrust_scale[..., None]
    return f, M
