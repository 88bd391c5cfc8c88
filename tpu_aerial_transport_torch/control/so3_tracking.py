"""Geometric SO(3) attitude tracking, batched over leading axes.

Counterpart of ``tpu_aerial_transport/control/so3_tracking.py``: the PD law
(Lee, Leok, McClamroch, CDC 2010, Eqs. (10), (11), (16)). The sliding-mode law
is not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from dataclasses import dataclass

from tpu_aerial_transport_torch.ops import lie


@dataclass(frozen=True)
class So3PDParams:
    k_R: float = 0.25
    k_Omega: float = 0.075


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _errors(R, Rd, w, wd):
    """``e_R = 1/2 vee(Rd^T R - R^T Rd)`` and ``e_Omega = w - R^T Rd wd``."""
    Q = Rd.transpose(-1, -2) @ R
    e_R = 0.5 * lie.vee(Q - Q.transpose(-1, -2))
    RtRd = Q.transpose(-1, -2)
    e_Omega = w - _mv(RtRd, wd)
    return e_R, e_Omega, RtRd


def _feedforward(RtRd, w, wd, dwd, J):
    """``w x Jw - J (hat(w) R^T Rd wd - R^T Rd dwd)``."""
    Jw = _mv(J, w)
    RtRd_wd = _mv(RtRd, wd)
    RtRd_dwd = _mv(RtRd, dwd)
    inner = lie.cross(w, RtRd_wd) - RtRd_dwd
    return lie.cross(w, Jw) - _mv(J, inner)


def so3_pd_tracking_control(R, Rd, w, wd, dwd, J, params: So3PDParams):
    e_R, e_Omega, RtRd = _errors(R, Rd, w, wd)
    return (
        -params.k_R * e_R
        - params.k_Omega * e_Omega
        + _feedforward(RtRd, w, wd, dwd, J)
    )
