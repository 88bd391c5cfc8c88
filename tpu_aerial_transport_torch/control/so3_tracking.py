"""Geometric SO(3) attitude tracking, batched over leading axes.

Counterpart of ``tpu_aerial_transport/control/so3_tracking.py``: the PD law
(Lee, Leok, McClamroch, CDC 2010, Eqs. (10), (11), (16)) and the finite-time
sliding-mode law (Lee, TCST 2018, Eqs. (34)-(36)), the latter with the JAX
package's fractional Jacobian ``l_R r diag((|e_R| + eps)^(r - 1))``.

The PD gains are Python floats on the graphed forward path (the substeps
replay from a CUDA graph, so nothing may copy from the host) and 0-d
tensors on the state's device on the differentiated path
(``harness/diff.py``), where autograd carries them into the gradient; both
multiply the errors as they are. The sliding-mode law's gains and exponent
are Python floats.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_aerial_transport_torch.ops import lie

_EPS = 1e-6


@dataclass(frozen=True)
class So3PDParams:
    """Python floats, or 0-d tensors on the state's device to differentiate
    in the gains."""

    k_R: float | torch.Tensor = 0.25
    k_Omega: float | torch.Tensor = 0.075


@dataclass(frozen=True)
class So3SMParams:
    r: float = 0.5
    k_R: float = 1.415
    l_R: float = 0.707
    k_s: float = 0.113
    l_s: float = 0.057


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


def _sig(y: torch.Tensor, r: float) -> torch.Tensor:
    """``|y|^r sign(y)``."""
    return torch.pow(torch.abs(y), r) * torch.sign(y)


def so3_sm_tracking_control(R, Rd, w, wd, dwd, J, params: So3SMParams):
    r = float(params.r)
    e_R, e_Omega, RtRd = _errors(R, Rd, w, wd)
    trace = RtRd[..., 0, 0] + RtRd[..., 1, 1] + RtRd[..., 2, 2]
    # 0.5 (tr(R^T Rd) I - R^T Rd), the eye from the trace (no constant).
    E = 0.5 * (torch.diag_embed(trace[..., None].expand(e_R.shape)) - RtRd)
    s = e_Omega + params.k_R * e_R + params.l_R * _sig(e_R, r)
    # d/dt [l_R S(e_R)] = l_R r diag((|e_R| + eps)^(r - 1)) E e_Omega.
    frac = torch.pow(torch.abs(e_R) + _EPS, r - 1.0)
    E_eOm = _mv(E, e_Omega)
    JE = _mv(J, E_eOm)
    J_frac = _mv(J, frac * E_eOm)
    return (
        -params.k_s * s
        - params.l_s * _sig(s, r)
        - params.k_R * JE
        - params.l_R * r * J_frac
        + _feedforward(RtRd, w, wd, dwd, J)
    )
