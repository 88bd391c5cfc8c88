"""Parameter / collision / initial-state factories for the three system
models (RQP, RP, PMRL).

Counterpart of ``tpu_aerial_transport/harness/setup.py``. For ``n == 3`` the
reference triangle geometry; otherwise a regular n-gon of circumradius 0.5.
"""

from __future__ import annotations

import numpy as np

from tpu_aerial_transport_torch.models import pmrl, rp, rqp

_REF_R3 = np.array(
    [
        [-0.42, -0.27, 0.0],
        [0.48, -0.27, 0.0],
        [-0.06, 0.55, 0.0],
    ]
)
_REF_ML = 0.225
_REF_JL = np.diag([2.1, 1.87, 3.97]) * 1e-2
_REF_MQ = 0.5
_REF_JQ = np.diag([2.32, 2.32, 4.0]) * 1e-3

_PAYLOAD_VERTICES = np.array(
    [
        [-0.42, -0.27, 0.0],
        [0.48, -0.27, 0.0],
        [-0.06, 0.55, 0.0],
        [-0.42, -0.27, -0.1],
        [0.48, -0.27, -0.1],
        [-0.06, 0.55, -0.1],
    ]
)
_PAYLOAD_MESH_VERTICES = np.array(
    [
        [-0.52, -0.37, 0.1],
        [0.58, -0.37, 0.1],
        [-0.06, 0.65, 0.1],
        [-0.52, -0.37, -0.2],
        [0.58, -0.37, -0.2],
        [-0.06, 0.65, -0.2],
    ]
)


def _attachments(n: int) -> np.ndarray:
    """Reference triangle for n=3; a regular n-gon of circumradius 0.5
    otherwise."""
    if n == 3:
        return _REF_R3.copy()
    ang = 2.0 * np.pi * np.arange(n) / n
    return np.stack(
        [0.5 * np.cos(ang), 0.5 * np.sin(ang), np.zeros(n)], axis=-1
    )


def rqp_setup(n: int = 3, device="cuda"):
    """-> (RQPParams, RQPCollision, RQPState) on ``device``."""
    params = rqp.rqp_params(
        m=np.full(n, _REF_MQ),
        J=np.tile(_REF_JQ, (n, 1, 1)),
        ml=_REF_ML,
        Jl=_REF_JL,
        r=_attachments(n),
        device=device,
    )
    col = rqp.RQPCollision(_PAYLOAD_VERTICES, _PAYLOAD_MESH_VERTICES)
    state = rqp.rqp_identity_state(n, device=device)
    return params, col, state


def rp_setup(n: int = 3, device="cuda"):
    """-> (RPParams, RPCollision, RPState) on ``device``."""
    params = rp.rp_params(ml=_REF_ML, Jl=_REF_JL, r=_attachments(n),
                          device=device)
    col = rp.RPCollision(_PAYLOAD_VERTICES, _PAYLOAD_MESH_VERTICES)
    return params, col, rp.rp_identity_state(device=device)


def pmrl_setup(n: int = 3, device="cuda"):
    """-> (PMRLParams, PMRLCollision, PMRLState) on ``device``: every link
    along +z, zero tangent velocity."""
    L = np.ones(n)
    params = pmrl.pmrl_params(m=np.full(n, _REF_MQ), ml=_REF_ML, Jl=_REF_JL,
                              r=_attachments(n), L=L, device=device)
    col = pmrl.PMRLCollision(_PAYLOAD_VERTICES, _PAYLOAD_MESH_VERTICES,
                             link_lengths=L)
    state = pmrl.pmrl_state(
        q=np.tile(np.array([0.0, 0.0, 1.0]), (n, 1)), dq=np.zeros((n, 3)),
        xl=np.zeros(3), vl=np.zeros(3), Rl=np.eye(3), wl=np.zeros(3),
        device=device)
    return params, col, state
