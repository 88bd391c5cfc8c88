"""Pieces of the centralized controller that the C-ADMM path shares.

Counterpart of ``equilibrium_forces`` and ``smooth_block`` in
``tpu_aerial_transport/control/centralized.py``. The centralized controller
itself is not ported yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import torch

from tpu_aerial_transport_torch.models.rqp import GRAVITY, RQPParams
from tpu_aerial_transport_torch.ops import lie


def smooth_block(cfg, R_i: torch.Tensor, w_i: torch.Tensor) -> torch.Tensor:
    """Hessian block ``2 k_smooth Rq_orth Rq_orth^T`` of the optional
    force-smoothing cost, ``Rq = R_i exp3(w_i dt)``; batched over leading
    axes of ``R_i (..., 3, 3)`` and ``w_i (..., 3)``."""
    Rq = R_i @ lie.expm_so3(w_i * cfg.dt)
    Rq_orth = Rq[..., :, :2]
    return 2.0 * cfg.k_smooth * (Rq_orth @ Rq_orth.transpose(-1, -2))


def equilibrium_forces(params: RQPParams, alive=None) -> torch.Tensor:
    """Static equilibrium forces ``f_eq (n, 3)``: vertical thrusts that are
    the minimum-norm solution of the 3 x n wrench balance
    ``[1; (r_com_i x e3)_xy] fz = [mT g; 0; 0]``.

    The minimum-norm solution is taken in closed form,
    ``fz = W^T (W W^T)^-1 rhs`` (``W W^T`` is a well-conditioned 3 x 3), not
    with ``torch.linalg.lstsq``, which on CUDA (``gels`` only) does not
    return it.
    ``alive`` (optional (n,) mask) zeroes dead agents' columns and takes the
    pseudo-inverse, so the survivors carry the load."""
    n = params.n
    dtype, dev = params.r.dtype, params.r.device
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    rxe = lie.cross(params.r_com, e3)
    wrench = torch.cat(
        [torch.ones((n, 1), dtype=dtype, device=dev), rxe[:, :2]], dim=1
    ).T
    rhs = torch.stack([
        params.mT * GRAVITY, torch.zeros((), dtype=dtype, device=dev),
        torch.zeros((), dtype=dtype, device=dev),
    ])
    if alive is None:
        fz = wrench.T @ torch.linalg.solve(wrench @ wrench.T, rhs)
    else:
        w = torch.as_tensor(alive, device=dev).to(dtype)
        fz = w * (torch.linalg.pinv(wrench * w[None, :]) @ rhs)
    return torch.cat(
        [torch.zeros((n, 2), dtype=dtype, device=dev), fz[:, None]], dim=1
    )
