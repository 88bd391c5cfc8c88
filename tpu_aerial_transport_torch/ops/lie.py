"""SO(3) / Lie-group math core on tensors, batched over arbitrary leading axes.

Counterpart of ``tpu_aerial_transport/ops/lie.py``: matrix arguments use the
trailing two axes, vector arguments the trailing axis, and any leading axes
broadcast (agents, scenarios). ``random_cone_vector`` draws from an explicit
``torch.Generator`` (the JAX package's is PRNG-keyed, so the two draw
different bits from the same law).
"""

from __future__ import annotations

import math

import torch

from tpu_aerial_transport_torch import resolve_device

__all__ = [
    "hat",
    "vee",
    "hat_square",
    "expm_so3",
    "log_so3",
    "polar_project",
    "polar_project_svd",
    "rotation_a_to_b",
    "rotation_from_z",
    "random_cone_vector",
]

_SMALL_ANGLE = 1e-6


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the trailing axis, broadcasting leading axes."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (hat) map: ``v (..., 3) -> (..., 3, 3)``."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(A: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`: ``(..., 3, 3) -> (..., 3)``."""
    return torch.stack([A[..., 2, 1], A[..., 0, 2], A[..., 1, 0]], dim=-1)


def hat_square(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``hat(u) @ hat(v)`` in closed form: ``v u^T - (u . v) I``."""
    uv = torch.sum(u * v, dim=-1)[..., None, None]
    outer = v[..., :, None] * u[..., None, :]
    return outer - uv * _eye3(u)


def expm_so3(w: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential (Rodrigues), ``w (..., 3) -> (..., 3, 3)``, with
    Taylor branches below ``_SMALL_ANGLE``."""
    theta_sq = torch.sum(w * w, dim=-1)
    safe = theta_sq > _SMALL_ANGLE**2
    theta_sq_nz = torch.where(safe, theta_sq, torch.ones_like(theta_sq))
    theta_nz = torch.sqrt(theta_sq_nz)
    a = torch.where(safe, torch.sin(theta_nz) / theta_nz, 1.0 - theta_sq / 6.0)
    b = torch.where(
        safe, (1.0 - torch.cos(theta_nz)) / theta_sq_nz, 0.5 - theta_sq / 24.0
    )
    W = hat(w)
    W2 = W @ W
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm, ``(..., 3, 3) -> (..., 3)``; accurate away from pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = vee(R - R.transpose(-1, -2)) / 2.0
    sin_theta = torch.sin(theta)
    safe = sin_theta > _SMALL_ANGLE
    scale = torch.where(
        safe, theta / torch.where(safe, sin_theta, torch.ones_like(sin_theta)),
        torch.ones_like(theta),
    )
    return scale[..., None] * w


def polar_project(R: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Project onto SO(3) by Newton-Schulz, ``X <- X (3 I - X^T X) / 2``,
    for a fixed ``iters`` (8: the JAX package's count)."""
    eye3 = 3.0 * _eye3(R)
    X = R
    for _ in range(iters):
        X = 0.5 * X @ (eye3 - X.transpose(-1, -2) @ X)
    return X


def polar_project_svd(R: torch.Tensor) -> torch.Tensor:
    """SVD polar factor (set-up time constructor path)."""
    U, _, Vh = torch.linalg.svd(R)
    return U @ Vh


def rotation_a_to_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation mapping unit ``a`` to unit ``b`` (Householder pair), with
    the antipodal fallbacks ``u = a x e1`` then ``u = a x e2``."""
    e1 = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    e2 = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    u0 = a + b
    n0 = torch.sum(u0 * u0, dim=-1, keepdim=True)
    u1 = cross(a, e1.expand_as(a))
    n1 = torch.sum(u1 * u1, dim=-1, keepdim=True)
    u2 = cross(a, e2.expand_as(a))
    eps = 1e-12
    u = torch.where(n0 > eps, u0, torch.where(n1 > eps, u1, u2))
    normsq = torch.sum(u * u, dim=-1)[..., None, None]
    outer = u[..., :, None] * u[..., None, :]
    return 2.0 * outer / normsq - _eye3(a)


def rotation_from_z(q: torch.Tensor) -> torch.Tensor:
    """Zero-yaw (ZYX) rotation with ``R e3 = q`` (``q`` unit, ``q_z > 0``)."""
    sin_x = -q[..., 1]
    cos_x = torch.sqrt(torch.clamp(q[..., 0] ** 2 + q[..., 2] ** 2, min=1e-12))
    sin_y = q[..., 0] / cos_x
    cos_y = q[..., 2] / cos_x
    zero = torch.zeros_like(cos_x)
    col0 = torch.stack([cos_y, zero, -sin_y], dim=-1)
    col1 = torch.stack([sin_x * sin_y, cos_x, cos_y * sin_x], dim=-1)
    return torch.stack([col0, col1, q], dim=-1)


def random_cone_vector(generator: torch.Generator, theta: float, shape=(),
                       device="cuda") -> torch.Tensor:
    """Uniform random unit vectors ``(*shape, 3)`` within angle ``theta`` of
    +z by tan-disc sampling: a radius ``tan(theta) sqrt(u1)`` and an angle
    ``2 pi u2`` in the plane z = 1, normalised. ``theta`` must lie in (0,
    89.99 deg); ``generator`` must live on ``device``."""
    if not 0.0 < float(theta) < 89.99 * math.pi / 180.0:
        raise ValueError(f"theta must be in (0, ~pi/2), got {theta}")
    dev = resolve_device(device)
    shape = tuple(shape)
    tan_theta = float(torch.tan(torch.tensor(float(theta),
                                             dtype=torch.float32)))
    u1 = torch.rand(shape, generator=generator, dtype=torch.float32,
                    device=dev)
    u2 = torch.rand(shape, generator=generator, dtype=torch.float32,
                    device=dev)
    r = tan_theta * torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    v = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                     torch.ones_like(r)], dim=-1)
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
