"""Plain PyTorch reference of one RQP MPC step: the benchmark's yardstick.

A frozen copy of the port's plain paths as they stood when the benchmark
was written, cut to what the benchmark's configurations run: the RQP model
and its integrator, the PD low level, the dense forest query and its
collision CBF rows, the plain ("scan") ADMM solver of the conic QPs, the
nominal consensus-ADMM step (Schur-reduced agent QPs, fixed effort, one
program) and the centralized step. It imports torch and numpy only: nothing
of the program and nothing of JAX. Everything it needs it works out again
from the configuration (parameters, Schur plan, constants); the tree
positions are the raw input both sides read.

Every matrix product goes through :class:`Numerics`, so the same code runs
in float32 (``tf32=False``, the precision the configurations state) and, as
the control that the comparison must fail, with every product's operands
rounded to TF32 first, which is what a TF32 tensor-core product does with
float32 inputs. Dot products over 2- and 3-vectors are matrix products here
too (in the program they are explicit products and adds): TF32 would reach
them if they were written so.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

GRAVITY = 9.80665
PROJECTION_PERIOD = 20
QUADROTOR_RADIUS = 0.3
MAX_DECELERATION = GRAVITY / 5.0
INF = 1e20
EQ_RHO_SCALE = 1e3
TILE = 8
AGENT_SOC = (4, 4)
BARK_RADIUS = 0.3
BARK_HEIGHT = 4.0
NEAR_BRAKE_TIME = 0.2
_GRID_PTS = 33
_REFINE_ITERS = 12
_INV_PHI = 0.6180339887498949
_SMALL_ANGLE = 1e-6

_REF_ML = 0.225
_REF_JL = np.diag([2.1, 1.87, 3.97]) * 1e-2
_REF_MQ = 0.5
_REF_JQ = np.diag([2.32, 2.32, 4.0]) * 1e-3
_REF_R3 = np.array([[-0.42, -0.27, 0.0], [0.48, -0.27, 0.0],
                    [-0.06, 0.55, 0.0]])
_PAYLOAD_MESH_VERTICES = np.array([
    [-0.52, -0.37, 0.1], [0.58, -0.37, 0.1], [-0.06, 0.65, 0.1],
    [-0.52, -0.37, -0.2], [0.58, -0.37, -0.2], [-0.06, 0.65, -0.2]])


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32: 10 mantissa bits, to nearest with
    ties away from zero (PTX ``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Numerics:
    """How the reference multiplies: float32, or TF32 operands
    (``tf32=True``, the control) with float32 sums."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def mv(self, M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return self.mm(M, v[..., None])[..., 0]

    def dot(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        u, v = torch.broadcast_tensors(u, v)
        return self.mm(u[..., None, :], v[..., :, None])[..., 0, 0]

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(v, v))


# ---------------------------------------------------------------- SO(3)

def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def hat(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], dim=-1),
                        torch.stack([z, zero, -x], dim=-1),
                        torch.stack([-y, x, zero], dim=-1)], dim=-2)


def vee(A):
    return torch.stack([A[..., 2, 1], A[..., 0, 2], A[..., 1, 0]], dim=-1)


def hat_square(u, v):
    """``hat(u) hat(v) = v u^T - (u . v) I``."""
    uv = torch.sum(u * v, dim=-1)[..., None, None]
    return v[..., :, None] * u[..., None, :] - uv * _eye3(u)


def expm_so3(nx: Numerics, w):
    theta_sq = torch.sum(w * w, dim=-1)
    safe = theta_sq > _SMALL_ANGLE ** 2
    theta_sq_nz = torch.where(safe, theta_sq, torch.ones_like(theta_sq))
    theta_nz = torch.sqrt(theta_sq_nz)
    a = torch.where(safe, torch.sin(theta_nz) / theta_nz, 1.0 - theta_sq / 6.0)
    b = torch.where(safe, (1.0 - torch.cos(theta_nz)) / theta_sq_nz,
                    0.5 - theta_sq / 24.0)
    W = hat(w)
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * nx.mm(W, W)


def polar_project(nx: Numerics, R, iters: int = 8):
    """Newton-Schulz ``X <- X (3 I - X^T X) / 2``."""
    eye3 = 3.0 * _eye3(R)
    X = R
    for _ in range(iters):
        X = nx.mm(0.5 * X, eye3 - nx.mm(X.transpose(-1, -2), X))
    return X


def rotation_from_z(q):
    """Zero-yaw (ZYX) rotation with ``R e3 = q``."""
    sin_x = -q[..., 1]
    cos_x = torch.sqrt(torch.clamp(q[..., 0] ** 2 + q[..., 2] ** 2, min=1e-12))
    sin_y = q[..., 0] / cos_x
    cos_y = q[..., 2] / cos_x
    zero = torch.zeros_like(cos_x)
    col0 = torch.stack([cos_y, zero, -sin_y], dim=-1)
    col1 = torch.stack([sin_x * sin_y, cos_x, cos_y * sin_x], dim=-1)
    return torch.stack([col0, col1, q], dim=-1)


# ---------------------------------------------------------------- model

@dataclass(frozen=True)
class Params:
    m: torch.Tensor
    J: torch.Tensor
    ml: torch.Tensor
    Jl: torch.Tensor
    r: torch.Tensor
    mT: torch.Tensor
    x_com: torch.Tensor
    r_com: torch.Tensor
    JT: torch.Tensor
    JT_inv: torch.Tensor
    J_inv: torch.Tensor

    @property
    def n(self) -> int:
        return self.r.shape[0]


class State(NamedTuple):
    """The RQP state, leading scenario axis on every leaf."""

    R: torch.Tensor  # (S, n, 3, 3)
    w: torch.Tensor  # (S, n, 3)
    xl: torch.Tensor  # (S, 3)
    vl: torch.Tensor  # (S, 3)
    Rl: torch.Tensor  # (S, 3, 3)
    wl: torch.Tensor  # (S, 3)
    step: torch.Tensor  # (S,) int32


def attachments(n: int) -> np.ndarray:
    if n == 3:
        return _REF_R3.copy()
    ang = 2.0 * np.pi * np.arange(n) / n
    return np.stack([0.5 * np.cos(ang), 0.5 * np.sin(ang), np.zeros(n)], -1)


def make_params(n: int, device) -> Params:
    """The reference set-up's parameters (float32 from float32-rounded
    inputs)."""
    f32 = dict(dtype=torch.float32, device=device)
    m = torch.as_tensor(np.full(n, _REF_MQ), **f32)
    J = torch.as_tensor(np.tile(_REF_JQ, (n, 1, 1)), **f32)
    ml = torch.as_tensor(np.asarray(_REF_ML), **f32)
    Jl = torch.as_tensor(_REF_JL, **f32)
    r = torch.as_tensor(attachments(n), **f32)
    mT = torch.sum(m) + ml
    x_com = torch.sum(r * m[:, None], dim=0) / mT
    r_com = r - x_com
    JT = (Jl - ml * hat_square(x_com, x_com)
          - torch.sum(m[:, None, None] * hat_square(r_com, r_com), dim=0))
    return Params(m=m, J=J, ml=ml, Jl=Jl, r=r, mT=mT, x_com=x_com,
                  r_com=r_com, JT=JT, JT_inv=torch.linalg.inv_ex(JT).inverse,
                  J_inv=torch.linalg.inv_ex(J).inverse)


def collision_radius() -> float:
    return float(np.max(np.linalg.norm(_PAYLOAD_MESH_VERTICES, axis=1))
                 + QUADROTOR_RADIUS + 0.1)


def identity_state(n: int, S: int, device) -> State:
    f32 = dict(dtype=torch.float32, device=device)
    return State(R=torch.eye(3, **f32).expand(S, n, 3, 3).clone(),
                 w=torch.zeros((S, n, 3), **f32),
                 xl=torch.zeros((S, 3), **f32), vl=torch.zeros((S, 3), **f32),
                 Rl=torch.eye(3, **f32).expand(S, 3, 3).clone(),
                 wl=torch.zeros((S, 3), **f32),
                 step=torch.zeros((S,), dtype=torch.int32, device=device))


def forward_dynamics(nx: Numerics, p: Params, s: State, f, M):
    gravity = torch.zeros(3, dtype=s.xl.dtype, device=s.xl.device)
    gravity[2] = -GRAVITY
    Jw = nx.mv(p.J, s.w)
    dw = nx.mv(p.J_inv, M - cross(s.w, Jw))
    quad_force = s.R[..., :, 2] * f[..., None]
    dv_com = torch.sum(quad_force, dim=-2) / p.mT + gravity
    force_body = nx.mm(quad_force, s.Rl)
    net_moment = torch.sum(cross(p.r_com, force_body), dim=-2)
    JTwl = nx.mv(p.JT, s.wl)
    dwl = nx.mv(p.JT_inv, net_moment - cross(s.wl, JTwl))
    corr = nx.mv(hat_square(s.wl, s.wl) + hat(dwl), p.x_com)
    dvl = dv_com - nx.mv(s.Rl, corr)
    return dw, dvl, dwl


def integrate(nx: Numerics, p: Params, s: State, f, M, dt: float) -> State:
    """Semi-implicit trapezoidal manifold step, Newton-Schulz re-projection
    every ``PROJECTION_PERIOD`` steps of each scenario's counter."""
    dw, dvl, dwl = forward_dynamics(nx, p, s, f, M)
    R = nx.mm(s.R, expm_so3(nx, (s.w + dw * (dt / 2)) * dt))
    w = s.w + dw * dt
    xl = s.xl + s.vl * dt + dvl * (dt ** 2 / 2)
    vl = s.vl + dvl * dt
    Rl = nx.mm(s.Rl, expm_so3(nx, (s.wl + dwl * (dt / 2)) * dt))
    wl = s.wl + dwl * dt
    step = s.step + 1
    project = step >= PROJECTION_PERIOD
    R = torch.where(project[..., None, None, None], polar_project(nx, R), R)
    Rl = torch.where(project[..., None, None], polar_project(nx, Rl), Rl)
    step = torch.where(project, torch.zeros_like(step), step)
    return State(R=R, w=w, xl=xl, vl=vl, Rl=Rl, wl=wl, step=step)


def pd_lowlevel(nx: Numerics, p: Params, s: State, f_des,
                k_R: float = 0.25, k_Omega: float = 0.075):
    """Desired world forces -> (thrusts, body moments): the geometric SO(3)
    PD law with ``wd = dwd = 0``."""
    body_z = s.R[..., :, 2]
    f = torch.sum(f_des * body_z, dim=-1)
    norm = torch.sqrt(torch.sum(f_des * f_des, dim=-1, keepdim=True))
    qd = f_des / torch.where(norm > 0, norm, torch.ones_like(norm))
    qd = torch.where(norm > 0, qd, body_z)
    Rd = rotation_from_z(qd)
    Q = nx.mm(Rd.transpose(-1, -2), s.R)
    e_R = 0.5 * vee(Q - Q.transpose(-1, -2))
    RtRd = Q.transpose(-1, -2)
    wd = torch.zeros_like(s.w)
    e_Omega = s.w - nx.mv(RtRd, wd)
    Jw = nx.mv(p.J, s.w)
    inner = cross(s.w, nx.mv(RtRd, wd)) - nx.mv(RtRd, wd)
    ff = cross(s.w, Jw) - nx.mv(p.J, inner)
    return f, -k_R * e_R - k_Omega * e_Omega + ff


def substeps(nx: Numerics, p: Params, s: State, f_des, n_sub: int,
             dt: float) -> State:
    """``n_sub`` steps of low-level control and physics at ``dt``."""
    for _ in range(n_sub):
        f, M = pd_lowlevel(nx, p, s, f_des)
        s = integrate(nx, p, s, f, M, dt)
    return s


# ---------------------------------------------------------------- forest

class Forest(NamedTuple):
    tree_pos: torch.Tensor  # (N, 3), invalid slots far away.
    tree_valid: torch.Tensor  # (N,) bool.


def point_cylinder_distance(nx, p, center, radius, half_height):
    dxy = p[..., :2] - center[..., :2]
    rho = nx.norm(dxy)
    dz = p[..., 2] - center[..., 2]
    d_rad = rho - radius
    d_ax = torch.abs(dz) - half_height
    dr_pos = torch.clamp(d_rad, min=0.0)
    da_pos = torch.clamp(d_ax, min=0.0)
    outside = torch.sqrt(dr_pos * dr_pos + da_pos * da_pos)
    inside = torch.maximum(d_rad, d_ax)
    is_inside = (d_rad <= 0.0) & (d_ax <= 0.0)
    dist = torch.where(is_inside, inside, outside)
    on_axis = rho <= 1e-12
    safe_rho = torch.where(on_axis, torch.ones_like(rho), rho)
    x_dir = torch.zeros_like(dxy)
    x_dir[..., 0] = 1.0
    u = torch.where(on_axis[..., None], x_dir, dxy / safe_rho[..., None])
    wall_closer = d_rad >= d_ax
    ext_xy = center[..., :2] + u * torch.clamp(rho, max=radius)[..., None]
    ext_z = center[..., 2] + torch.clamp(dz, -half_height, half_height)
    int_xy = torch.where(wall_closer[..., None], center[..., :2] + u * radius,
                         p[..., :2])
    half = torch.full_like(dz, half_height)
    cap_z = center[..., 2] + torch.where(dz >= 0.0, half, -half)
    int_z = torch.where(wall_closer, p[..., 2], cap_z)
    cp_xy = torch.where(is_inside[..., None], int_xy, ext_xy)
    cp_z = torch.where(is_inside, int_z, ext_z)
    return dist, torch.cat([cp_xy, cp_z[..., None]], dim=-1)


def segment_cylinder_distance(nx, a, b, center, radius, half_height):
    """A ``_GRID_PTS`` bracket of ``t -> dist(a + t (b - a))``, then
    ``_REFINE_ITERS`` golden-section steps."""
    ab = b - a

    def dist_at(t, a_, ab_, c_):
        return point_cylinder_distance(nx, a_ + t[..., None] * ab_, c_,
                                       radius, half_height)[0]

    ts = torch.arange(_GRID_PTS, dtype=a.dtype, device=a.device) / (
        _GRID_PTS - 1)
    grid_d = dist_at(ts, a[..., None, :], ab[..., None, :],
                     center[..., None, :])
    i_f = torch.argmin(grid_d, dim=-1).to(a.dtype)
    cell = 1.0 / (_GRID_PTS - 1)
    t_lo = torch.clamp(i_f * cell - cell, 0.0, 1.0)
    t_hi = torch.clamp(i_f * cell + cell, 0.0, 1.0)
    for _ in range(_REFINE_ITERS):
        m1 = t_hi - _INV_PHI * (t_hi - t_lo)
        m2 = t_lo + _INV_PHI * (t_hi - t_lo)
        smaller1 = dist_at(m1, a, ab, center) < dist_at(m2, a, ab, center)
        t_lo, t_hi = (torch.where(smaller1, t_lo, m1),
                      torch.where(smaller1, m2, t_hi))
    t = 0.5 * (t_lo + t_hi)
    p = a + t[..., None] * ab
    dist, closest = point_cylinder_distance(nx, p, center, radius, half_height)
    return dist, p, closest


class Distance(NamedTuple):
    dists: torch.Tensor
    pts_sys: torch.Tensor
    normal_out: torch.Tensor
    mask: torch.Tensor


def capsule_distance(nx, forest: Forest, cap_a, cap_b, cap_radius,
                     vision_radius) -> Distance:
    """The dense sweep of every tree slot from each scenario's capsule."""
    centers = forest.tree_pos
    dist_axis, p_seg, p_cyl = segment_cylinder_distance(
        nx, cap_a[..., None, :], cap_b[..., None, :], centers, BARK_RADIUS,
        BARK_HEIGHT / 2.0)
    dists = dist_axis - cap_radius
    normal = p_cyl - p_seg
    nn = nx.norm(normal)[..., None]
    valid_n = nn[..., 0] > 1e-12
    normal = normal / torch.where(nn > 1e-12, nn, torch.ones_like(nn))
    pts_sys = p_seg + cap_radius * normal
    radial = p_seg[..., :2] - centers[..., :2]
    rn = nx.norm(radial)[..., None]
    dz_seg = p_seg[..., 2] - centers[..., 2]
    on_wall = (torch.abs(dz_seg)[..., None] < BARK_HEIGHT / 2.0) & (rn > 1e-12)
    radial_dir = torch.cat(
        [radial / torch.where(rn > 1e-12, rn, torch.ones_like(rn)),
         torch.zeros_like(rn)], dim=-1)
    ones = torch.ones_like(dz_seg)
    vertical_dir = torch.cat(
        [torch.zeros_like(radial),
         torch.where(dz_seg >= 0, ones, -ones)[..., None]], dim=-1)
    ones_a = torch.ones_like(dist_axis)
    normal_out = torch.where(
        valid_n[..., None],
        torch.where(dist_axis >= 0, -ones_a, ones_a)[..., None] * normal,
        torch.where(on_wall, radial_dir, vertical_dir))
    cap_mid = 0.5 * (cap_a + cap_b)
    in_range = nx.norm(centers - cap_mid[..., None, :]) <= (
        vision_radius + BARK_RADIUS)
    mask = forest.tree_valid & in_range
    dists = torch.where(mask, dists, torch.full_like(dists, float("inf")))
    return Distance(dists=dists, pts_sys=pts_sys, normal_out=normal_out,
                    mask=mask)


def braking_capsule(nx, xl, vl, max_deceleration):
    speed = nx.norm(vl)
    height = 0.5 * (speed * speed) / max_deceleration
    direction = vl / torch.where(speed > 0, speed, torch.ones_like(speed))[
        ..., None]
    cap_b = xl + torch.where(speed > 0, height, torch.zeros_like(height))[
        ..., None] * direction
    return xl, cap_b, height, speed, direction


class EnvRows(NamedTuple):
    lhs: torch.Tensor
    rhs: torch.Tensor
    collision: torch.Tensor
    min_dist: torch.Tensor


def _take(x, idx):
    full = idx.shape[:-1] + x.shape[-2:]
    ix = idx[..., None].expand(idx.shape + x.shape[-1:])
    return torch.gather(x.expand(full), -2, ix)


def cbf_rows(nx, data: Distance, xl, vl, cap_h, speed, cap_dir,
             max_deceleration, vision_radius, dist_eps, alpha, n_rows,
             extra_mask=None) -> EnvRows:
    """Backup-CBF rows of the nearest ``n_rows`` trees (stable ascending
    sort: ties to the smaller slot)."""
    inactive_rhs = -alpha * (vision_radius - dist_eps)
    mask = data.mask if extra_mask is None else (data.mask & extra_mask)
    dists = torch.where(mask, data.dists, float("inf"))
    collision = torch.any(mask & (dists < 1e-4), dim=-1)
    min_dist = torch.amin(
        torch.where(mask, dists, torch.full_like(dists, vision_radius)),
        dim=-1)
    idx = torch.sort(dists, dim=-1, stable=True).indices[..., :n_rows]
    sel_mask = torch.gather(mask, -1, idx)
    d = torch.gather(dists, -1, idx)
    p1 = _take(data.pts_sys, idx)
    proj = nx.dot(p1 - xl[..., None, :], cap_dir[..., None, :])
    proj = torch.minimum(torch.clamp(proj, min=0.0), cap_h[..., None])
    brake = torch.sqrt(torch.clamp(
        2.0 * (cap_h[..., None] - proj) / max_deceleration, min=0.0))
    min_time = torch.clamp(speed[..., None] / max_deceleration - brake,
                           min=0.0)
    normal = _take(data.normal_out, idx)
    n_valid = nx.dot(normal, normal) > 0.5
    near = d < dist_eps
    min_time = torch.where(near, torch.clamp(min_time, min=NEAR_BRAKE_TIME),
                           min_time)
    row_ok = (sel_mask & torch.isfinite(d) & n_valid
              & (near | (speed[..., None] > 0)))
    rhs_raw = -alpha * (d - dist_eps) - nx.dot(normal, vl[..., None, :])
    has_time = min_time > 1e-6
    lhs = torch.where((row_ok & has_time)[..., None], normal,
                      torch.zeros_like(normal))
    rhs = torch.where(
        row_ok,
        torch.where(has_time, rhs_raw / torch.clamp(min_time, min=1e-6),
                    rhs_raw),
        torch.full_like(rhs_raw, inactive_rhs))
    return EnvRows(lhs=lhs, rhs=rhs, collision=collision,
                   min_dist=torch.clamp(min_dist, max=vision_radius))


# ---------------------------------------------------------------- solver

class Solution(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    prim_res: torch.Tensor
    dual_res: torch.Tensor


def bucket(d: int, tile: int = TILE) -> int:
    return -(-d // tile) * tile


def padded_dims(nv: int, n_box: int, soc_dims):
    m = n_box + sum(soc_dims)
    return bucket(nv), n_box + bucket(m) - m


def pad_qp(P, q, A, lb, ub, shift, n_box, soc_dims):
    """The QP at its tile bucket, exactly: pad variables rest at 0, pad
    rows are free zero rows between the box rows and the cones."""
    nv = P.shape[-1]
    m = A.shape[-2]
    nv_p, n_box_p = padded_dims(nv, n_box, soc_dims)
    pad_v, pad_b = nv_p - nv, n_box_p - n_box
    batch = P.shape[:-2]
    kw = dict(dtype=P.dtype, device=P.device)
    P_p = torch.nn.functional.pad(P, (0, pad_v, 0, pad_v))
    if pad_v:
        P_p[..., nv:, nv:] += torch.eye(pad_v, **kw)
    q_p = torch.nn.functional.pad(q, (0, pad_v))
    A_rows = torch.cat([A[..., :n_box, :], torch.zeros(batch + (pad_b, nv),
                                                       **kw),
                        A[..., n_box:, :]], dim=-2)
    A_p = torch.nn.functional.pad(A_rows, (0, pad_v))
    lb_p = torch.cat([lb, torch.full(batch + (pad_b,), -INF, **kw)], dim=-1)
    ub_p = torch.cat([ub, torch.full(batch + (pad_b,), INF, **kw)], dim=-1)
    shift_p = torch.cat([shift[..., :n_box], torch.zeros(batch + (pad_b,),
                                                         **kw),
                         shift[..., n_box:]], dim=-1)
    del m
    return P_p, q_p, A_p, lb_p, ub_p, shift_p


def equilibrate_rows(A, lb, ub, shift, n_box, soc_dims):
    norms = torch.sqrt(torch.sum(A * A, dim=-1))
    scales = [1.0 / torch.clamp(norms[..., :n_box], min=1.0)]
    off = n_box
    for dsoc in soc_dims:
        blk = torch.amax(norms[..., off:off + dsoc], dim=-1, keepdim=True)
        sb = 1.0 / torch.clamp(blk, min=1.0)
        scales.append(sb.expand(sb.shape[:-1] + (dsoc,)))
        off += dsoc
    s = torch.cat(scales, dim=-1)
    return (A * s[..., None], lb * s[..., :n_box], ub * s[..., :n_box],
            shift * s)


def make_rho_vec(m, n_box, lb, ub, rho):
    rho_vec = torch.full(lb.shape[:-1] + (m,), rho, dtype=lb.dtype,
                         device=lb.device)
    is_eq = (ub - lb) < 1e-9
    rho_vec[..., :n_box] = torch.where(
        is_eq, torch.full_like(lb, rho * EQ_RHO_SCALE),
        torch.full_like(lb, rho))
    return rho_vec


def kkt_operator(nx, P, A, rho_vec, sigma=1e-6):
    """``Minv = inv(P + sigma I + A^T diag(rho) A)`` (symmetrised) and
    ``K2 = [[sigma Minv, Minv A^T], [A sigma Minv, A Minv A^T]]``."""
    nv = P.shape[-1]
    AT = A.transpose(-1, -2)
    M = (P + sigma * torch.eye(nv, dtype=P.dtype, device=P.device)
         + nx.mm(AT * rho_vec[..., None, :], A))
    Minv = torch.linalg.inv(M)
    Minv = 0.5 * (Minv + Minv.transpose(-1, -2))
    K = torch.cat([sigma * Minv, nx.mm(Minv, AT)], dim=-1)
    return Minv, torch.cat([K, nx.mm(A, K)], dim=-2)


def project_soc(z):
    t, v = z[..., 0], z[..., 1:]
    nrm = torch.sqrt(torch.sum(v * v, dim=-1))
    inside = nrm <= t
    polar = nrm <= -t
    s = 0.5 * (t + nrm)
    zero = torch.zeros_like(t)
    pos = nrm > 0
    scale = torch.where(pos, s / torch.where(pos, nrm, torch.ones_like(nrm)),
                        zero)
    t_out = torch.where(inside, t, torch.where(polar, zero, s))
    v_out = torch.where(inside[..., None], v, torch.where(
        polar[..., None], torch.zeros_like(v), scale[..., None] * v))
    return torch.cat([t_out[..., None], v_out], dim=-1)


def project_cone(z, lb, ub, n_box, soc_dims, shift):
    """Projection onto ``{z : z + shift in Box x SOC(4) x ...}``."""
    z = z + shift
    d = soc_dims[0]
    assert all(k == d for k in soc_dims)
    k = len(soc_dims)
    box = torch.minimum(torch.maximum(z[..., :n_box], lb), ub)
    blk = z[..., n_box:n_box + k * d].reshape(*z.shape[:-1], k, d)
    out = torch.cat([box, project_soc(blk).reshape(*z.shape[:-1], k * d)],
                    dim=-1)
    return out - shift


def solve(nx, P, q, A, lb, ub, shift, warm: Solution, *, n_box, soc_dims,
          iters, check_every=0, tol=0.0, rho=0.4, sigma=1e-6, alpha=1.6):
    """ADMM on a batch of conic QPs, warm-started, in plain tensor ops: a
    fixed ``iters``, or chunks of ``check_every`` iterations per lane until
    both residuals are at most ``tol`` (tested before the first chunk too;
    NaN counts as converged), capped at ``iters``. Returns the solution
    and each lane's iterations."""
    m, nv = A.shape[-2:]
    rho_vec = make_rho_vec(m, n_box, lb, ub, rho)
    Minv, K2 = kkt_operator(nx, P, A, rho_vec, sigma)
    wq = nx.mv(Minv, q)
    w2 = torch.cat([wq, nx.mv(A, wq)], dim=-1)
    x, y = warm.x, warm.y
    z = project_cone(warm.z, lb, ub, n_box, soc_dims, shift)

    def run(c, k):
        x_, y_, z_ = c
        for _ in range(k):
            v = nx.mv(K2, torch.cat([x_, rho_vec * z_ - y_], dim=-1)) - w2
            x_, Ax = v[..., :nv], v[..., nv:]
            Ax_rel = alpha * Ax + (1 - alpha) * z_
            z_new = project_cone(Ax_rel + y_ / rho_vec, lb, ub, n_box,
                                 soc_dims, shift)
            y_ = y_ + rho_vec * (Ax_rel - z_new)
            z_ = z_new
        return x_, y_, z_

    def residuals(c):
        x_, y_, z_ = c
        prim = torch.amax(torch.abs(nx.mv(A, x_) - z_), dim=-1)
        dual = torch.amax(torch.abs(nx.mv(P, x_) + q
                                    + nx.mv(A.transpose(-1, -2), y_)), dim=-1)
        return prim, dual

    carry = (x, y, z)
    batch = x.shape[:-1]
    if check_every and tol > 0:
        def above(c):
            prim, dual = residuals(c)
            return (prim > tol) | (dual > tol)

        n_full, rem = divmod(iters, check_every)
        chunks = torch.zeros(batch, dtype=torch.int32, device=x.device)
        act = above(carry)
        while bool(act.any()):
            new = run(carry, check_every)
            carry = tuple(torch.where(act[..., None], a, b)
                          for a, b in zip(new, carry))
            chunks = chunks + act.to(torch.int32)
            act = act & (chunks < n_full) & above(carry)
        eff = chunks * check_every
        if rem:
            need = above(carry)
            new = run(carry, rem)
            carry = tuple(torch.where(need[..., None], a, b)
                          for a, b in zip(new, carry))
            eff = eff + torch.where(need, rem, 0).to(torch.int32)
    else:
        carry = run(carry, iters)
        eff = torch.full(batch, iters, dtype=torch.int32, device=x.device)
    prim, dual = residuals(carry)
    return Solution(*carry, prim, dual), eff


def solution_is_finite(sol: Solution):
    return (torch.all(torch.isfinite(sol.x), dim=-1)
            & torch.all(torch.isfinite(sol.y), dim=-1)
            & torch.all(torch.isfinite(sol.z), dim=-1))
