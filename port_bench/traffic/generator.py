"""The one traffic generator: a mix is ``traffic/<mix>.json``, read here.

A mix fixes the world, the episodes' starts, the command each scenario
follows and the episode length; all of it is drawn from ``--seed``. The
world and start generators and the tracking law are frozen copies of the
port's (``envs/forest.py make_forest``, ``harness/rollout.py
scenario_batch`` and ``make_forest_acc_des``) as they stood when the
benchmark was written, so the yardstick does not move with the program.

Keys of a mix (every length in m, every speed in m/s):

- ``world``: ``{"kind": "mountain_forest", "max_trees", "min_spacing"}``
  (rejection sampling inside the 25 m mountain disc at (30, 0));
- ``starts``: ``{"mean": [x, y, z], "std": s, "velocity": [vx, vy, vz]}``
  (payload positions ``N(mean, s^2)``);
- ``command``: ``{"kind": "terrain_following", "lookahead", "clearance",
  "v_ref": [...], "max_acc"}``;
- ``episode_steps``: MPC steps an episode; episode ``k`` starts from a
  fresh draw for ``(seed, k)`` with the controller state reset.

The batch is the configuration's ``scenarios``. A mix of another kind
brings its own generator, ``traffic/<mix>.py``, with the functions
``make_world``, ``episode_starts`` and ``make_command`` of this one.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

MOUNTAIN_CENTER = np.array([30.0, 0.0])
MOUNTAIN_RADIUS = 25.0
MOUNTAIN_HEIGHT = 7.5
BARK_HEIGHT = 4.0
FAR = 1.0e6


def load(mix: str, root: str = HERE) -> dict:
    """The mix ``traffic/<mix>.json``."""
    with open(os.path.join(root, mix + ".json"), encoding="utf-8") as fh:
        return json.load(fh)


def seed_words(seed: int) -> list[int]:
    """``--seed`` as non-negative 32-bit words for numpy's seeding (any
    whole number, negative or past 64 bits included)."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32]


def mountain_geometry() -> tuple[float, float]:
    """``(sphere_radius, center_depth)`` of the spherical-cap mountain."""
    ang = np.pi / 2.0 - np.arctan2(MOUNTAIN_RADIUS, MOUNTAIN_HEIGHT)
    sphere_radius = MOUNTAIN_RADIUS / np.sin(ang)
    return sphere_radius, sphere_radius * np.cos(ang)


def make_world(world: dict, seed: int) -> tuple[np.ndarray, int]:
    """``(tree_pos (max_trees, 3) float64, num_trees)``: tree centers, the
    invalid slots parked far away."""
    return world_from_rng(world, np.random.default_rng(seed_words(seed)))


def world_from_rng(world: dict, rng: np.random.Generator):
    if world["kind"] != "mountain_forest":
        raise ValueError(f"world kind {world['kind']!r}")
    max_trees = int(world["max_trees"])
    spacing = float(world["min_spacing"])
    tree_xy = [MOUNTAIN_CENTER + np.array([0.5, 0.5])]
    for _ in range(max_trees * 50):
        if len(tree_xy) >= max_trees:
            break
        pos = rng.random(2) - 0.5
        norm = np.linalg.norm(pos)
        if norm == 0:
            continue
        pos = pos / norm * rng.random() * MOUNTAIN_RADIUS + MOUNTAIN_CENTER
        if np.min(np.linalg.norm(np.array(tree_xy) - pos, axis=1)) < spacing:
            continue
        tree_xy.append(pos)
    tree_xy = np.array(tree_xy)
    num = len(tree_xy)
    sphere_radius, center_depth = mountain_geometry()
    pos3 = np.full((max_trees, 3), FAR)
    pos3[:num, :2] = tree_xy
    d2 = np.sum((tree_xy - MOUNTAIN_CENTER) ** 2, axis=1)
    ground = np.maximum(np.sqrt(np.maximum(sphere_radius ** 2 - d2, 0.0))
                        - center_depth, 0.0)
    pos3[:num, 2] = (ground + BARK_HEIGHT) / 2.0
    return pos3, num


def episode_starts(starts: dict, seed: int, episode: int,
                   S: int) -> tuple[np.ndarray, np.ndarray]:
    """Episode ``episode``'s payload positions and velocities ``(S, 3)``
    each, float64, from its own stream ``(seed, episode)``."""
    rng = np.random.default_rng(seed_words(seed) + [int(episode)])
    return starts_from_rng(starts, rng, S)


def starts_from_rng(starts: dict, rng: np.random.Generator, S: int):
    xl = (rng.normal(size=(S, 3)) * float(starts["std"])
          + np.asarray(starts["mean"], dtype=np.float64))
    vl = np.broadcast_to(np.asarray(starts["velocity"], dtype=np.float64),
                         (S, 3)).copy()
    return xl, vl


def make_command(command: dict, device):
    """``acc_des(xl (S, 3), vl (S, 3)) -> ((dvl_des, dwl_des) (S, 3) each,
    x_ref (S, 3), v_ref (3,))``: the terrain-following tracking law, a
    waypoint ``lookahead`` ahead in x at ``clearance`` above the terrain,
    ``v_ref`` and a PD acceleration whose norm is clamped to ``max_acc``."""
    if command["kind"] != "terrain_following":
        raise ValueError(f"command kind {command['kind']!r}")
    ahead = float(command["lookahead"])
    clear = float(command["clearance"])
    max_acc = float(command["max_acc"])
    sphere_radius, center_depth = mountain_geometry()
    f32 = dict(dtype=torch.float32, device=device)
    r2 = torch.tensor(sphere_radius, **f32) ** 2
    depth = torch.tensor(center_depth, **f32)
    v_ref = torch.tensor(command["v_ref"], **f32)

    def acc_des(xl, vl):
        dx = xl[..., 0] - float(MOUNTAIN_CENTER[0])
        dy = xl[..., 1] - float(MOUNTAIN_CENTER[1])
        ground = torch.clamp(
            torch.sqrt(torch.clamp(r2 - (dx * dx + dy * dy), min=0.0))
            - depth, min=0.0)
        x_ref = torch.stack([xl[..., 0] + ahead, torch.zeros_like(ground),
                             ground + clear], dim=-1)
        dvl_des = -1.0 * (vl - v_ref) - 1.0 * (xl - x_ref)
        norm = torch.sqrt(torch.sum(dvl_des * dvl_des, dim=-1))[..., None]
        dvl_des = torch.where(
            norm > max_acc,
            dvl_des / torch.where(norm > 0, norm, torch.ones_like(norm))
            * max_acc,
            dvl_des)
        return (dvl_des, torch.zeros_like(dvl_des)), x_ref, v_ref

    return acc_des
