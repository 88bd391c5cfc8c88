"""Host-side geometry helpers: the port's own copy of the JAX package's
``utils/geometry.py`` (reference ``utils/geometry_utils.py``).

They run at set-up and visualisation time only, never on a rollout's path,
so they are plain numpy and scipy.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import ConvexHull


def faces_from_vertex_rep(vertices: np.ndarray) -> np.ndarray:
    """Convex-hull faces (index triplets) from a (m, 3) vertex array."""
    vertices = np.asarray(vertices)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError(f"vertices must be (m, 3), not {vertices.shape}")
    return ConvexHull(vertices).simplices


def mesh_from_halfspace_rep(A: np.ndarray, b: np.ndarray):
    """H-rep ``{x : A x <= b}`` -> (vertices, faces).

    Vertex enumeration without the ``polytope`` package the reference uses:
    every intersection of 3 hyperplanes that satisfies all inequalities is
    a candidate vertex (fine for the small polytopes this serves: tests and
    payload meshes).
    """
    A, b = np.asarray(A), np.asarray(b)
    if A.ndim != 2 or A.shape[1] != 3:
        raise ValueError(f"A must be (m, 3), not {A.shape}")
    m = A.shape[0]
    verts = []
    for i in range(m):
        for j in range(i + 1, m):
            for k in range(j + 1, m):
                M = A[[i, j, k]]
                if abs(np.linalg.det(M)) < 1e-10:
                    continue
                x = np.linalg.solve(M, b[[i, j, k]])
                if np.all(A @ x <= b + 1e-8):
                    verts.append(x)
    if not verts:
        raise ValueError("empty polytope")
    verts = np.unique(np.round(np.array(verts), 10), axis=0)
    return verts, faces_from_vertex_rep(verts)
