"""Object mesh helpers (a numpy copy of ``hoisdf_tpu/data/meshes.py``):
point clouds and OBJ vertices, the 21-point 3D box, diameters, radii, and a
class library of them.

The original's ``data/dataset_util.py:204-316`` and its mesh loaders
(``data/dex_ycb_util.py:36-44``, ``data/ho3d_util.py:66-86``), without
trimesh or pytorch3d.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

from hoisdf_torch.data.transforms import get_bbox21_3d


def load_xyz(path: str) -> np.ndarray:
    """Plain-text .xyz point cloud -> [N,3] float32."""
    return np.loadtxt(path, dtype=np.float32)[:, :3]


def load_obj_vertices(path: str) -> np.ndarray:
    """OBJ vertex lines -> [N,3] float32 (the simplified YCB meshes'
    ``textured_simple_2000.obj``)."""
    verts = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
    return np.asarray(verts, np.float32)


def bbox21_3d(verts: np.ndarray) -> np.ndarray:
    """21-point 3D box: 8 corners + 12 edge midpoints + center, in the
    original's stacking order (dataset_util.py:204-272)."""
    return get_bbox21_3d(verts)


def mesh_diameter(verts: np.ndarray) -> float:
    """Max pairwise distance (class diameter, dataset_util.py:275-316).
    Computed on the bbox corners' hull approximation for large meshes."""
    if verts.shape[0] > 2000:
        mn, mx = verts.min(0), verts.max(0)
        verts = np.array(
            [[x, y, z] for x in (mn[0], mx[0]) for y in (mn[1], mx[1])
             for z in (mn[2], mx[2])], np.float32,
        )
    d = np.linalg.norm(verts[:, None] - verts[None], axis=-1)
    return float(d.max())


def mesh_radius(verts: np.ndarray) -> float:
    """Max distance from the centroid (get_radius in main/test.py usage)."""
    c = verts.mean(0)
    return float(np.linalg.norm(verts - c, axis=-1).max())


def load_object_library(
    models_dir: str, names: Sequence[str], mesh_file: str = "points.xyz"
) -> Tuple[Dict[int, np.ndarray], Dict[int, float], Dict[int, np.ndarray]]:
    """(meshes, diameters, 21-pt bboxes) keyed by 1-based class id."""
    meshes, diameters, bboxes = {}, {}, {}
    for cls_id, name in enumerate(names, start=1):
        path = os.path.join(models_dir, name, mesh_file)
        if not os.path.exists(path):
            continue
        v = load_xyz(path) if path.endswith(".xyz") else load_obj_vertices(path)
        meshes[cls_id] = v
        diameters[cls_id] = mesh_diameter(v)
        bboxes[cls_id] = bbox21_3d(v)
    return meshes, diameters, bboxes
