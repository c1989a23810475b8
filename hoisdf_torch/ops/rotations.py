"""Rotation representations (``hoisdf_tpu/ops/rotations.py``), batched and
branch-free so they run unchanged on the card."""

from __future__ import annotations

import torch


def batch_rodrigues(theta: torch.Tensor) -> torch.Tensor:
    """Axis-angle [N,3] -> rotation matrices [N,3,3] via the quaternion map,
    keeping the original's ``norm(theta + 1e-8)``."""
    angle = torch.linalg.vector_norm(theta + 1e-8, ord=2, dim=1)[:, None]
    normalized = theta / angle
    half = angle * 0.5
    quat = torch.cat([torch.cos(half), torch.sin(half) * normalized], dim=1)
    return quat2mat(quat)


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion [N,4] (w,x,y,z) -> rotation matrix [N,3,3]."""
    q = quat / torch.linalg.vector_norm(quat, ord=2, dim=1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rot = torch.stack(
        [
            w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz,
            2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx,
            2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2,
        ],
        dim=1,
    )
    return rot.reshape(-1, 3, 3)


def quat2aa(quaternion: torch.Tensor) -> torch.Tensor:
    """Quaternion [...,4] -> axis-angle [...,3]."""
    q1, q2, q3 = quaternion[..., 1], quaternion[..., 2], quaternion[..., 3]
    sin_sq = q1 * q1 + q2 * q2 + q3 * q3
    sin_theta = torch.sqrt(sin_sq)
    cos_theta = quaternion[..., 0]
    two_theta = 2.0 * torch.where(
        cos_theta < 0.0,
        torch.atan2(-sin_theta, -cos_theta),
        torch.atan2(sin_theta, cos_theta),
    )
    k_pos = two_theta / torch.where(sin_theta > 0.0, sin_theta, torch.ones_like(sin_theta))
    k = torch.where(sin_sq > 0.0, k_pos, torch.full_like(k_pos, 2.0))
    return torch.stack([q1 * k, q2 * k, q3 * k], dim=-1)


def mat2quat(rotation_matrix: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Rotation matrix [N,3,4] -> quaternion [N,4] (branch-free Shepperd)."""
    r = rotation_matrix.transpose(1, 2)
    mask_d2 = r[:, 2, 2] < eps
    mask_d0_d1 = r[:, 0, 0] > r[:, 1, 1]
    mask_d0_nd1 = r[:, 0, 0] < -r[:, 1, 1]

    t0 = 1 + r[:, 0, 0] - r[:, 1, 1] - r[:, 2, 2]
    q0 = torch.stack([r[:, 1, 2] - r[:, 2, 1], t0,
                      r[:, 0, 1] + r[:, 1, 0], r[:, 2, 0] + r[:, 0, 2]], dim=-1)
    t1 = 1 - r[:, 0, 0] + r[:, 1, 1] - r[:, 2, 2]
    q1 = torch.stack([r[:, 2, 0] - r[:, 0, 2], r[:, 0, 1] + r[:, 1, 0],
                      t1, r[:, 1, 2] + r[:, 2, 1]], dim=-1)
    t2 = 1 - r[:, 0, 0] - r[:, 1, 1] + r[:, 2, 2]
    q2 = torch.stack([r[:, 0, 1] - r[:, 1, 0], r[:, 2, 0] + r[:, 0, 2],
                      r[:, 1, 2] + r[:, 2, 1], t2], dim=-1)
    t3 = 1 + r[:, 0, 0] + r[:, 1, 1] + r[:, 2, 2]
    q3 = torch.stack([t3, r[:, 1, 2] - r[:, 2, 1],
                      r[:, 2, 0] - r[:, 0, 2], r[:, 0, 1] - r[:, 1, 0]], dim=-1)

    c0 = (mask_d2 & mask_d0_d1)[:, None].to(q0.dtype)
    c1 = (mask_d2 & ~mask_d0_d1)[:, None].to(q1.dtype)
    c2 = (~mask_d2 & mask_d0_nd1)[:, None].to(q2.dtype)
    c3 = (~mask_d2 & ~mask_d0_nd1)[:, None].to(q3.dtype)
    q = q0 * c0 + q1 * c1 + q2 * c2 + q3 * c3
    denom = torch.sqrt(t0[:, None] * c0 + t1[:, None] * c1
                       + t2[:, None] * c2 + t3[:, None] * c3)
    return q / denom * 0.5


def mat2aa(rotation_matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [N,3,3] -> axis-angle [N,3]; NaN lanes become 0."""
    if rotation_matrix.shape[-2:] == (3, 3):
        pad = torch.zeros(rotation_matrix.shape[:-1] + (1,),
                          dtype=rotation_matrix.dtype, device=rotation_matrix.device)
        pad[..., 2, 0] = 1.0
        rotation_matrix = torch.cat([rotation_matrix, pad], dim=-1)
    return torch.nan_to_num(quat2aa(mat2quat(rotation_matrix)), nan=0.0)


def rot6d2mat(x: torch.Tensor) -> torch.Tensor:
    """6D rotation [N,6] -> [N,3,3] by Gram-Schmidt; columns are (b1,b2,b3)."""
    a1, a2 = x[:, 0:3], x[:, 3:6]

    def _normalize(v):
        n = torch.linalg.vector_norm(v, ord=2, dim=1, keepdim=True)
        return v / torch.clamp(n, min=1e-12)

    b1 = _normalize(a1)
    b2 = _normalize(a2 - torch.sum(b1 * a2, dim=1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=1)
    return torch.stack((b1, b2, b3), dim=-1)


def batch_rotprojs(mats: torch.Tensor) -> torch.Tensor:
    """Project [..., 3, 3] matrices onto SO(3) by SVD: U V^T with U's last
    column negated where det(U V^T) < 0 (manopth's rotproj)."""
    u, _, vt = torch.linalg.svd(mats)
    det = torch.linalg.det(u @ vt)[..., None, None]
    u_fix = torch.cat([u[..., :2], u[..., 2:] * torch.sign(det)], dim=-1)
    return u_fix @ vt


def rigid_transform_3d(a: torch.Tensor, b: torch.Tensor):
    """Similarity Kabsch of point sets a, b [..., N, 3]: scale c [...],
    rotation R [..., 3, 3] and translation t [..., 3] with b ~ c R a + t
    (common/metrics.py:188-204).  Where R = V U^T is a reflection, the last
    singular value and the last row of V^T are negated, as the JAX package
    does; R, c and t do not depend on the signs the SVD picks."""
    n = a.shape[-2]
    centroid_a = a.mean(dim=-2)
    centroid_b = b.mean(dim=-2)
    h = (a - centroid_a[..., None, :]).transpose(-1, -2) @ (b - centroid_b[..., None, :]) / n
    u, s, v = torch.linalg.svd(h)  # v holds numpy's `V` (the rows of V^T)
    r = v.transpose(-1, -2) @ u.transpose(-1, -2)
    flip = (torch.linalg.det(r) < 0)[..., None]
    sign = torch.where(flip, -1.0, 1.0).to(s.dtype)
    s = torch.cat([s[..., :2], s[..., 2:] * sign], dim=-1)
    v = torch.cat([v[..., :2, :], v[..., 2:, :] * sign[..., None]], dim=-2)
    r = v.transpose(-1, -2) @ u.transpose(-1, -2)
    var_a = a.var(dim=-2, unbiased=False).sum(dim=-1)
    c = s.sum(dim=-1) / var_a
    t = -(c[..., None, None] * r) @ centroid_a[..., None] + centroid_b[..., None]
    return c, r, t[..., 0]


def rigid_align(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Procrustes-align point sets a onto b, [..., N, 3] (common/metrics.py:207-210)."""
    c, r, t = rigid_transform_3d(a, b)
    return (c[..., None, None] * r @ a.transpose(-1, -2)).transpose(-1, -2) + t[..., None, :]
