"""Planar PnP: a tag-to-camera pose from one tag's keypoints, batched
(counterpart of ``mc_nerf_tpu/cameras/pnp.py``).

A DLT homography from the 5 coplanar tag keypoints, decomposed against
the current intrinsics into an exact [R | t]; the camera restarts
(``train/restarts.py``) use it for analytic candidates.  Every product is
an fp32 multiply-sum, so no TF32 setting can touch it (the JAX package
pins its products to HIGHEST precision): a restart adopts a candidate
only when its residual beats half a residual that is ~1e-8 for converged
cameras, so precision decides which cameras are adopted.
"""

from __future__ import annotations

import torch

from mc_nerf_torch.cameras.lie import _mm, _mv
from mc_nerf_torch.cameras.projection import invert_K


def homography_dlt(src_uv: torch.Tensor, dst_xy: torch.Tensor) -> torch.Tensor:
    """Least-squares homography from >= 4 correspondences: ``src_uv``,
    ``dst_xy`` [..., P, 2] -> [..., 3, 3] H with ``dst ~ H @ (u, v, 1)``."""
    src_uv, dst_xy = torch.broadcast_tensors(src_uv, dst_xy)
    u, v = src_uv[..., 0], src_uv[..., 1]
    x, y = dst_xy[..., 0], dst_xy[..., 1]
    zeros, ones = torch.zeros_like(u), torch.ones_like(u)
    row_x = torch.stack([u, v, ones, zeros, zeros, zeros, -x * u, -x * v, -x], dim=-1)
    row_y = torch.stack([zeros, zeros, zeros, u, v, ones, -y * u, -y * v, -y], dim=-1)
    A = torch.cat([row_x, row_y], dim=-2)                 # [..., 2P, 9]
    # h = the right-singular vector of the smallest singular value
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    return vt[..., -1, :].reshape(*vt.shape[:-2], 3, 3)


def solve_planar_pnp(plane_uv: torch.Tensor, pix: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pose of a plane from its keypoints: plane frame (u, v, 0) -> camera.

    ``G = K^-1 H = lambda [r1 r2 t]`` in normalized camera coordinates,
    ``r3 = r1 x r2``, the rotation projected onto SO(3) by SVD, the sign
    fixed so the plane lies in front of the camera (t_z > 0).
    ``plane_uv`` [..., P, 2], ``pix`` [..., P, 2], ``K`` [..., 3, 3] ->
    [..., 3, 4] with ``x_cam = R (u, v, 0)^T + t``.
    """
    K_inv = invert_K(K)
    pix_h = torch.cat([pix, torch.ones_like(pix[..., :1])], dim=-1)
    norm = _mv(K_inv[..., None, :, :], pix_h)             # [..., P, 3]
    G = homography_dlt(plane_uv, norm[..., :2] / norm[..., 2:3])
    g1, g2, g3 = G[..., :, 0], G[..., :, 1], G[..., :, 2]
    scale = 0.5 * (torch.linalg.norm(g1, dim=-1) + torch.linalg.norm(g2, dim=-1))
    lam = 1.0 / torch.clamp(scale, min=1e-12)
    lam = lam * torch.where(g3[..., 2] * lam < 0, -1.0, 1.0)
    r1, r2, t = g1 * lam[..., None], g2 * lam[..., None], g3 * lam[..., None]
    R0 = torch.stack([r1, r2, torch.linalg.cross(r1, r2)], dim=-1)
    u_svd, _, vt_svd = torch.linalg.svd(R0)
    det = torch.linalg.det(_mm(u_svd, vt_svd))
    fix = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = _mm(u_svd * fix[..., None, :], vt_svd)
    return torch.cat([R, t[..., None]], dim=-1)


def tag_pose_to_frame_pose(pose_plane2cam: torch.Tensor, frame_origin: torch.Tensor,
                           frame_u: torch.Tensor, frame_v: torch.Tensor,
                           frame_n: torch.Tensor) -> torch.Tensor:
    """A tag-plane pose -> the pose of the frame containing the tag.

    The plane frame has origin ``frame_origin`` and axes (u, v, n) in the
    containing frame, so ``x_cam = R_p B^T p + (t_p - R_p B^T o)`` with
    ``B = [u v n]``.  Returns [..., 3, 4] frame-to-camera poses."""
    R_p, t_p = pose_plane2cam[..., :3], pose_plane2cam[..., 3]
    B = torch.stack([frame_u, frame_v, frame_n], dim=-1)
    R = _mm(R_p, B.transpose(-1, -2))
    return torch.cat([R, (t_p - _mv(R, frame_origin))[..., None]], dim=-1)
