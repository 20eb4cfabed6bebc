"""SE(3)/SO(3) maps, closed form, batched (counterpart of
``mc_nerf_tpu/cameras/lie.py``).

Closed-form Rodrigues coefficients with a small-angle Taylor switch
replace the reference's 10-term series (``model/mc_nerf.py:269-316``).
The angle is guarded before its square root (the double-``where`` trick),
so neither the value nor the gradient carries a NaN at theta -> 0.  The
3x3 products are fp32 multiply-sums, so no TF32 setting can touch them
(the JAX package pins them to HIGHEST precision).
"""

from __future__ import annotations

import torch

# below this angle the Taylor branch is used (fp32-safe threshold)
_SMALL = 1e-4


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., i, k] @ [..., k, j] as an fp32 multiply-sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., i, k] @ [..., k] as an fp32 multiply-sum."""
    return (a * v[..., None, :]).sum(-1)


def skew(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix (ref mc_nerf.py:283-289)."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([zeros, -w2, w1], dim=-1),
        torch.stack([w2, zeros, -w0], dim=-1),
        torch.stack([-w1, w0, zeros], dim=-1),
    ], dim=-2)


def _abc(theta_sq: torch.Tensor):
    """A = sin(t)/t, B = (1 - cos t)/t^2, C = (t - sin t)/t^3: exact away
    from zero, 4th-order Taylor near it."""
    small = theta_sq < _SMALL * _SMALL
    # guard BEFORE the sqrt: sqrt'(0) = inf would leak NaN into the
    # gradient through the unselected branch
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    safe_sq = safe * safe
    a_exact = torch.sin(safe) / safe
    b_exact = (1.0 - torch.cos(safe)) / safe_sq
    c_exact = (safe - torch.sin(safe)) / (safe_sq * safe)
    a_taylor = 1.0 - theta_sq / 6.0 + theta_sq * theta_sq / 120.0
    b_taylor = 0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0
    c_taylor = 1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0
    return (torch.where(small, a_taylor, a_exact), torch.where(small, b_taylor, b_exact),
            torch.where(small, c_taylor, c_exact))


def _eye_like(wx: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=wx.dtype, device=wx.device).expand(wx.shape)


def so3_to_SO3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    wx = skew(w)
    A, B, _ = _abc((w * w).sum(-1))
    return _eye_like(wx) + A[..., None, None] * wx + B[..., None, None] * _mm(wx, wx)


def se3_to_SE3(wu: torch.Tensor) -> torch.Tensor:
    """se(3) twist [..., 6] (rotation w | translation u) -> [..., 3, 4]:
    R = exp(w), t = V(w) u (ref ``model/mc_nerf.py:269-281``)."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    wx2 = _mm(wx, wx)
    A, B, C = _abc((w * w).sum(-1))
    eye = _eye_like(wx)
    R = eye + A[..., None, None] * wx + B[..., None, None] * wx2
    V = eye + B[..., None, None] * wx + C[..., None, None] * wx2
    return torch.cat([R, _mv(V, u)[..., None]], dim=-1)


def _rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z), w >= 0, by
    Shepperd's method: the best-conditioned of four extractions."""
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t = torch.stack([1.0 + r00 + r11 + r22, 1.0 + r00 - r11 - r22,
                     1.0 - r00 + r11 - r22, 1.0 - r00 - r11 + r22], dim=-1)
    best = torch.argmax(t, dim=-1)
    s = torch.sqrt(torch.clamp(torch.gather(t, -1, best[..., None])[..., 0], min=1e-12)) * 2.0
    q0 = torch.stack([s / 4.0, (r21 - r12) / s, (r02 - r20) / s, (r10 - r01) / s], -1)
    q1 = torch.stack([(r21 - r12) / s, s / 4.0, (r01 + r10) / s, (r02 + r20) / s], -1)
    q2 = torch.stack([(r02 - r20) / s, (r01 + r10) / s, s / 4.0, (r12 + r21) / s], -1)
    q3 = torch.stack([(r10 - r01) / s, (r02 + r20) / s, (r12 + r21) / s, s / 4.0], -1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)
    q = torch.gather(cand, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def SO3_to_so3(R: torch.Tensor) -> torch.Tensor:
    """Log map via the quaternion: rotation [..., 3, 3] -> axis-angle [..., 3]."""
    q = _rotation_to_quaternion(R)
    qw, qv = q[..., 0], q[..., 1:]
    norm_v = torch.linalg.norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(norm_v, qw)
    small = norm_v < 1e-7
    safe = torch.where(small, torch.ones_like(norm_v), norm_v)
    scale = torch.where(small, 2.0 + theta * theta / 12.0, theta / safe)
    return qv * scale[..., None]


def SE3_to_se3(Rt: torch.Tensor) -> torch.Tensor:
    """Log map [..., 3, 4] -> twist [..., 6]; inverse of :func:`se3_to_SE3`."""
    R, t = Rt[..., :3], Rt[..., 3]
    w = SO3_to_so3(R)
    wx = skew(w)
    A, B, C = _abc((w * w).sum(-1))
    V = _eye_like(wx) + B[..., None, None] * wx + C[..., None, None] * _mm(wx, wx)
    u = torch.linalg.solve(V, t[..., None])[..., 0]
    return torch.cat([w, u], dim=-1)
