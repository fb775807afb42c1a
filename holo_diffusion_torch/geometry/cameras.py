"""Perspective cameras with PyTorch3D conventions (port of
holo_diffusion_tpu/geometry/cameras.py).

  - world -> camera: x_cam = x_world @ R + T          (row vectors)
  - camera centre:   C = -T @ R^T
  - NDC: x_ndc = fx * x_cam / z_cam + px              (+x left, +y up)
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PerspectiveCameras:
    """R: (B, 3, 3) world-to-camera rotations (row-vector convention);
    T: (B, 3); focal_length, principal_point: (B, 2) in NDC units."""

    R: torch.Tensor
    T: torch.Tensor
    focal_length: torch.Tensor
    principal_point: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.R.shape[0]

    def __getitem__(self, idx) -> "PerspectiveCameras":
        # keep the batch dim: an int index becomes a length-1 slice
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return PerspectiveCameras(
            *(getattr(self, f.name)[idx] for f in dataclasses.fields(self))
        )

    def to(self, device, non_blocking: bool = False) -> "PerspectiveCameras":
        return PerspectiveCameras(
            *(getattr(self, f.name).to(device, non_blocking=non_blocking) for f in dataclasses.fields(self))
        )

    @classmethod
    def identity(cls, batch_size: int = 1, focal: float = 1.0, device=None) -> "PerspectiveCameras":
        """Cameras at the origin looking down +z: R = I, T = 0, focal
        `focal`, principal point 0."""
        return cls(
            R=torch.eye(3, device=device).expand(batch_size, 3, 3).clone(),
            T=torch.zeros(batch_size, 3, device=device),
            focal_length=torch.full((batch_size, 2), float(focal), device=device),
            principal_point=torch.zeros(batch_size, 2, device=device),
        )


def join_cameras(cams) -> PerspectiveCameras:
    """Concatenate camera batches along the batch dimension."""
    return PerspectiveCameras(*(torch.cat([getattr(c, f.name) for c in cams])
                                for f in dataclasses.fields(PerspectiveCameras)))


def camera_centers(cameras: PerspectiveCameras) -> torch.Tensor:
    """C = -T @ R^T, (B, 3)."""
    return -torch.einsum("bi,bji->bj", cameras.T, cameras.R)


def transform_points_world_to_camera(
    cameras: PerspectiveCameras, points: torch.Tensor
) -> torch.Tensor:
    """x_cam = x_world @ R + T. points (B, ..., 3)."""
    extra = points.ndim - 2
    T = cameras.T.reshape(cameras.T.shape[0], *([1] * extra), 3)
    return torch.einsum("b...i,bij->b...j", points, cameras.R) + T


def project_points_ndc(
    cameras: PerspectiveCameras, points_world: torch.Tensor, eps: float = 1e-8
) -> torch.Tensor:
    """World points (B, ..., 3) -> (x_ndc, y_ndc, z_cam), pytorch3d NDC
    signs (+x left, +y up); |z| below eps is pushed out to eps."""
    pts_cam = transform_points_world_to_camera(cameras, points_world)
    z = pts_cam[..., 2:3]
    safe = torch.where(z.abs() < eps, torch.where(z >= 0, eps, -eps), z)
    extra = points_world.ndim - 2
    f = cameras.focal_length.reshape(cameras.focal_length.shape[0], *([1] * extra), 2)
    p = cameras.principal_point.reshape(cameras.principal_point.shape[0], *([1] * extra), 2)
    return torch.cat([pts_cam[..., :2] * f * (1.0 / safe) + p, z], dim=-1)


def transform_points_camera_to_world(
    cameras: PerspectiveCameras, points: torch.Tensor
) -> torch.Tensor:
    """Inverse of x_cam = x_world @ R + T (R orthonormal). points (B, ..., 3)."""
    extra = points.ndim - 2
    T = cameras.T.reshape(cameras.T.shape[0], *([1] * extra), 3)
    return torch.einsum("b...i,bji->b...j", points - T, cameras.R)


def unproject_ndc_points(
    cameras: PerspectiveCameras, xy_depth: torch.Tensor
) -> torch.Tensor:
    """(x_ndc, y_ndc, depth) -> world points, (B, ..., 3)."""
    extra = xy_depth.ndim - 2
    f = cameras.focal_length.reshape(cameras.focal_length.shape[0], *([1] * extra), 2)
    p = cameras.principal_point.reshape(cameras.principal_point.shape[0], *([1] * extra), 2)
    z = xy_depth[..., 2:3]
    xy_cam = (xy_depth[..., :2] - p) * z / f
    return transform_points_camera_to_world(cameras, torch.cat([xy_cam, z], dim=-1))


def so3_exp_map(log_rot: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Rodrigues exponential map (B, 3) -> (B, 3, 3) (pytorch3d `so3_exp_map`)."""
    theta2 = torch.sum(log_rot * log_rot, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=eps * eps))
    sin_t = torch.sin(theta) / theta
    cos_fac = (1.0 - torch.cos(theta)) / (theta * theta)
    x, y, z = log_rot[..., 0], log_rot[..., 1], log_rot[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=log_rot.dtype, device=log_rot.device).expand(K.shape)
    return eye + sin_t[..., None, None] * K + cos_fac[..., None, None] * (K @ K)


def _normalize(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def look_at_rotation(eye: torch.Tensor, at: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """pytorch3d `look_at_rotation`: R whose columns are the camera axes;
    camera +z points from eye toward `at`, +x = up x z."""
    z_axis = _normalize(at - eye)
    x_axis = _normalize(torch.linalg.cross(up, z_axis, dim=-1))
    degenerate = torch.sum(x_axis * x_axis, dim=-1, keepdim=True) < 5e-7
    x_axis = torch.where(
        degenerate, torch.tensor([1.0, 0.0, 0.0], dtype=eye.dtype, device=eye.device), x_axis
    )
    y_axis = _normalize(torch.linalg.cross(z_axis, x_axis, dim=-1))
    return torch.stack([x_axis, y_axis, z_axis], dim=-2).transpose(-1, -2)


def look_at_view_transform(
    dist=1.0, elev=0.0, azim=0.0, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0),
    degrees: bool = True,
):
    """pytorch3d `look_at_view_transform`: spherical pose -> (R, T); dist, elev
    and azim broadcast to a common batch (B,)."""
    as1d = lambda v: torch.atleast_1d(torch.as_tensor(v, dtype=torch.float32))
    dist, elev, azim = torch.broadcast_tensors(as1d(dist), as1d(elev), as1d(azim))
    if degrees:
        elev = torch.deg2rad(elev)
        azim = torch.deg2rad(azim)
    x = dist * torch.cos(elev) * torch.sin(azim)
    y = dist * torch.sin(elev)
    z = dist * torch.cos(elev) * torch.cos(azim)
    B = dist.shape[0]
    at = torch.as_tensor(at, dtype=torch.float32).expand(B, 3)
    up = torch.as_tensor(up, dtype=torch.float32).expand(B, 3)
    eye = at + torch.stack([x, y, z], dim=-1)
    R = look_at_rotation(eye, at, up)
    T = -torch.einsum("bi,bij->bj", eye, R)
    return R, T
