"""Perspective cameras in PyTorch3D's conventions, as plain tensors.

A camera set is a dict {R (B, 3, 3), T (B, 3), focal (B, 2), pp (B, 2)}:
world -> camera x_cam = x_world @ R + T (row vectors), NDC x = f x_cam / z +
p with +x left and +y up. The benchmark makes its poses with these helpers,
so its inputs do not come from the program.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

Cameras = Dict[str, torch.Tensor]


def _unit(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def look_at(dist: torch.Tensor, elev_deg: torch.Tensor, azim_deg: torch.Tensor,
            at: Sequence[float] = (0.0, 0.0, 0.0), up: Sequence[float] = (0.0, 1.0, 0.0)):
    """pytorch3d's look_at_view_transform: (R (B, 3, 3), T (B, 3))."""
    elev, azim = torch.deg2rad(elev_deg), torch.deg2rad(azim_deg)
    offset = torch.stack([dist * torch.cos(elev) * torch.sin(azim), dist * torch.sin(elev),
                          dist * torch.cos(elev) * torch.cos(azim)], dim=-1)
    at_t = torch.as_tensor(at, dtype=offset.dtype, device=offset.device).expand_as(offset)
    up_t = torch.as_tensor(up, dtype=offset.dtype, device=offset.device).expand_as(offset)
    eye = at_t + offset
    z = _unit(at_t - eye, 1e-8)
    x = _unit(torch.linalg.cross(up_t, z, dim=-1), 1e-8)
    bad = torch.sum(x * x, dim=-1, keepdim=True) < 5e-7
    x = torch.where(bad, torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype, device=x.device), x)
    y = _unit(torch.linalg.cross(z, x, dim=-1), 1e-8)
    R = torch.stack([x, y, z], dim=-2).transpose(-1, -2)
    T = -torch.einsum("bi,bij->bj", eye, R)
    return R, T


def rodrigues(axis_angle: torch.Tensor) -> torch.Tensor:
    """(3,) axis * angle -> (3, 3) rotation (pytorch3d so3_exp_map)."""
    theta = torch.sqrt(torch.clamp(torch.sum(axis_angle * axis_angle), min=1e-8))
    x, y, z = axis_angle
    zero = torch.zeros((), dtype=axis_angle.dtype)
    K = torch.stack([torch.stack([zero, -z, y]), torch.stack([z, zero, -x]), torch.stack([-y, x, zero])])
    return (torch.eye(3, dtype=axis_angle.dtype) + torch.sin(theta) / theta * K
            + (1.0 - torch.cos(theta)) / (theta * theta) * (K @ K))


def orbit_cameras(n_poses: int, dist: float, elevation: float, up: Sequence[float], focal: float) -> Cameras:
    """The fly-around's simple_360 orbit: look-at poses at `n_poses` azimuths,
    the world turned so that `up` is the orbit's axis."""
    azim = torch.linspace(0.0, 360.0, n_poses + 1)[:-1]
    R, T = look_at(torch.full((n_poses,), float(dist)), torch.full((n_poses,), float(elevation)), azim)
    u = torch.tensor(up, dtype=torch.float64)
    u = u / torch.linalg.norm(u)
    yax = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64)
    axis = torch.linalg.cross(yax, u, dim=-1)
    s = float(torch.linalg.norm(axis))
    if s > 1e-6:
        angle = math.atan2(s, float(torch.dot(yax, u)))
        R_up = rodrigues((axis / s * angle).to(torch.float32))
        R = torch.einsum("ij,bjk->bik", R_up.T, R)
    return {"R": R, "T": T, "focal": torch.full((n_poses, 2), float(focal)), "pp": torch.zeros((n_poses, 2))}


def select(cams: Cameras, idx) -> Cameras:
    if isinstance(idx, int):
        idx = slice(idx, idx + 1)
    return {k: v[idx] for k, v in cams.items()}


def to(cams: Cameras, device) -> Cameras:
    return {k: v.to(device) for k, v in cams.items()}


def centers(cams: Cameras) -> torch.Tensor:
    return -torch.einsum("bi,bji->bj", cams["T"], cams["R"])


def world_to_camera(cams: Cameras, pts: torch.Tensor) -> torch.Tensor:
    """pts (B, ..., 3) -> camera coordinates."""
    extra = pts.ndim - 2
    T = cams["T"].reshape(cams["T"].shape[0], *([1] * extra), 3)
    return torch.einsum("b...i,bij->b...j", pts, cams["R"]) + T


def project_ndc(cams: Cameras, pts: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """World points (B, ..., 3) -> (x_ndc, y_ndc, z_cam)."""
    pc = world_to_camera(cams, pts)
    z = pc[..., 2:3]
    z = torch.where(z.abs() < eps, torch.where(z >= 0, eps, -eps), z)
    extra = pts.ndim - 2
    f = cams["focal"].reshape(cams["focal"].shape[0], *([1] * extra), 2)
    p = cams["pp"].reshape(cams["pp"].shape[0], *([1] * extra), 2)
    return torch.cat([pc[..., :2] * f / z + p, pc[..., 2:3]], dim=-1)


def unproject_ndc(cams: Cameras, xy_depth: torch.Tensor) -> torch.Tensor:
    """(x_ndc, y_ndc, depth) (B, ..., 3) -> world points."""
    extra = xy_depth.ndim - 2
    f = cams["focal"].reshape(cams["focal"].shape[0], *([1] * extra), 2)
    p = cams["pp"].reshape(cams["pp"].shape[0], *([1] * extra), 2)
    z = xy_depth[..., 2:3]
    pc = torch.cat([(xy_depth[..., :2] - p) * z / f, z], dim=-1)
    T = cams["T"].reshape(cams["T"].shape[0], *([1] * extra), 3)
    return torch.einsum("b...i,bji->b...j", pc - T, cams["R"])
