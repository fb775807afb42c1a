"""Shaded depth visualization (port of holo_diffusion_tpu/utils/shaded_depth.py;
reference render_utils/shaded_depth_render.py + flyaround.py:400-503).

Shade from rendered normals (`render_normals: true`, hydrant) or derive the
normals from the depth map: finite differences of the unprojected point map
("gradient"), KNN-PCA normals of the view-space point cloud ("pointcloud",
`ops/knn.py`) or a soft-rasterized quad mesh over the depth grid ("mesh",
`utils/mesh_render.py`). Everything stays on the depth map's device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry.cameras import PerspectiveCameras, camera_centers, unproject_ndc_points
from ..geometry.rays import pixel_grid_ndc


def _normalize(v: torch.Tensor, eps: float) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=eps)


def depth_laplacian_outlier_mask(depth: torch.Tensor, thr: float = 0.3) -> torch.Tensor:
    """(H, W) float mask, 0 at depth discontinuities and on the border
    (shaded_depth_render.py:27-44)."""
    d = depth
    lap = torch.abs(4 * d[1:-1, 1:-1] - d[:-2, 1:-1] - d[2:, 1:-1] - d[1:-1, :-2] - d[1:-1, 2:])
    inner = (lap < thr * torch.clamp(d[1:-1, 1:-1], min=1e-6)).to(torch.float32)
    return F.pad(inner, (1, 1, 1, 1))


def _unproject(camera: PerspectiveCameras, depth: torch.Tensor) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) world points of camera[0]'s pixel centres."""
    H, W = depth.shape
    xyd = torch.cat([pixel_grid_ndc(H, W, depth.device), depth[..., None]], dim=-1)
    return unproject_ndc_points(camera, xyd[None])[0]


def _unproject_view_space(depth: torch.Tensor, camera: PerspectiveCameras) -> torch.Tensor:
    """Unproject a depth map with a trivial camera (R = I, T = 0): the
    reference's view-space point grid (shaded_depth_render.py:166-183)."""
    dev = depth.device
    trivial = PerspectiveCameras(
        R=torch.eye(3, device=dev)[None],
        T=torch.zeros((1, 3), device=dev),
        focal_length=camera.focal_length[:1].to(dev),
        principal_point=camera.principal_point[:1].to(dev),
    )
    return _unproject(trivial, torch.clamp(depth, min=1e-6))


def _lambert(camera: PerspectiveCameras, pts: torch.Tensor, normals: torch.Tensor, ambient: float):
    """ambient + (1 - ambient) |n . to_camera| at world points (H, W, 3)."""
    to_cam = _normalize(camera_centers(camera)[0] - pts, 1e-8)
    return ambient + (1 - ambient) * torch.abs(torch.sum(normals * to_cam, dim=-1))


def depth_to_shaded(
    depth: torch.Tensor,
    mask: torch.Tensor,
    camera: PerspectiveCameras,
    ambient: float = 0.25,
    bg_value: float = 1.0,
    method: str = "gradient",
    material: str = "medium",
    knn_k: int = 20,
) -> torch.Tensor:
    """(H, W) depth + (H, W) mask + camera[0] -> (H, W, 3) shaded render.

    Methods (shaded_depth_render.py:142-207):
      * "gradient"   normals by central differences of the unprojected
                     point map, Lambertian with the light at the camera;
      * "pointcloud" KNN-PCA normals of the view-space point cloud, shade
                     |n_z| (ops/knn.py);
      * "mesh"       a quad mesh over the depth grid, Gouraud shading, soft
                     rasterization with softmax blending (utils/mesh_render.py).
    """
    camera = camera.to(depth.device)
    if method == "pointcloud":
        from ..ops.knn import pointcloud_shaded_grid

        pcl = _unproject_view_space(depth, camera)
        valid = (mask > 0.5) & (depth > 1e-2)
        shaded = pointcloud_shaded_grid(pcl, valid, neighborhood_size=knn_k)
        return torch.where(valid[..., None], shaded, torch.full_like(shaded, bg_value))
    if method == "mesh":
        from .mesh_render import mesh_render_shaded

        pcl = _unproject_view_space(depth, camera)
        valid = ((mask > 0.5) & (depth > 1e-2)).to(torch.float32)
        valid = valid * depth_laplacian_outlier_mask(depth)
        shaded, render_mask, _ = mesh_render_shaded(
            pcl, valid,
            focal_length=camera.focal_length[0],
            principal_point=camera.principal_point[0],
            material=material,
        )
        return torch.where(render_mask > 0.5, shaded, torch.full_like(shaded, bg_value))
    if method != "gradient":
        raise ValueError(f"unknown shaded depth method {method!r}: gradient, pointcloud or mesh")
    H, W = depth.shape
    pts = _unproject(camera, depth)
    dx = torch.gradient(pts, dim=1)[0]
    dy = torch.gradient(pts, dim=0)[0]
    n = _normalize(torch.linalg.cross(dx, dy, dim=-1), 1e-8)
    shade = _lambert(camera, pts, n, ambient)
    valid = (mask > 0.5) & (depth > 1e-6) & (depth_laplacian_outlier_mask(depth) > 0.5)
    out = torch.where(valid, shade, torch.full_like(shade, bg_value))
    return out[..., None].expand(H, W, 3)


def shaded_from_normals(
    normals: torch.Tensor,
    mask: torch.Tensor,
    camera: PerspectiveCameras,
    depth: torch.Tensor,
    ambient: float = 0.25,
    bg_value: float = 1.0,
) -> torch.Tensor:
    """Shade from rendered normals (flyaround.py:400-419; `render_normals:
    true`). normals: (H, W, 3); mask, depth: (H, W) -> (H, W, 3)."""
    H, W = mask.shape
    camera = camera.to(depth.device)
    pts = _unproject(camera, torch.clamp(depth, min=1e-3))
    shade = _lambert(camera, pts, _normalize(normals, 1e-8), ambient)
    out = torch.where(mask > 0.5, shade, torch.full_like(shade, bg_value))
    return out[..., None].expand(H, W, 3)


def make_depth_image(depth: torch.Tensor, mask: torch.Tensor, pad_value: float = 0.0) -> torch.Tensor:
    """Depth normalised over the mask, near bright, composited over the mask
    (Implicitron vis_utils.make_depth_image); (H, W) -> (H, W, 3)."""
    inside = mask > 0.5
    inf = torch.full_like(depth, float("inf"))
    dmin = torch.where(inside, depth, inf).min()
    dmax = torch.where(inside, depth, -inf).max()
    norm = (depth - dmin) / torch.clamp(dmax - dmin, min=1e-6)
    norm = torch.clamp(1.0 - norm, 0.0, 1.0)
    out = torch.where(inside, norm, torch.full_like(norm, pad_value))
    return out[..., None].expand(*depth.shape, 3)
