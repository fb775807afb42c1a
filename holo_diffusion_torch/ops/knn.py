"""K-nearest neighbours and point-cloud normals by local PCA (port of
holo_diffusion_tpu/ops/knn.py; the reference's pytorch3d
`estimate_pointcloud_normals`, shaded_depth_render.py:233-237).

Distances are computed in query blocks as `|p|^2 - 2 q.p` (one matmul a
block) and the k smallest taken by `torch.topk`; the normal of a point is
the smallest eigenvector of its neighbourhood's 3x3 covariance (batched
`torch.linalg.eigh`). Plain PyTorch: the JAX module has no Pallas kernel.
"""
from __future__ import annotations

import torch


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int, block_q: int = 1024) -> torch.Tensor:
    """Indices (Q, k) of the k nearest `points` (N, 3) of each `query` (Q, 3),
    nearest first. Points at equal distances may be taken in another order
    than the JAX package takes them."""
    p_sq = torch.sum(points * points, dim=-1)
    out = []
    for start in range(0, query.shape[0], block_q):
        qb = query[start:start + block_q]
        # |q - p|^2 = |q|^2 - 2 q.p + |p|^2, |q|^2 constant along a row
        d = p_sq[None, :] - 2.0 * (qb @ points.T)
        out.append(torch.topk(-d, k, dim=1).indices)
    return torch.cat(out, dim=0)


def estimate_pointcloud_normals(
    points: torch.Tensor, neighborhood_size: int = 20, disambiguate_directions: bool = True
) -> torch.Tensor:
    """(N, 3) -> (N, 3) unit normals: the smallest principal axis of each
    point's KNN neighbourhood. With `disambiguate_directions` each normal
    points toward the origin side of its neighbourhood's mean. The sign of
    an eigenvector is the solver's, so it may differ between devices where
    the disambiguation leaves it free (a normal orthogonal to the mean)."""
    idx = knn_points(points, points, neighborhood_size)
    neigh = points[idx]  # (N, k, 3)
    mu = neigh.mean(dim=1, keepdim=True)
    centered = neigh - mu
    cov = torch.einsum("nki,nkj->nij", centered, centered)
    # eigh: ascending eigenvalues, column 0 is the normal direction
    normals = torch.linalg.eigh(cov).eigenvectors[..., 0]
    if disambiguate_directions:
        sign = torch.sign(torch.sum(normals * -mu[:, 0], dim=-1, keepdim=True))
        normals = normals * torch.where(sign == 0, torch.ones_like(sign), sign)
    return normals


def pointcloud_shaded_grid(
    pcl_grid: torch.Tensor,
    mask: torch.Tensor,
    neighborhood_size: int = 20,
    ambient: float = 0.05,
    ambient_color: float = 0.05,
) -> torch.Tensor:
    """The reference's point-cloud shading (grid_pcl_to_shaded,
    shaded_depth_render.py:209-252): with the light at the camera the shade
    of a view-space point is |n_z| of its camera-facing normal.

    pcl_grid: (H, W, 3) view-space points; mask: (H, W). Every grid point
    takes part in the KNN (static shapes, as in the JAX package) and the
    result is masked afterwards. Returns (H, W, 3) in [0, 1]."""
    H, W, _ = pcl_grid.shape
    normals = estimate_pointcloud_normals(pcl_grid.reshape(-1, 3), neighborhood_size)
    nz = torch.abs(normals[..., 2]).reshape(H, W)
    shaded = (nz * (mask > 0.5))[..., None].expand(H, W, 3)
    shaded = ambient * ambient_color + (1.0 - ambient) * shaded
    return torch.clamp(shaded, 0.0, 1.0)
