"""Soft mesh rasterization with SoftRas-style softmax blending (port of
holo_diffusion_tpu/utils/mesh_render.py; the reference's pytorch3d
MeshRasterizer + SoftGouraudShader + softmax_feature_blend,
mesh_render.py:16-294, and the mesh branch of depth_to_shaded,
shaded_depth_render.py:47-140).

  * rasterization sweeps pixel blocks against every face: the signed
    squared NDC distance to the face and the barycentric depth; the K
    nearest faces by depth within the blur radius are kept
    (faces_per_pixel = topk, perspective_correct off);
  * blending is softmax_feature_blend: sigmoid(-dist / sigma) coverage,
    alpha = 1 - prod(1 - prob), depth weights exp((z_inv - z_inv_max) /
    gamma) with the background term;
  * shading is Gouraud: Phong lighting at the vertices with a point light
    at the scene centre, interpolated by the same barycentrics.

Plain PyTorch (the JAX module has no Pallas kernel). The sweep is
O(pixels x faces): about twenty (block_pixels x faces) float32 temporaries
a block, which is why the reference caps the render size for it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

MATERIALS: Dict[str, Dict] = {
    # shaded_depth_render.py:84-100
    "high_contrast": dict(
        ambient_color=(0.5, 0.5, 0.5),
        diffuse_color=(2.0, 2.0, 2.0),
        specular_color=(1.0, 1.0, 0.9),
        shininess=256.0,
    ),
    "medium": dict(
        ambient_color=(1.0, 1.0, 1.0),
        diffuse_color=(1.0, 1.0, 1.0),
        specular_color=(1.0, 1.0, 0.9),
        shininess=128.0,
    ),
}


def grid_mesh_from_points(
    pcl_grid: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two triangles per quad of the (H, W) point grid (get_grid_mesh,
    shaded_depth_render.py:255-280), with static shapes: a face is valid
    (`face_ok`) when its quad's 4 corners all lie inside the mask.

    pcl_grid: (H, W, 3); mask: (H, W). Returns (verts (H*W, 3), faces
    (F, 3) int64, face_ok (F,) bool)."""
    H, W, _ = pcl_grid.shape
    idx = torch.arange(H * W, device=pcl_grid.device).reshape(H, W)
    # quad corners a=(i,j) b=(i,j+1) c=(i+1,j) d=(i+1,j+1)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[:-1, 1:].reshape(-1)
    c = idx[1:, :-1].reshape(-1)
    d = idx[1:, 1:].reshape(-1)
    m = mask > 0.5
    ok = (m[:-1, :-1] & m[:-1, 1:] & m[1:, :-1] & m[1:, 1:]).reshape(-1)
    # the reference's winding: (a, c, b) and (b, c, d)
    faces = torch.cat([torch.stack([a, c, b], dim=-1), torch.stack([b, c, d], dim=-1)], dim=0)
    return pcl_grid.reshape(-1, 3), faces, torch.cat([ok, ok], dim=0)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor, face_ok: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Area-weighted unit vertex normals (pytorch3d verts_normals_packed)."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    if face_ok is not None:
        fn = fn * face_ok[:, None]
    out = torch.zeros_like(verts)
    for i in range(3):
        out.index_add_(0, faces[:, i], fn)
    return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-12)


def gouraud_vertex_colors(
    verts: torch.Tensor,
    normals: torch.Tensor,
    textures: torch.Tensor,
    light_location=(0.0, 0.0, 0.0),
    ambient_color=(1.0, 1.0, 1.0),
    diffuse_color=(1.0, 1.0, 1.0),
    specular_color=(0.0, 0.0, 0.0),
    shininess: float = 128.0,
) -> torch.Tensor:
    """Phong lighting at the vertices, camera at the origin (view space), a
    point light at `light_location` (SoftGouraudShader + PointLights,
    mesh_render.py:70-105)."""
    def vec(x):
        return torch.as_tensor(x, dtype=verts.dtype, device=verts.device)

    def unit(v):
        return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-12)

    l = unit(vec(light_location) - verts)
    v = unit(-verts)
    # normals turned toward the camera
    facing = torch.sum(normals * v, dim=-1, keepdim=True)
    n = normals * torch.sign(torch.where(facing == 0, torch.ones_like(facing), facing))
    cos = torch.clamp(torch.sum(n * l, dim=-1, keepdim=True), 0.0, 1.0)
    # pytorch3d specular: the light reflected about the normal, against the view
    r = 2.0 * cos * n - l
    spec_cos = torch.clamp(torch.sum(r * v, dim=-1, keepdim=True), 0.0, 1.0)
    ambient = vec(ambient_color) * textures
    diffuse = vec(diffuse_color) * cos * textures
    specular = vec(specular_color) * spec_cos ** shininess
    return ambient + diffuse + specular


def _edge_dist_sq(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance from points p (..., 2) to the segments ab."""
    ab = b - a
    t = torch.sum((p - a) * ab, dim=-1) / torch.clamp(torch.sum(ab * ab, dim=-1), min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    proj = a + t[..., None] * ab
    return torch.sum((p - proj) ** 2, dim=-1)


def soft_rasterize(
    verts_view: torch.Tensor,
    faces: torch.Tensor,
    vert_colors: torch.Tensor,
    image_size: Tuple[int, int],
    focal_length=(1.0, 1.0),
    principal_point=(0.0, 0.0),
    face_ok: Optional[torch.Tensor] = None,
    topk: int = 10,
    sigma: float = 1e-4,
    gamma: float = 1e-4,
    blur_radius: Optional[float] = None,
    background_color=(0.0, 0.0, 0.0),
    znear: float = 0.01,
    zfar: float = 1000.0,
    min_depth: float = 1e-3,
    block_pixels: int = 512,
):
    """Soft-rasterize a view-space mesh into (image (H, W, C), alpha (H, W, 1),
    depth (H, W, 1)) with the reference's blending, `block_pixels` pixels
    against all faces at a time."""
    H, W = image_size
    dev, dt = verts_view.device, verts_view.dtype
    if blur_radius is None:
        blur_radius = math.log(1.0 / 1e-4 - 1.0) * sigma  # mesh_render.py:44

    # signed depth clamp (mesh_render.py:16-19, 54-61)
    z = verts_view[..., 2:]
    sign = torch.sign(z) + (z == 0.0).to(dt)
    z = sign * torch.clamp(torch.abs(z), min=min_depth)
    verts_view = torch.cat([verts_view[..., :2], z], dim=-1)

    # NDC projection with a trivial camera (R = I, T = 0; mesh_render.py:63-66)
    f = torch.as_tensor(focal_length, dtype=dt, device=dev)
    pp = torch.as_tensor(principal_point, dtype=dt, device=dev)
    xy = verts_view[..., :2] * f / verts_view[..., 2:] + pp

    tri_xy = xy[faces]  # (F, 3, 2)
    tri_z = verts_view[..., 2][faces]  # (F, 3)
    valid_face = torch.all(tri_z > 0, dim=-1)
    if face_ok is not None:
        valid_face = valid_face & face_ok

    # pixel centres in NDC (pytorch3d: +x left, +y up; the shorter side
    # spans [-1, 1])
    short = min(H, W)
    ys = (1.0 - (2.0 * torch.arange(H, device=dev, dtype=dt) + 1.0) / H) * (H / short)
    xs = (1.0 - (2.0 * torch.arange(W, device=dev, dtype=dt) + 1.0) / W) * (W / short)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([px, py], dim=-1).reshape(-1, 2)

    a, b, c = tri_xy[:, 0], tri_xy[:, 1], tri_xy[:, 2]
    det = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    det_safe = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    tri_col = vert_colors[faces]  # (F, 3, C)
    bg = torch.as_tensor(background_color, dtype=dt, device=dev)
    eps = 1e-10

    cols, alphas, depths = [], [], []
    for start in range(0, pix.shape[0], block_pixels):
        pb = pix[start:start + block_pixels]
        # barycentrics of each pixel in each face: (block, F)
        pa = pb[:, None, :] - a[None]
        w_b = (pa[..., 0] * (c[:, 1] - a[:, 1]) - pa[..., 1] * (c[:, 0] - a[:, 0])) / det_safe
        w_c = (pa[..., 1] * (b[:, 0] - a[:, 0]) - pa[..., 0] * (b[:, 1] - a[:, 1])) / det_safe
        w_a = 1.0 - w_b - w_c
        inside = (w_a >= 0) & (w_b >= 0) & (w_c >= 0)

        q = pb[:, None]
        edge_sq = torch.minimum(_edge_dist_sq(q, a[None], b[None]),
                                torch.minimum(_edge_dist_sq(q, b[None], c[None]), _edge_dist_sq(q, c[None], a[None])))
        dists = torch.where(inside, -edge_sq, edge_sq)  # signed squared NDC distance

        zbuf = w_a * tri_z[:, 0] + w_b * tri_z[:, 1] + w_c * tri_z[:, 2]
        hit = valid_face[None] & (dists < blur_radius) & (zbuf > znear)

        # the K nearest hits by depth; where fewer than K faces hit, the
        # rest are non-hits that k_hit zeroes
        score = torch.where(hit, -zbuf, torch.full_like(zbuf, -float("inf")))
        top_idx = torch.topk(score, topk, dim=1).indices  # (block, K)
        k_hit = torch.gather(hit, 1, top_idx).to(dt)
        k_dists = torch.gather(dists, 1, top_idx)
        k_z = torch.gather(zbuf, 1, top_idx)
        k_col = (torch.gather(w_a, 1, top_idx)[..., None] * tri_col[top_idx, 0]
                 + torch.gather(w_b, 1, top_idx)[..., None] * tri_col[top_idx, 1]
                 + torch.gather(w_c, 1, top_idx)[..., None] * tri_col[top_idx, 2])

        # softmax_feature_blend (mesh_render.py:201-294)
        prob = torch.sigmoid(-k_dists / sigma) * k_hit
        alphas.append(1.0 - torch.prod(1.0 - prob, dim=-1))
        z_inv = (zfar - k_z) / (zfar - znear) * k_hit
        z_inv_max = torch.clamp(torch.max(z_inv, dim=-1, keepdim=True).values, min=eps)
        weights_num = prob * torch.exp((z_inv - z_inv_max) / gamma)
        delta = torch.clamp(torch.exp((eps - z_inv_max[..., 0]) / gamma), min=eps)
        denom = torch.sum(weights_num, dim=-1) + delta
        cols.append((torch.sum(weights_num[..., None] * k_col, dim=-2) + delta[..., None] * bg) / denom[..., None])
        depths.append(torch.sum(weights_num * k_z, dim=-1) / denom)

    C = vert_colors.shape[-1]
    return (torch.cat(cols).reshape(H, W, C), torch.cat(alphas).reshape(H, W, 1),
            torch.cat(depths).reshape(H, W, 1))


def mesh_render_shaded(
    pcl_grid: torch.Tensor,
    mask: torch.Tensor,
    focal_length=(1.0, 1.0),
    principal_point=(0.0, 0.0),
    material: str = "medium",
    topk: int = 10,
    background_color=(0.0, 0.0, 0.0),
    scene_center=(0.0, 0.0, 0.0),
    block_pixels: int = 512,
):
    """The reference's grid_pcl_to_shaded_mesh (shaded_depth_render.py:47-140):
    view-space depth grid -> quad mesh -> Gouraud shading with a point light
    at the scene centre -> soft rasterization.

    pcl_grid: (H, W, 3); mask: (H, W). Returns (shaded (H, W, 3),
    render_mask (H, W, 1), depth (H, W, 1))."""
    H, W, _ = pcl_grid.shape
    verts, faces, face_ok = grid_mesh_from_points(pcl_grid, mask)
    normals = vertex_normals(verts, faces, face_ok)
    colors = gouraud_vertex_colors(verts, normals, torch.ones_like(verts), light_location=scene_center,
                                   **MATERIALS[material])
    shaded, alpha, depth = soft_rasterize(
        verts, faces, colors, (H, W), focal_length=focal_length, principal_point=principal_point,
        face_ok=face_ok, topk=topk, background_color=background_color, block_pixels=block_pixels,
    )
    return torch.clamp(shaded, 0.0, 1.0), (alpha > 0.5).to(torch.float32), depth
