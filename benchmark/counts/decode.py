"""Bytes and FLOPs of the render decode (trilinear sample, the density net
collapsed to one affine map, the radiance layer), forward and backward, from
shapes alone: the work the inputs need, whichever kernel does it."""
from __future__ import annotations


def decode_cost(n_points, n_rays, grid_shape, hidden, pe_dim, normals):
    """(bytes, flops) the fused decode must move and do: each input read
    once, each output written once; per point the trilinear sample, the
    collapsed density affine and the radiance layer."""
    D, H, W, C = grid_shape
    j = hidden + 1
    lanes = 7 if normals else 4
    n_bytes = 4 * (
        n_points * 3 + n_rays * pe_dim + D * H * W * C + C * j + j
        + (hidden + pe_dim) * 3 + 3 + (D * H * W if normals else 0)
        + n_points * lanes
    )
    per_point = 2 * 8 * C + 2 * C * j + 2 * (hidden + pe_dim) * 3 + (2 * 8 * 3 if normals else 0)
    return n_bytes, n_points * per_point


def decode_bwd_cost(n_points, n_rays, grid_shape, hidden, pe_dim):
    """(bytes, flops, bytes with the grid scatter's read-modify-writes) of
    the decode backward. Bytes: each input read once (points, per-ray
    directions, the (n, 4) cotangent, grid and weights), each cotangent
    written once. FLOPs per point: the recomputed forward (sample, affine,
    radiance layer), then dWr, d_rin, dA, d_s and the 8-corner scatter.
    The third figure adds 8 corners x C read-modify-writes of d_grid per
    point, which the scatter makes (in L2 on the H100)."""
    D, H, W, C = grid_shape
    j = hidden + 1
    n_in = n_points * (3 + 4) + n_rays * pe_dim + D * H * W * C + C * j + j + (hidden + pe_dim) * 3 + 3
    n_out = D * H * W * C + C * j + j + (hidden + pe_dim) * 3 + 3
    fwd = 2 * 8 * C + 2 * C * j + 2 * (hidden + pe_dim) * 3
    bwd = 2 * (hidden + pe_dim) * 3 + 2 * 3 * hidden + 2 * C * j + 2 * C * j + 2 * 8 * C
    n_bytes = 4 * (n_in + n_out)
    return n_bytes, n_points * (fwd + bwd), n_bytes + 4 * 2 * 8 * C * n_points


def decode_bwd_only_flops(n_points, C, hidden, pe_dim):
    """The backward's own FLOPs, without the forward that `decode_bwd_cost`
    counts again (for model FLOPs, which count no recompute)."""
    j = hidden + 1
    return n_points * (2 * (hidden + pe_dim) * 3 + 2 * 3 * hidden + 2 * C * j + 2 * C * j + 2 * 8 * C)


def pe_dim(spec) -> int:
    return 3 * (2 * int(spec.mlp["dir_emb_dims"]) + 1)


def grid_shape(spec):
    return (spec.resol, spec.resol, spec.resol, spec.feature_size)


def render_passes(spec, n_rays: int, training: bool):
    """[(points, rays)] of each pass of the multi-pass render of n_rays rays."""
    n_pts = spec.n_pts_train if training else spec.n_pts_eval
    n_fine = spec.n_fine_train if training else spec.n_fine_eval
    out, per_ray = [], n_pts
    for k in range(spec.num_passes):
        if k > 0:
            per_ray = n_fine + (per_ray if spec.append_coarse else 0)
        out.append((n_rays * per_ray, n_rays))
    return out


def train_rays(spec, n_frames: int) -> int:
    nt = n_frames if spec.n_train_target_views <= 0 else min(spec.n_train_target_views, n_frames)
    return nt * spec.n_rays_train


def frame_rays(spec) -> int:
    return spec.render_height * spec.render_width


def least_seconds(n_bytes: float, flops: float, peak_flops: float, peak_bytes: float) -> float:
    """The roofline's least time: the larger of bytes at the bandwidth and
    FLOPs at the peak."""
    return max(n_bytes / peak_bytes, flops / peak_flops)
