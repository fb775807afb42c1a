"""Chunked full-image evaluation rendering, with the evaluation-only
empty-space skip, and the render with rays sharded over ranks (port of
holo_diffusion_tpu/render_eval.py).

A dense H x W render is split into chunks of `chunk_size_grid //
n_pts_per_ray_evaluation` rays (the reference's chunking: 40960 points ->
640 rays per chunk at the hydrant config), rendered one after another;
device memory stays bounded whatever the image size. `render_image_sharded`
gives each rank of a mesh a contiguous share of the rays instead, rendered
in one forward.

On the card a render of more than one chunk replays each chunk from a CUDA
graph: one chunk's render (its tightening by the empty-space skip
included), captured once per chunk shape and replayed for every chunk of
that shape, so the host makes two copies and one replay a chunk in place
of the render's ~155 launches. The graphs live as long as the model, keyed
by what the code observes (`_graph_key`: the storage of the model's
parameters and buffers, the implicit function's modes, the float32 matmul
precision; then the grid's and occupancy's shapes, the probes, the chunk's
shape): weights updated in place are read live, weights moved or replaced
capture anew. What runs in Python inside the render runs at the warm-up
and the capture alone: the spans and `count` counters (`holo.render.*`,
`holo.decode`, `decodes_fused`) and the kernels' launch counters, which
count the warm-up's launches and not the capture's calls; a replay's
kernels show only in a device trace. Each chunk adds 1 to
the counter `chunks_graphed` or `chunks_eager`, each capture 1 to
`chunk_graph_captures` (`utils/profiling.py` `count`, while a torch
profiler records). Eager or graphed, a chunk renders through
`render_packed` from the frame's packed rays into one packed frame. The
CPU, single-chunk renders, `make_chunk_renderer` and
`render_image_sharded` run eagerly.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from .device import DeviceLike, place
from .geometry.cameras import PerspectiveCameras
from .geometry.rays import RayBundle
from .models.holo_model import HoloDiffusionModel
from .models.renderer import RendererOutput
from .ops.occupancy import occupancy_from_density, tighten_ray_bundle
from .ops.voxel import voxel_coord_grid
from .parallel.mesh import Mesh
from .utils.cuda_graphs import GraphCache, storage_key
from .utils.profiling import count, span
from .weights import check_keys

Occupancy = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]
# (occupancy mask (r, r, r), outside_occupied) of a render with the skip
Skip = Tuple[torch.Tensor, Union[bool, torch.Tensor]]


def make_chunk_render_fn(
    model: HoloDiffusionModel,
) -> Callable[[torch.Tensor, RayBundle], RendererOutput]:
    """fn(voxel_grid, ray_bundle_chunk) -> RendererOutput, without autograd."""

    @torch.no_grad()
    def chunk_render(voxel_grid: torch.Tensor, bundle: RayBundle) -> RendererOutput:
        return model.render_rays(voxel_grid, bundle)

    return chunk_render


class _RenderRays(torch.nn.Module):
    def __init__(self, model: HoloDiffusionModel):
        super().__init__()
        self.model = model

    def forward(self, voxel_grid, bundle):
        return self.model.render_rays(voxel_grid, bundle)


def make_chunk_renderer(
    model: HoloDiffusionModel, variables: Mapping[str, torch.Tensor],
) -> Callable[[torch.Tensor, RayBundle], RendererOutput]:
    """`make_chunk_render_fn` with the weights `variables` (a state_dict of
    `model`) bound: fn(voxel_grid, bundle) renders through them, leaving the
    model's own parameters as they are. Raises naming any key `variables`
    lacks or `model` does not have."""
    check_keys(model, variables.keys(), what="variables")
    wrapper = _RenderRays(model)
    bound = {f"model.{k}": v for k, v in variables.items()}

    @torch.no_grad()
    def chunk_render(voxel_grid: torch.Tensor, bundle: RayBundle) -> RendererOutput:
        return torch.func.functional_call(wrapper, bound, (voxel_grid, bundle))

    return chunk_render


@torch.no_grad()
def compute_occupancy(
    model: HoloDiffusionModel,
    voxel_grid: torch.Tensor,
    resolution: int = 64,
    threshold: float = 0.0,
    dilate: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The probe pass of the empty-space skip (ops/occupancy.py):
    ((r, r, r) bool occupancy of the decoded density field, 0-d bool
    `outside_occupied`, whether space outside the voxel volume contributes).
    One implicit-function call over the voxel-centre lattice of
    `resolution`^3 points plus one point far outside the volume, where the
    features sample to zero and the raw density is the constant the density
    net emits for empty space. Compute once per grid, reuse across views."""
    dev = voxel_grid.device
    pts = voxel_coord_grid(resolution, model.volume_extent, device=dev).reshape(-1, 3)
    far_out = torch.full((1, 3), 1e6, dtype=torch.float32, device=dev)
    raw = model.query_density(voxel_grid, torch.cat([pts, far_out]))
    lattice = raw[:-1].reshape(resolution, resolution, resolution)
    return occupancy_from_density(lattice, threshold, dilate), raw[-1] > threshold


@torch.no_grad()
def render_image_chunked(
    model: HoloDiffusionModel,
    camera: PerspectiveCameras,
    voxel_grid: torch.Tensor,
    image_height: Optional[int] = None,
    image_width: Optional[int] = None,
    device: DeviceLike = None,
    empty_space_skip: bool = False,
    occupancy: Optional[Occupancy] = None,
    occupancy_resolution: int = 64,
    occupancy_threshold: float = 0.0,
    occupancy_probes: int = 128,
) -> Dict[str, torch.Tensor]:
    """Render camera[:1] densely in ray chunks (one chunk for the whole image
    when the model's `chunk_size_grid` is 0).

    voxel_grid: (r, r, r, C). Returns (H, W, c) tensors on the device:
    images/depths/masks[/normals]_render. The model moves to `device`
    (CUDA unless the caller passes "cpu").

    With `empty_space_skip`, or an `occupancy` given (a bare (r, r, r) mask,
    outside the volume empty, or the (mask, outside_occupied) pair of
    `compute_occupancy`), each chunk's rays are tightened to their occupied
    segments before rendering; without `occupancy` it is probed here.

    The outputs are views of one packed (H * W, 5 or 8) frame. On the card,
    with more than one chunk, each chunk replays the model's graph of its
    shape (module docstring); elsewhere the chunks render eagerly.
    """
    dev = place(model, device)
    H = image_height or model.render_image_height
    W = image_width or model.render_image_width
    n_rays = H * W
    n_pts = model.n_pts_per_ray_evaluation
    step = max((model.chunk_size_grid or n_rays * n_pts) // n_pts, 1)
    bundle = model.full_grid_rays(camera[:1].to(dev), H, W)
    voxel_grid = voxel_grid.to(dev)
    skip = None
    if empty_space_skip or occupancy is not None:
        if occupancy is None:
            occupancy = compute_occupancy(model, voxel_grid, occupancy_resolution, occupancy_threshold)
        skip = occupancy if isinstance(occupancy, tuple) else (occupancy, False)
    rays = pack_rays(bundle)
    if dev.type == "cuda" and n_rays > step:
        graphs = _ChunkGraphs.of(model, dev, _graph_key(model))
        scene = graphs.load_scene(voxel_grid, skip)
        path = "chunks_graphed"

        def render(chunk):
            return graphs.replay(model, scene, chunk, occupancy_probes)
    else:
        path = "chunks_eager"

        def render(chunk):
            return render_packed(model, voxel_grid, chunk, skip, occupancy_probes)
    frame = None
    for start in range(0, n_rays, step):
        with span("holo.chunk"):
            chunk = rays[start:start + step]
            out = render(chunk)
            if frame is None:
                frame = out.new_empty((n_rays, out.shape[1]))
            frame[start:start + chunk.shape[0]].copy_(out)
            count(path, 1)
    return unpack_frame(frame, H, W)


def pack_rays(bundle: RayBundle) -> torch.Tensor:
    """A one-camera bundle's rays as one (N, 8 + P) tensor: origins,
    directions, lengths (P a ray), xys."""
    return torch.cat([bundle.origins, bundle.directions, bundle.lengths, bundle.xys], dim=-1)[0]


def unpack_rays(rays: torch.Tensor) -> RayBundle:
    """`pack_rays`' inverse, as views of `rays`."""
    return RayBundle(origins=rays[None, :, 0:3], directions=rays[None, :, 3:6], lengths=rays[None, :, 6:-2],
                     xys=rays[None, :, -2:])


def render_packed(model: HoloDiffusionModel, voxel_grid: torch.Tensor, rays: torch.Tensor,
                  skip: Optional[Skip], n_probe: int) -> torch.Tensor:
    """One chunk's render from packed rays (`pack_rays`), tightened by the
    skip where there is one, through `make_chunk_render_fn` -> (N, 5) RGB,
    depth, mask, or (N, 8) with the normals: what an eager chunk runs and
    what a chunk's graph captures."""
    bundle = unpack_rays(rays)
    if skip is not None:
        bundle = tighten_ray_bundle(bundle, skip[0], model.volume_extent, n_probe=n_probe, outside_occupied=skip[1])
    out = make_chunk_render_fn(model)(voxel_grid, bundle)
    parts = [out.features[0, :, :3], out.depths[0], out.masks[0]]
    if out.normals is not None:
        parts.append(out.normals[0])
    return torch.cat(parts, dim=-1)


def unpack_frame(frame: torch.Tensor, H: int, W: int) -> Dict[str, torch.Tensor]:
    """A frame's packed (H * W, 5 or 8) rows (`render_packed`) -> the
    (H, W, c) outputs of `render_image_chunked`, as views of `frame`."""
    cols = {"images_render": (0, 3), "depths_render": (3, 4), "masks_render": (4, 5), "normals_render": (5, 8)}
    return {k: frame[:, a:b].reshape(H, W, b - a) for k, (a, b) in cols.items() if b <= frame.shape[1]}


# ---- the chunk loop's CUDA graphs

def _graph_key(model: HoloDiffusionModel):
    """What a chunk graph of `model` takes as fixed: the implicit function's
    modes, the float32 matmul precision, and where each parameter and
    buffer is stored (their values are read live at each replay)."""
    f = model.implicit_function
    return ((f.render_normals, f.sampler, f.collapse_density, f.fuse_decode, torch.get_float32_matmul_precision()),
            storage_key(model))


class _Scene:
    """The static copies of a render's grid and skip that the graphs read."""

    def __init__(self, key: tuple, voxel_grid: torch.Tensor, skip: Optional[Skip]):
        self.key = key
        self.grid = torch.empty(voxel_grid.shape, dtype=voxel_grid.dtype, device=voxel_grid.device)
        self.skip = None
        if skip is not None:
            self.skip = (torch.empty_like(skip[0]), torch.empty((), dtype=torch.bool, device=voxel_grid.device))

    def load(self, voxel_grid: torch.Tensor, skip: Optional[Skip]) -> "_Scene":
        self.grid.copy_(voxel_grid)
        if skip is not None:
            self.skip[0].copy_(skip[0])
            self.skip[1].copy_(torch.as_tensor(skip[1]))
        return self


class _ChunkGraphs(GraphCache):
    """One model's chunk graphs on one device (`utils/cuda_graphs.py`): the
    static scenes by grid and occupancy shape, and the graphs by scene,
    probes and chunk shape, each with its static rays and its static
    output. `_ChunkGraphs.of(model, dev, _graph_key(model))` gets them."""

    _of = weakref.WeakKeyDictionary()  # model -> {device: _ChunkGraphs}

    def __init__(self, dev: torch.device):
        super().__init__(dev)
        self.scenes: Dict[tuple, _Scene] = {}
        self.graphs: Dict[tuple, tuple] = {}

    def load_scene(self, voxel_grid: torch.Tensor, skip: Optional[Skip]) -> _Scene:
        key = (tuple(voxel_grid.shape), None if skip is None else tuple(skip[0].shape))
        if key not in self.scenes:
            self.scenes[key] = _Scene(key, voxel_grid, skip)
        return self.scenes[key].load(voxel_grid, skip)

    def replay(self, model, scene: _Scene, rays: torch.Tensor, n_probe: int) -> torch.Tensor:
        """Render the chunk `rays` through its graph, captured on first use;
        returns the graph's static output, valid until the next replay."""
        key = (scene.key, n_probe, tuple(rays.shape))
        if key not in self.graphs:
            self.graphs[key] = self._capture(model, scene, rays, n_probe)
        graph, static_rays, static_out = self.graphs[key]
        static_rays.copy_(rays)
        graph.replay()
        return static_out

    def _capture(self, model, scene: _Scene, rays: torch.Tensor, n_probe: int):
        count("chunk_graph_captures", 1)
        static_rays = rays.clone()
        graph, static_out = self.capture(render_packed, model, scene.grid, static_rays, scene.skip, n_probe)
        return graph, static_rays, static_out


@torch.no_grad()
def render_image_sharded(
    model: HoloDiffusionModel,
    camera: PerspectiveCameras,
    voxel_grid: torch.Tensor,
    mesh: Mesh,
    image_height: Optional[int] = None,
    image_width: Optional[int] = None,
) -> Dict[str, torch.Tensor]:
    """Dense render of camera[:1] with the rays sharded over `mesh`'s ranks
    and the grid replicated: the H * W rays, padded with copies of the last
    ray to a multiple of the world size (JAX's `jnp.pad(..., mode="edge")`),
    give each rank one contiguous share, rendered in one `render_rays`
    forward; one `all_gather` a output brings the shares to every rank.
    Returns JAX's keys, images/depths/masks_render, as (H, W, c) tensors on
    the mesh's device, on every rank. The model moves to that device."""
    if mesh is None:
        raise ValueError("render_image_sharded needs a mesh (parallel.mesh.make_mesh)")
    dev = place(model, mesh.device)
    H = image_height or model.render_image_height
    W = image_width or model.render_image_width
    n_rays, world = H * W, mesh.world_size
    share = -(-n_rays // world)
    bundle = model.full_grid_rays(camera[:1].to(dev), H, W)
    pad = share * world - n_rays
    if pad:
        bundle = RayBundle(*(torch.cat([x, x[:, -1:].expand(-1, pad, *x.shape[2:])], dim=1)
                             for x in (bundle.origins, bundle.directions, bundle.lengths, bundle.xys)))
    part = bundle.slice_rays(slice(mesh.rank * share, (mesh.rank + 1) * share))
    out = model.render_rays(voxel_grid.to(dev), part)
    result = {}
    for key, x in (("images_render", out.features[0, :, :3]), ("depths_render", out.depths[0]),
                   ("masks_render", out.masks[0])):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous(), group=mesh.group)
        result[key] = torch.cat(parts)[:n_rays].reshape(H, W, -1)
    return result
