"""Compact-source batches (port of holo_diffusion_tpu/data/compact.py): the
pooling sources preprocessed and resized on the host before the copy.

A training batch is `n_targets` render targets and S pooling sources. Only
the targets need full resolution (the photometric loss samples them at each
ray); the sources go through the feature extractor after its 0.32x resize.
`SourceCompactor` does the sources' preprocessing on the host (binarise the
foreground, composite onto `bg_color`, then the extractor's resize) and
requantises them to uint8, so a 33-frame 800^2 batch copies ~30 MB instead
of ~147 MB (JAX compact.py:9-15).

Two host resizes (`host_resize`):
  * "native" (default): the C++ composite + bilinear resize of
    `csrc/preprocess.cpp` (`hd_compact_source_batch_u8`, JAX's own routine,
    the same bits), one pass over each frame on the library's thread pool;
  * "exact": `ops/image.py:resize_image` (the extractor's own resize) on
    CPU tensors, after the composite at full resolution.
The library is built at first use; a failed build raises (there is no
switch to "exact" behind it, unlike JAX compact.py:121-125).

The approximation is JAX's (compact.py:27-35): the extractor also hands its
raw input images and masks to the view sampler, so in compact mode 4 of the
68 pooled channels are sampled from the resized maps, and the uint8
requantisation adds up to ~0.2 % a pixel. The ResNet features are exact up
to that quantisation.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.image import resize_image
from .frame_data import FrameData

Frames = Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]


def _unit_float(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """uint8 -> float32 / 255, anything else -> float32 (metrics.as_unit_float)."""
    if x is None:
        return None
    return x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.to(torch.float32)


def _quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> uint8, rounding half to even (as `jnp.round`)."""
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)


def _as_u8(x: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if x is None or x.dtype == np.uint8:
        return x
    return np.clip(np.round(np.asarray(x, np.float32) * 255.0), 0, 255).astype(np.uint8)


class SourceCompactor:
    """FrameData -> compact FrameData, on the host. `n_train_target_views`,
    the masking arguments and `image_rescale` must be the model's: build it
    with `from_model`."""

    def __init__(
        self,
        n_train_target_views: int,
        image_rescale: float,
        mask_images: bool,
        mask_threshold: float,
        bg_color,
        drop_depth: bool = False,
        host_resize: str = "native",
    ):
        if host_resize not in ("native", "exact"):
            raise ValueError(f"host_resize must be 'native' or 'exact', got {host_resize!r}")
        self.n_train_target_views = n_train_target_views
        self.image_rescale = float(image_rescale)
        self.mask_images = bool(mask_images)
        self.mask_threshold = float(mask_threshold)
        self.bg_color = tuple(float(c) for c in np.asarray(bg_color).reshape(-1))
        self.drop_depth = bool(drop_depth)
        self.host_resize = host_resize

    @classmethod
    def from_model(cls, model, drop_depth: bool = False, host_resize: str = "native") -> "SourceCompactor":
        if not model.view_pooler_enabled:
            raise ValueError("compact sources need the model's view pooler")
        return cls(
            n_train_target_views=model.n_train_target_views,
            image_rescale=model.image_feature_extractor.image_rescale,
            mask_images=model.mask_images,
            mask_threshold=model.mask_threshold,
            bg_color=model.bg_color,
            drop_depth=drop_depth,
            host_resize=host_resize,
        )

    def n_targets(self, batch_size: int) -> int:
        """The model's training split (`HoloDiffusionModel.forward`)."""
        nt = batch_size if self.n_train_target_views <= 0 else min(self.n_train_target_views, batch_size)
        return 1 if batch_size <= nt else nt

    def _compact_exact(self, img, fg, mc, out_h: int, out_w: int) -> Frames:
        """Composite at full resolution, then the extractor's resize, in
        float32 on the CPU."""
        img, fg, mc = _unit_float(img), _unit_float(fg), _unit_float(mc)
        fg_out = mc_out = None
        if fg is not None:
            fg_bin = (fg > self.mask_threshold).to(torch.float32)
            if self.mask_images:
                bg = torch.tensor(self.bg_color, dtype=torch.float32)
                img = img * fg_bin + bg * (1.0 - fg_bin)
            fg_out = _quantize_u8(resize_image(fg_bin, out_h, out_w))
        img_out = _quantize_u8(resize_image(img, out_h, out_w))
        if mc is not None:
            mc_out = _quantize_u8(resize_image(mc, out_h, out_w))
        return img_out, fg_out, mc_out

    def _compact_native(self, img, fg, mc, out_h: int, out_w: int) -> Frames:
        """The C++ composite + resize of every frame in one pass; the
        mask_crop through the loader's crop/resize of the whole frame."""
        from ..native import compact_source_batch_u8, crop_resize_batch_u8

        img, fg, mc = (None if x is None else _as_u8(x.numpy()) for x in (img, fg, mc))
        S, H, W = img.shape[:3]
        img_c, fg_c = compact_source_batch_u8(img, fg, (out_h, out_w), self.mask_threshold, self.bg_color,
                                              self.mask_images)
        mc_c = None
        if mc is not None:
            boxes = np.tile(np.array([0, 0, W, H], np.int32), (S, 1))
            mc_f = crop_resize_batch_u8(list(mc), boxes, (out_h, out_w), scale=1.0)
            mc_c = np.clip(np.round(mc_f), 0, 255).astype(np.uint8)
        return tuple(None if x is None else torch.from_numpy(x) for x in (img_c, fg_c, mc_c))

    def compact_frames(self, img: torch.Tensor, fg: Optional[torch.Tensor], mc: Optional[torch.Tensor]) -> Frames:
        """A stack of frames (S, H, W, C) compacted as `__call__` compacts a
        batch's sources: (img, fg, mask_crop) as uint8 at the extractor's
        input resolution, on the device the frames lie on."""
        dev = img.device
        H, W = img.shape[1:3]
        out_h, out_w = int(H * self.image_rescale), int(W * self.image_rescale)
        fn = self._compact_native if self.host_resize == "native" else self._compact_exact
        out = fn(*(None if x is None else x.cpu() for x in (img, fg, mc)), out_h, out_w)
        return tuple(None if x is None else x.to(dev) for x in out)

    def __call__(self, batch: FrameData) -> FrameData:
        if batch.image_rgb is None or batch.src_image_rgb is not None:
            return batch  # nothing to compact, or compact already
        nt = self.n_targets(batch.batch_size)
        if batch.batch_size <= nt:
            return batch  # no separate sources

        def tgt(x):
            return None if x is None else x[:nt]

        def src(x):
            return None if x is None else x[nt:]

        img_c, fg_c, mc_c = self.compact_frames(src(batch.image_rgb), src(batch.fg_probability),
                                                src(batch.mask_crop))
        return FrameData(
            camera=batch.camera,  # every frame's camera, targets first
            image_rgb=tgt(batch.image_rgb),
            fg_probability=tgt(batch.fg_probability),
            mask_crop=tgt(batch.mask_crop),
            depth_map=None if self.drop_depth else tgt(batch.depth_map),
            sequence_id=batch.sequence_id,
            src_image_rgb=img_c,
            src_fg_probability=fg_c,
            src_mask_crop=mc_c,
        )


class CompactSceneSampler:
    """A scene dataset whose batches come compact, from an LRU cache of
    compacted scenes (`max_cached_scenes`, 0 or less for no bound).

    Compaction is deterministic for each frame, and the same-sequence
    batches touch each scene's frames again and again, so each scene is
    compacted once (the C++ routine over all its frames) and a batch is its
    targets at full resolution plus cached compact sources. `hits` and
    `misses` count the cache's lookups. A batch is bitwise
    `compactor(dataset.sample_batch(rng, B))` for the same `rng`, which it
    consumes by the same calls (one `randint` for the scene, one `choice`
    for the frames)."""

    def __init__(self, dataset, compactor: SourceCompactor, max_cached_scenes: int = 4):
        self.dataset = dataset
        self.compactor = compactor
        self._max_cached = int(max_cached_scenes)
        self._cache: "OrderedDict[int, Frames]" = OrderedDict()
        self.hits = self.misses = 0

    def __len__(self):
        return len(self.dataset)

    def _get_scene(self, s: int) -> FrameData:
        ds = self.dataset
        return ds.get_scene(s) if hasattr(ds, "get_scene") else ds.scenes[s]

    def _compact_scene(self, s: int, scene: FrameData) -> Frames:
        if s in self._cache:
            self.hits += 1
            self._cache.move_to_end(s)
            return self._cache[s]
        self.misses += 1
        self._cache[s] = self.compactor.compact_frames(scene.image_rgb, scene.fg_probability, scene.mask_crop)
        if self._max_cached > 0 and len(self._cache) > self._max_cached:
            self._cache.popitem(last=False)  # evict the least recently used
        return self._cache[s]

    def sample_batch(self, rng: np.random.RandomState, batch_size: int) -> FrameData:
        s = int(rng.randint(len(self.dataset)))
        scene = self._get_scene(s)
        n = scene.batch_size
        replace = n < batch_size
        idx = rng.choice(n, size=batch_size if replace else min(batch_size, n), replace=replace)
        comp = self.compactor
        nt = comp.n_targets(len(idx))
        dev = scene.camera.R.device
        if scene.image_rgb is None or len(idx) <= nt:
            # SourceCompactor.__call__'s no-op cases
            return comp(scene[torch.as_tensor(idx, device=dev)])
        img_c, fg_c, mc_c = self._compact_scene(s, scene)
        every, ti, si = (torch.as_tensor(i, device=dev) for i in (idx, idx[:nt], idx[nt:]))

        def take(x, which):
            return None if x is None else x[which]

        return FrameData(
            camera=scene.camera[every],
            image_rgb=take(scene.image_rgb, ti),
            fg_probability=take(scene.fg_probability, ti),
            mask_crop=take(scene.mask_crop, ti),
            depth_map=None if comp.drop_depth else take(scene.depth_map, ti),
            sequence_id=take(scene.sequence_id, every),
            src_image_rgb=take(img_c, si),
            src_fg_probability=take(fg_c, si),
            src_mask_crop=take(mc_c, si),
        )
