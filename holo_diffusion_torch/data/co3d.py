"""CO3Dv2 dataset loader (port of holo_diffusion_tpu/data/co3d.py).

The used subset of Implicitron's JsonIndexDatasetMapProviderV2 /
JsonIndexDataset + SequenceDataLoaderMapProvider: frame and sequence `.jgz`
annotations, `set_lists/set_lists_{subset}.json` splits, box crop by mask
(threshold 0.4, context 0.3), square resize, same-sequence batches, fg masks
and depth maps. Host-side: frames are decoded and cropped on the CPU (PIL
for JPEG, `data/image_io.py` for PNG masks and depths, the C++ crop/resize
of `native/` for square boxes, torch's resize otherwise) into an LRU cache
of CPU tensors; the training loop pins a batch and copies it to the card.

Camera conventions: CO3D stores pytorch3d cameras with NDC intrinsics in
either "ndc_norm_image_bounds" (per-axis) or "ndc_isotropic" (min-side)
format; everything is converted to isotropic square NDC (the port's
PerspectiveCameras convention) and the intrinsics are rewritten through the
box crop, pad and resize.
"""
from __future__ import annotations

import gzip
import json
import logging
import os
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..geometry.cameras import PerspectiveCameras
from ..native import crop_resize_u8, crop_resize_u8_out
from .frame_data import FrameData
from .image_io import read_image_rgb, read_png, resize
from .source import SceneDataset

logger = logging.getLogger(__name__)


@dataclass
class CO3DFrame:
    sequence_name: str
    frame_number: int
    frame_timestamp: float
    image_path: str
    image_size_hw: Tuple[int, int]
    mask_path: Optional[str]
    depth_path: Optional[str]
    depth_scale_adjustment: float
    R: np.ndarray  # (3, 3)
    T: np.ndarray  # (3,)
    focal_length: np.ndarray  # (2,) NDC (isotropic)
    principal_point: np.ndarray  # (2,) NDC (isotropic)
    mask_mass: Optional[float] = None  # fg pixel count from the annotation


def _to_isotropic_ndc(focal: np.ndarray, pp: np.ndarray, size_hw: Tuple[int, int], fmt: str):
    """Convert CO3D viewpoint intrinsics to isotropic (min-side) NDC."""
    H, W = size_hw
    if fmt == "ndc_isotropic":
        return focal, pp
    # ndc_norm_image_bounds: each axis normalized by its own half-extent
    s = min(H, W)
    scale = np.array([W / s, H / s], np.float64)
    return focal * scale, pp * scale


def load_frame_annotations(category_root: str) -> List[CO3DFrame]:
    """Parse `{category}/frame_annotations.jgz`."""
    with gzip.open(os.path.join(category_root, "frame_annotations.jgz"), "rt") as f:
        raw = json.load(f)
    frames = []
    for fa in raw:
        vp = fa["viewpoint"]
        size_hw = tuple(fa["image"]["size"])
        focal = np.asarray(vp["focal_length"], np.float64)
        pp = np.asarray(vp["principal_point"], np.float64)
        focal, pp = _to_isotropic_ndc(focal, pp, size_hw, vp.get("intrinsics_format", "ndc_norm_image_bounds"))
        depth = fa.get("depth") or {}
        mask = fa.get("mask") or {}
        frames.append(CO3DFrame(
            sequence_name=fa["sequence_name"],
            frame_number=fa["frame_number"],
            frame_timestamp=fa.get("frame_timestamp", 0.0),
            image_path=fa["image"]["path"],
            image_size_hw=size_hw,
            mask_path=mask.get("path"),
            depth_path=depth.get("path"),
            depth_scale_adjustment=depth.get("scale_adjustment", 1.0),
            R=np.asarray(vp["R"], np.float32),
            T=np.asarray(vp["T"], np.float32),
            focal_length=focal.astype(np.float32),
            principal_point=pp.astype(np.float32),
            mask_mass=mask.get("mass"),
        ))
    return frames


def load_set_lists(category_root: str, subset_name: str) -> Dict[str, List]:
    with open(os.path.join(category_root, "set_lists", f"set_lists_{subset_name}.json")) as f:
        return json.load(f)


def load_eval_batches_file(category_root: str, subset_name: str) -> Optional[List[List]]:
    """CO3Dv2 challenge eval batches: `eval_batches/eval_batches_{subset}.json`
    is a list of batches of [sequence_name, frame_number, image_path]; the
    first entry of each batch is the eval TARGET, the rest are the known
    source frames. None when the file is absent."""
    path = os.path.join(category_root, "eval_batches", f"eval_batches_{subset_name}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# image loading + box crop
# ---------------------------------------------------------------------------


def mask_bbox(mask: np.ndarray, thr: float = 0.4) -> Optional[Tuple[int, int, int, int]]:
    """Tight (x0, y0, x1, y1) box around mask > thr (exclusive upper)."""
    ys, xs = np.where(mask > thr)
    if len(xs) == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


def expand_bbox(box: Tuple[int, int, int, int], context: float, size_hw: Tuple[int, int]) -> Tuple[int, int, int, int]:
    """Grow the box by `context` * its size on each side, clamped to the
    image (box_crop_context)."""
    H, W = size_hw
    x0, y0, x1, y1 = box
    w, h = x1 - x0, y1 - y0
    dx, dy = int(round(w * context)), int(round(h * context))
    return max(0, x0 - dx), max(0, y0 - dy), min(W, x1 + dx), min(H, y1 + dy)


def crop_intrinsics(focal: np.ndarray, pp: np.ndarray, orig_hw: Tuple[int, int], box: Tuple[int, int, int, int]):
    """Rewrite isotropic-NDC intrinsics through a pixel-space crop.

    With half-scale s = min(H, W) / 2 and pixel centre c, the projection in
    pixels is x_px = c_x - s * (f * X/Z + p). A crop changes (c, s) to
    (c', s'); matching x_px gives f' = f * s / s', p' = (p * s + (c' - c)) / s'.
    """
    H, W = orig_hw
    x0, y0, x1, y1 = box
    s = min(H, W) / 2.0
    s2 = min(y1 - y0, x1 - x0) / 2.0
    c = np.array([(W - 1) / 2.0, (H - 1) / 2.0])
    c2 = np.array([(x0 + x1 - 1) / 2.0, (y0 + y1 - 1) / 2.0])
    focal2 = focal * s / s2
    pp2 = pp * (s / s2) + (c2 - c) / s2
    return focal2.astype(np.float32), pp2.astype(np.float32)


def _load_mask(path: str) -> np.ndarray:
    """An 8-bit gray mask PNG as float32 in [0, 1]."""
    m = read_png(path)
    if m.dtype != np.uint8:
        raise ValueError(f"{path}: a mask must be an 8-bit gray PNG")
    return m.astype(np.float32) / 255.0


def _load_depth(path: str, scale: float) -> np.ndarray:
    """A CO3D depth PNG (float16 bits in 16-bit gray) as float32, times
    `scale`; an 8-bit PNG is read as its values."""
    d = read_png(path)
    if d.dtype == np.uint16:
        d = d.view(np.float16).astype(np.float32)
    else:
        d = d.astype(np.float32)
    return d * scale


def _decode_pool_width(n_workers: int) -> int:
    """The cold-decode pool's width: `n_workers` capped by the CPUs this
    process may run on (on one core, threads only contend for the
    interpreter lock)."""
    return max(1, min(int(n_workers), len(os.sched_getaffinity(0))))


def _quant_u8(a: np.ndarray) -> np.ndarray:
    """unit-float -> uint8, the compact cache's quantisation (round half to
    even, as numpy; the native u8 crop/resize gives the same bits)."""
    return np.clip(np.round(np.asarray(a, np.float32) * 255.0), 0, 255).astype(np.uint8)


def load_frame_data(
    frame: CO3DFrame,
    dataset_root: str,
    image_height: int = 800,
    image_width: int = 800,
    box_crop: bool = True,
    box_crop_mask_thr: float = 0.4,
    box_crop_context: float = 0.3,
    load_depths: bool = True,
    compact: bool = False,
):
    """Load one frame: image, mask and depth cropped to the fg box, padded
    to a square and resized; intrinsics rewritten through the crop and pad.
    Returns a dict of numpy arrays.

    A square box goes through the native crop/resize straight from the
    uint8 frame; any other box is cropped, padded and resized by
    `image_io.resize` (the choice depends on the box's shape only).
    `compact` gives the compact cache's dtypes (uint8 image, mask and
    mask_crop, float16 depth), bitwise the quantised float32 path."""
    img_u8 = read_image_rgb(os.path.join(dataset_root, frame.image_path))
    H0, W0 = img_u8.shape[:2]
    mask = (_load_mask(os.path.join(dataset_root, frame.mask_path)) if frame.mask_path
            else np.ones((H0, W0), np.float32))
    depth = None
    if load_depths and frame.depth_path:
        path = os.path.join(dataset_root, frame.depth_path)
        try:
            depth = _load_depth(path, frame.depth_scale_adjustment)
        except (OSError, ValueError, zlib.error) as e:
            logger.warning("depth %s not loaded (%s): the frame gets a zero depth map", path, e)

    focal, pp = frame.focal_length.copy(), frame.principal_point.copy()
    box = None
    if box_crop:
        box = mask_bbox(mask, box_crop_mask_thr)
        if box is not None:
            box = expand_bbox(box, box_crop_context, (H0, W0))
            x0, y0, x1, y1 = box
            mask = mask[y0:y1, x0:x1]
            if depth is not None:
                depth = depth[y0:y1, x0:x1]
            focal, pp = crop_intrinsics(focal, pp, (H0, W0), box)
    if box is None:
        box = (0, 0, W0, H0)

    out_hw = (image_height, image_width)
    h_box, w_box = box[3] - box[1], box[2] - box[0]
    if h_box == w_box:
        img = (crop_resize_u8_out if compact else crop_resize_u8)(img_u8, box, out_hw)
        native = True
    else:
        img = np.asarray(img_u8, np.float32)[box[1]:box[3], box[0]:box[2]] / 255.0
        native = False

    # pad to square before resize so isotropic NDC stays valid
    h, w = mask.shape[:2]
    if h != w:
        size = max(h, w)
        pad_y, pad_x = (size - h) // 2, (size - w) // 2

        def pad(a):
            out = np.zeros((size, size) + a.shape[2:], a.dtype)
            out[pad_y:pad_y + h, pad_x:pad_x + w] = a
            return out

        # intrinsics through the pad: the old centre lands at pad + (wh - 1) / 2
        s_old, s_new = min(h, w) / 2.0, size / 2.0
        c_old_in_new = np.array([pad_x + (w - 1) / 2.0, pad_y + (h - 1) / 2.0])
        c_new = np.array([(size - 1) / 2.0, (size - 1) / 2.0])
        focal = focal * s_old / s_new
        pp = pp * (s_old / s_new) + (c_old_in_new - c_new) / s_new
        if not native:
            img = pad(img)
        mask = pad(mask)
        if depth is not None:
            depth = pad(depth)

    if not native:
        img = resize(img, out_hw)
    mask = resize(mask, out_hw)
    depth = resize(depth, out_hw, nearest=True) if depth is not None else np.zeros(out_hw, np.float32)

    if compact:
        return dict(
            image_rgb=img if native else _quant_u8(img),
            fg_probability=_quant_u8(mask)[..., None],
            mask_crop=np.full((*out_hw, 1), 255, np.uint8),
            depth_map=depth.astype(np.float16)[..., None],
            R=frame.R, T=frame.T, focal_length=focal, principal_point=pp,
        )
    return dict(
        image_rgb=img,
        fg_probability=mask[..., None],
        mask_crop=np.ones_like(mask)[..., None],
        depth_map=depth[..., None],
        R=frame.R, T=frame.T, focal_length=focal, principal_point=pp,
    )


class CO3DSceneDataset(SceneDataset):
    """Per-sequence dataset: a scene is decoded on first access and cached.

    The cache holds CPU tensors with an LRU bound (`max_cached_scenes`, 0 or
    less for none): at the release scale a cached 800^2 sequence is hundreds
    of MB, so neither the card nor the host could hold a whole category.
    A batch becomes a device tensor only when the training loop copies it
    (pinned, `non_blocking`), as the reference's worker processes hand CPU
    tensors to `net_input.to(device)`.

    With `compact_cache` (default) frames are cached in their storage dtypes
    (uint8 image and masks, float16 depth) and converted to float32 on the
    card by `models/metrics.py:as_unit_float`: a quarter of the host memory
    and of the bytes copied. A cold scene is decoded on a pool of
    `_decode_pool_width(num_workers)` threads (PIL, zlib, the native
    crop/resize and torch's resize release the interpreter lock)."""

    def __init__(
        self,
        frames_by_seq: Dict[str, List[CO3DFrame]],
        dataset_root: str,
        load_kwargs: dict,
        max_frames_per_seq: int = -1,
        max_cached_scenes: int = 16,
        compact_cache: bool = True,
        num_workers: int = 5,
    ):
        self._frames_by_seq = frames_by_seq
        self._seq_names = sorted(frames_by_seq)
        self._root = dataset_root
        self._load_kwargs = load_kwargs
        self._max_frames = max_frames_per_seq
        self._max_cached = max_cached_scenes
        self._compact = compact_cache
        self._num_workers = max(1, int(num_workers))
        self._cache: "OrderedDict[str, FrameData]" = OrderedDict()

    def __len__(self):
        return len(self._seq_names)

    @property
    def scenes(self):
        return [self.get_scene(i) for i in range(len(self))]

    def _frames(self, name: str) -> List[CO3DFrame]:
        frames = self._frames_by_seq[name]
        return frames[: self._max_frames] if self._max_frames > 0 else frames

    def _load_scene(self, idx: int, frames: List[CO3DFrame]) -> FrameData:
        def load_one(f):
            return load_frame_data(f, self._root, compact=self._compact, **self._load_kwargs)

        width = _decode_pool_width(self._num_workers)
        if width > 1 and len(frames) > 1:
            with ThreadPoolExecutor(width) as ex:
                loaded = list(ex.map(load_one, frames))
        else:
            loaded = [load_one(f) for f in frames]

        def stack(key, dtype=None):
            a = np.stack([d[key] for d in loaded])
            return torch.from_numpy(a if dtype is None else a.astype(dtype, copy=False))

        as_f32 = None if self._compact else np.float32
        return FrameData(
            camera=PerspectiveCameras(
                R=stack("R", np.float32), T=stack("T", np.float32),
                focal_length=stack("focal_length", np.float32),
                principal_point=stack("principal_point", np.float32),
            ),
            image_rgb=stack("image_rgb", as_f32),
            fg_probability=stack("fg_probability", as_f32),
            mask_crop=stack("mask_crop", as_f32),
            depth_map=stack("depth_map", as_f32),
            sequence_id=torch.full((len(loaded),), idx, dtype=torch.int32),
        )

    def get_scene(self, idx: int) -> FrameData:
        name = self._seq_names[idx]
        if name in self._cache:
            self._cache.move_to_end(name)
            return self._cache[name]
        self._cache[name] = self._load_scene(idx, self._frames(name))
        if self._max_cached > 0 and len(self._cache) > self._max_cached:
            self._cache.popitem(last=False)  # evict the least recently used
        return self._cache[name]

    def sample_batch(self, rng: np.random.RandomState, batch_size: int) -> FrameData:
        """`batch_size` frames of one random scene (with replacement when
        it has fewer), as CPU tensors, by JAX's exact `rng` calls."""
        scene = self.get_scene(rng.randint(len(self)))
        n = scene.batch_size
        idx = rng.choice(n, size=batch_size, replace=n < batch_size)
        return scene[torch.as_tensor(idx)]

    def get_frames(self, seq_name: str, frame_numbers: List[int]) -> FrameData:
        """Rows of `seq_name`'s scene selected by CO3D frame number, in the
        requested order (eval-batch assembly)."""
        idx_of = {f.frame_number: i for i, f in enumerate(self._frames_by_seq[seq_name])}
        if self._max_frames > 0:
            idx_of = {k: v for k, v in idx_of.items() if v < self._max_frames}
        missing = [fn for fn in frame_numbers if fn not in idx_of]
        if missing:
            raise KeyError(
                f"frames {missing} of sequence {seq_name!r} are not in this split/dataset "
                f"(eval batches must be assembled from the union dataset)")
        scene = self.get_scene(self._seq_names.index(seq_name))
        return scene[torch.as_tensor([idx_of[fn] for fn in frame_numbers])]


class CO3DDataProvider:
    """JsonIndexDatasetMapProviderV2 equivalent: category + subset split.

    Selection knobs follow JsonIndexDataset: `remove_empty_masks` drops
    frames whose annotated mask mass is 0, `pick_sequence`/`exclude_sequence`
    filter by sequence name, `limit_sequences_to` keeps the first N (sorted)
    sequences, `sort_frames` orders a sequence's frames by (timestamp, frame
    number) instead of set-list order. With `load_eval_batches` the CO3Dv2
    challenge batches are read (`get_eval_batch`)."""

    def __init__(
        self,
        category: str,
        dataset_root: str,
        subset_name: str = "fewview_dev",
        test_on_train: bool = True,
        image_height: int = 800,
        image_width: int = 800,
        box_crop: bool = True,
        box_crop_mask_thr: float = 0.4,
        box_crop_context: float = 0.3,
        load_depths: bool = True,
        remove_empty_masks: bool = True,
        n_frames_per_sequence: int = -1,
        pick_sequence: Sequence[str] = (),
        exclude_sequence: Sequence[str] = (),
        limit_sequences_to: int = 0,
        sort_frames: bool = False,
        load_eval_batches: bool = False,
        n_known_frames_for_test: int = 0,
        max_cached_scenes: int = 16,
        compact_cache: bool = True,
        num_workers: int = 5,
        **_,
    ):
        category_root = os.path.join(dataset_root, category)
        frames = load_frame_annotations(category_root)
        if remove_empty_masks:
            frames = [f for f in frames if f.mask_mass is None or f.mask_mass > 0]
        by_key = {(f.sequence_name, f.frame_number): f for f in frames}
        set_lists = load_set_lists(category_root, subset_name)
        pick, exclude = set(pick_sequence), set(exclude_sequence)
        load_kwargs = dict(
            image_height=image_height, image_width=image_width, box_crop=box_crop,
            box_crop_mask_thr=box_crop_mask_thr, box_crop_context=box_crop_context, load_depths=load_depths,
        )

        def build(*splits: str) -> CO3DSceneDataset:
            by_seq: Dict[str, List[CO3DFrame]] = {}
            for split in splits:
                for entry in set_lists.get(split, []):
                    seq, frame_num = entry[0], entry[1]
                    if (pick and seq not in pick) or seq in exclude:
                        continue
                    f = by_key.get((seq, frame_num))
                    if f is not None:
                        by_seq.setdefault(seq, []).append(f)
            if limit_sequences_to > 0:
                by_seq = {k: by_seq[k] for k in sorted(by_seq)[:limit_sequences_to]}
            if sort_frames:
                for seq in by_seq:
                    by_seq[seq].sort(key=lambda f: (f.frame_timestamp, f.frame_number))
            return CO3DSceneDataset(by_seq, dataset_root, load_kwargs, n_frames_per_sequence,
                                    max_cached_scenes=max_cached_scenes, compact_cache=compact_cache,
                                    num_workers=num_workers)

        self.train = build("train")
        self.val = build("train" if test_on_train else "val")

        self.eval_batches: Optional[List[List[Tuple[str, int]]]] = None
        self.n_known_frames_for_test = int(n_known_frames_for_test)
        raw = load_eval_batches_file(category_root, subset_name) if load_eval_batches else None
        if load_eval_batches and raw is None:
            # the shipped configs ask for the protocol; a copy of the data
            # without its json evaluates on the evaluator's own targets
            logger.warning(
                "load_eval_batches: no eval_batches/eval_batches_%s.json under %s; "
                "falling back to the random-targets eval protocol", subset_name, category_root)
        if raw is not None:
            kept = set(self.train._seq_names) | set(self.val._seq_names)
            self.eval_batches = [[(e[0], int(e[1])) for e in b] for b in raw if b and b[0][0] in kept]
            # a batch may take its target from val and its known frames
            # from train: assemble from the union of the splits
            self._eval_source = build("train", "val", "test")
            self._train_frame_numbers: Dict[str, List[int]] = {}
            for entry in set_lists.get("train", []):
                self._train_frame_numbers.setdefault(entry[0], []).append(int(entry[1]))
            logger.info("CO3D %s/%s: %d eval batches (n_known_frames_for_test=%d)",
                        category, subset_name, len(self.eval_batches), self.n_known_frames_for_test)
        logger.info("CO3D %s/%s: %d train sequences", category, subset_name, len(self.train))

    def get_eval_batch(self, i: int) -> FrameData:
        """Eval batch `i` with the TARGET at row 0 and the known source
        frames after it; `n_known_frames_for_test` more train-split frames
        of the same sequence are appended."""
        if self.eval_batches is None:
            raise RuntimeError("the provider was built without load_eval_batches")
        batch = list(self.eval_batches[i])
        seq = batch[0][0]
        if any(s != seq for s, _ in batch):
            raise ValueError(f"eval batch {i} spans multiple sequences")
        nums = [fn for _, fn in batch]
        if self.n_known_frames_for_test > 0:
            have = set(nums)
            extra = [fn for fn in self._train_frame_numbers.get(seq, []) if fn not in have]
            nums = nums + extra[: self.n_known_frames_for_test]
        return self._eval_source.get_frames(seq, nums)
