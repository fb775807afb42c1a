"""View metrics, input preprocessing and the objective (port of
holo_diffusion_tpu/models/metrics.py; Implicitron's ViewMetrics and
preprocess_input, with the `loss_prev_stage^k_*` names of the multi-pass
renderer)."""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch

from ..ops.image import bilinear_sample_ndc


def as_unit_float(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """uint8 -> float32 / 255; any other non-float32 type -> float32."""
    if x is None:
        return None
    if x.dtype == torch.uint8:
        return x.to(torch.float32) / 255.0
    return x.to(torch.float32)


def preprocess_input(
    image_rgb: Optional[torch.Tensor],
    fg_probability: Optional[torch.Tensor],
    depth_map: Optional[torch.Tensor],
    mask_images: bool,
    mask_depths: bool,
    mask_threshold: float = 0.5,
    bg_color=(1.0, 1.0, 1.0),
):
    """Threshold fg into a {0, 1} mask and composite images onto `bg_color`
    and depths onto 0 outside it. image (B, H, W, 3), fg and depth
    (B, H, W, 1). Returns (image, fg mask, depth)."""
    image_rgb = as_unit_float(image_rgb)
    fg_probability = as_unit_float(fg_probability)
    depth_map = as_unit_float(depth_map)
    fg_mask = None
    if fg_probability is not None:
        fg_mask = (fg_probability > mask_threshold).to(torch.float32)
    if mask_images and image_rgb is not None and fg_mask is not None:
        bg = torch.as_tensor(bg_color, dtype=torch.float32, device=image_rgb.device)
        image_rgb = image_rgb * fg_mask + bg * (1.0 - fg_mask)
    if mask_depths and depth_map is not None and fg_mask is not None:
        depth_map = depth_map * fg_mask
    return image_rgb, fg_mask, depth_map


def _sample_at_rays(image: torch.Tensor, xys: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) images at per-ray NDC xys (B, N, 2) -> (B, N, C)."""
    return torch.stack([bilinear_sample_ndc(im, xy) for im, xy in zip(image, xys)])


def calc_psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def _huber(diff_sq: torch.Tensor, scaling: float = 0.03) -> torch.Tensor:
    """Implicitron's huber on a squared error."""
    diff = torch.sqrt(diff_sq + 1e-12)
    return torch.where(diff < scaling, diff_sq * 0.5 / scaling, diff - 0.5 * scaling)


def _wmean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    if w is None:
        return torch.mean(x)
    return torch.sum(x * w) / torch.clamp(torch.sum(w * torch.ones_like(x)), min=1e-6)


def view_metrics(
    features: torch.Tensor,
    depths: torch.Tensor,
    masks: torch.Tensor,
    xys: torch.Tensor,
    image_rgb: Optional[torch.Tensor],
    depth_map: Optional[torch.Tensor],
    fg_probability: Optional[torch.Tensor],
    prefix: str = "loss_",
) -> Dict[str, torch.Tensor]:
    """One pass's rgb mse/psnr(_fg)/huber, mask bce/neg_iou/beta_prior and
    depth_abs(_fg). features/depths/masks (B, N, C/1/1) at rays xys
    (B, N, 2); targets (B, H, W, *)."""
    out: Dict[str, torch.Tensor] = {}
    fg = None if fg_probability is None else _sample_at_rays(fg_probability, xys)
    if image_rgb is not None:
        diff_sq = (features[..., :3] - _sample_at_rays(image_rgb, xys)) ** 2
        mse = torch.mean(diff_sq)
        out[f"{prefix}rgb_mse"] = mse
        out[f"{prefix}rgb_psnr"] = calc_psnr(mse)
        out[f"{prefix}rgb_huber"] = torch.mean(_huber(diff_sq))
        if fg is not None:
            mse_fg = _wmean(diff_sq, fg)
            out[f"{prefix}rgb_mse_fg"] = mse_fg
            out[f"{prefix}rgb_psnr_fg"] = calc_psnr(mse_fg)
    if fg is not None:
        m = torch.clamp(masks, 1e-6, 1.0 - 1e-6)
        out[f"{prefix}mask_bce"] = torch.mean(-(fg * torch.log(m) + (1 - fg) * torch.log(1 - m)))
        inter = torch.sum(torch.minimum(masks, fg))
        union = torch.sum(torch.maximum(masks, fg))
        out[f"{prefix}mask_neg_iou"] = -(inter / torch.clamp(union, min=1e-6))
        out[f"{prefix}mask_beta_prior"] = torch.mean(
            torch.log(0.1 + masks) + torch.log(0.1 + 1.0 - masks) - math.log(0.1)
        )
    if depth_map is not None:
        d_gt = _sample_at_rays(depth_map, xys)
        valid = (d_gt > 0).to(torch.float32)
        abs_err = torch.abs(depths - d_gt)
        out[f"{prefix}depth_abs"] = _wmean(abs_err, valid)
        if fg is not None:
            out[f"{prefix}depth_abs_fg"] = _wmean(abs_err, valid * fg)
    return out


def multipass_view_metrics(rendered, xys, image_rgb, depth_map, fg_probability) -> Dict[str, torch.Tensor]:
    """`view_metrics` of every render pass, the last pass as `loss_*`, the
    one before as `loss_prev_stage_*`, and so on."""
    out: Dict[str, torch.Tensor] = {}
    stage, prefix = rendered, "loss_"
    while stage is not None:
        out.update(view_metrics(stage.features, stage.depths, stage.masks, xys,
                                image_rgb, depth_map, fg_probability, prefix=prefix))
        prefix += "prev_stage_"
        stage = stage.prev_stage
    return out


def get_objective(preds: Mapping[str, torch.Tensor], loss_weights: Mapping[str, float]) -> torch.Tensor:
    """Weighted sum of the losses in `preds` with a non-zero weight (0 when
    there is none)."""
    total = torch.tensor(0.0)
    for k, w in loss_weights.items():
        if w != 0.0 and k in preds:
            total = total.to(preds[k].device) + w * preds[k]
    return total
