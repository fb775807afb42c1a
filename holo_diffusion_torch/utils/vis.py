"""The training loop's visual outputs (port of
holo_diffusion_tpu/utils/vis.py), files in place of the reference's visdom
dashboards (holo_diffusion_model.py:542-616, training_loop.py:501-516).

PNG grids of a preds dict under `exp_dir/visuals/` (`visualize_preds`), the
metric curves as `train_stats.pdf` (`plot_stats_pdf`, matplotlib with the
Agg backend), a self-contained `dashboard.html` (`write_dashboard_html`) and
the DDPM denoising of one grid as a video (`denoising_video`). Feature grids
are projected to RGB by a fixed random projection (`feats_to_rgb`). PNGs go
through `utils/video.py:write_png`.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..render_eval import render_image_chunked
from ..sampling import sample_random_voxel_features_progressive
from .video import VideoWriter, write_png


def feats_to_rgb(f: torch.Tensor, seed: int = 42, proj: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., C) features -> (..., 3) in [0, 1]: a fixed projection (C, 3),
    then unit length (holo_diffusion_model.py:619-634). Without `proj` the
    projection is drawn from a torch generator seeded `seed` (the JAX
    package draws its own from `PRNGKey(seed)`)."""
    f = torch.as_tensor(f)
    if proj is None:
        proj = torch.randn((f.shape[-1], 3), generator=torch.Generator().manual_seed(seed))
    p = f @ torch.as_tensor(proj, dtype=f.dtype, device=f.device)
    norm = torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True), min=1e-8)
    return 0.5 + 0.5 * p / norm


def image_grid(images: np.ndarray, pad: int = 2, max_cols: int = 8) -> np.ndarray:
    """(N, H, W, C) -> one tiled (rows*(H+pad)-pad, cols*(W+pad)-pad, C)
    image on a background of ones."""
    images = np.asarray(images)
    N, H, W, C = images.shape
    cols = min(N, max_cols)
    rows = (N + cols - 1) // cols
    canvas = np.ones((rows * (H + pad) - pad, cols * (W + pad) - pad, C), images.dtype)
    for i in range(N):
        r, c = divmod(i, cols)
        canvas[r * (H + pad):r * (H + pad) + H, c * (W + pad):c * (W + pad) + W] = images[i]
    return canvas


def save_image(path: str, img: np.ndarray) -> None:
    """An (H, W, 3) image (uint8, or float in [0, 1]) as an RGB PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, img)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def visualize_preds(preds: Dict, out_dir: str, prefix: str = "train", step: int = 0) -> List[str]:
    """Dump the renderable entries of a preds dict as PNG grids
    (`<prefix>_<step>_<key>.png`; one-channel maps scaled by their maximum),
    and a `diffusion_x_t` grid's middle depth slice projected to RGB
    (`..._x_t.png`) where the preds carry one. Returns the paths."""
    written = []
    for key in ("images_render", "masks_render", "depths_render"):
        if key not in preds:
            continue
        v = _host(preds[key])
        if v.ndim != 4:
            continue
        if v.shape[-1] == 1:
            v = np.repeat(v / (v.max() + 1e-6), 3, axis=-1)
        path = os.path.join(out_dir, f"{prefix}_{step:08d}_{key}.png")
        save_image(path, image_grid(v))
        written.append(path)
    if "diffusion_x_t" in preds:
        x_t = torch.as_tensor(preds["diffusion_x_t"])[0].detach().cpu()  # (r, r, r, C)
        path = os.path.join(out_dir, f"{prefix}_{step:08d}_x_t.png")
        save_image(path, feats_to_rgb(x_t[x_t.shape[0] // 2]).numpy())
        written.append(path)
    return written


def plot_stats_pdf(stats, path: str) -> Optional[str]:
    """Each train metric's curve over the epochs, val dashed beside it, into
    a PDF (the reference's train_stats.pdf, training_loop.py:339-350).
    Raises ImportError without matplotlib."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    history = stats.history
    if not history:
        return None
    keys = sorted({k for h in history for k in h.get("train", {})} - {"sec/it"})
    if not keys:
        return None
    cols = 3
    rows = (len(keys) + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows), squeeze=False)
    epochs = [h["epoch"] for h in history]
    for i, k in enumerate(keys):
        ax = axes[i // cols][i % cols]
        for stat_set, style in (("train", "-"), ("val", "--")):
            ys = [h.get(stat_set, {}).get(k) for h in history]
            if any(y is not None for y in ys):
                ax.plot(epochs, [y if y is not None else np.nan for y in ys], style, label=stat_set)
        ax.set_title(k, fontsize=8)
        ax.legend(fontsize=6)
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path)
    plt.close(fig)
    return path


def denoising_video(
    model,
    out_path: str,
    camera,
    generator: Optional[torch.Generator] = None,
    steps_per_frame: int = 50,
    max_iter: Optional[int] = None,
    fps: int = 8,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[Sequence[torch.Tensor]] = None,
    device: DeviceLike = None,
) -> Optional[str]:
    """The DDPM denoising of one sampled grid, rendered from a fixed camera
    (a 1-batch PerspectiveCameras) through the chunked renderer every
    `steps_per_frame` steps, into a video (the reference's denoising-video
    stream, holo_diffusion_model.py:598-616). Draws come from `generator`,
    or `noise` (x_T) and `step_noise`. Returns the video's path (the frame
    directory without ffmpeg)."""
    dev = resolve_device(device)
    vw = VideoWriter(out_path, fps=fps)
    chain = sample_random_voxel_features_progressive(
        model, generator, max_iter=max_iter, noise=noise, step_noise=step_noise, device=dev)
    for i, grid in enumerate(chain):
        if i % max(steps_per_frame, 1) != 0:
            continue
        out = render_image_chunked(model, camera, grid[0], device=dev)
        vw.write_frame(out["images_render"].cpu().numpy())
    return vw.get_video()


_DASHBOARD_HTML = """<!doctype html><html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="30">
<title>holo_diffusion_torch dashboard</title>
<style>body{font-family:monospace;background:#111;color:#ddd;margin:20px}
.chart{display:inline-block;margin:8px;background:#1a1a1a;padding:8px;border-radius:6px}
h3{margin:4px 0;font-size:13px} img{max-width:340px;margin:6px;border-radius:4px}
svg polyline{fill:none;stroke-width:1.5} .train{stroke:#6cf} .val{stroke:#fc6}
text{fill:#888;font-size:10px}</style></head><body>
<h2>training dashboard</h2><div id="charts"></div><h2>latest visuals</h2>
<div id="imgs"></div><script>
const D = __PAYLOAD__;
function poly(vals, xmax, ymin, ymax, cls){
  const pts = vals.map(([x,y],i)=>{
    const px = 20 + 280*(x/Math.max(xmax,1));
    const py = 105 - 95*((y-ymin)/Math.max(ymax-ymin,1e-12));
    return px+","+py;}).join(" ");
  return `<polyline class="${cls}" points="${pts}"/>`;}
const charts = document.getElementById("charts");
for (const k of D.keys){
  let tr=[], va=[];
  for (const h of D.history){
    if (h.train && k in h.train) tr.push([h.epoch, h.train[k]]);
    if (h.val && k in h.val) va.push([h.epoch, h.val[k]]);}
  if (!tr.length && !va.length) continue;
  const ys = tr.concat(va).map(p=>p[1]);
  const ymin = Math.min(...ys), ymax = Math.max(...ys);
  const xmax = Math.max(...tr.concat(va).map(p=>p[0]));
  const last = (tr.length?tr:va).slice(-1)[0][1];
  charts.insertAdjacentHTML("beforeend",
    `<div class="chart"><h3>${k} = ${last.toPrecision(5)}</h3>
     <svg width="320" height="110">${poly(tr,xmax,ymin,ymax,"train")}
     ${poly(va,xmax,ymin,ymax,"val")}
     <text x="20" y="10">${ymax.toPrecision(3)}</text>
     <text x="20" y="105">${ymin.toPrecision(3)}</text></svg></div>`);}
const imgs = document.getElementById("imgs");
for (const p of D.images)
  imgs.insertAdjacentHTML("beforeend", `<a href="${p}"><img src="${p}"></a>`);
</script></body></html>"""


def write_dashboard_html(stats, exp_dir: str, visuals_dir: str = "visuals") -> str:
    """`exp_dir/dashboard.html`: every metric's curve over the epochs (inline
    SVG drawn by its own script, reloaded every 30 s) and the latest eight
    entries of `exp_dir/<visuals_dir>` that are PNGs (the visdom
    replacement, training_loop.py:501-516). Returns its path."""
    history = stats.history
    keys = sorted({k for h in history for s in ("train", "val") for k in h.get(s, {})} - {"sec/it"})
    vis_path = os.path.join(exp_dir, visuals_dir)
    images = sorted(os.listdir(vis_path))[-8:] if os.path.isdir(vis_path) else []
    payload = json.dumps({
        "keys": keys,
        "history": history,
        "images": [f"{visuals_dir}/{f}" for f in images if f.endswith(".png")],
    })
    path = os.path.join(exp_dir, "dashboard.html")
    with open(path, "w") as f:
        f.write(_DASHBOARD_HTML.replace("__PAYLOAD__", payload))
    return path
