"""Checkpoint save, find, purge and resume (port of
holo_diffusion_tpu/train/checkpoint.py, with `torch.save` in place of
orbax).

Layout: `exp_dir/model_epoch_%08d/checkpoint.pt`, one `torch.save` file of
{"model": the model's state_dict (BN statistics included), "optimizer": the
torch optimizer's state_dict, "optimizer_steps": `Optimizer.steps` (the LR
schedule's position), "step": `TrainState.step`, "epoch"}, plus "ema" (the
EMA of the parameters, by name) and "sampler_state" ({"loss_history",
"loss_counts"}) when the state holds them; the stats go to
`exp_dir/train_stats.json`.
"""
from __future__ import annotations

import logging
import os
import re
import shutil
import time
from typing import List, Optional, Tuple

import torch

from ..device import module_device

logger = logging.getLogger(__name__)

_CKPT_RE = re.compile(r"^model_epoch_(\d{8})$")
CHECKPOINT_FILE = "checkpoint.pt"


def checkpoint_dir(exp_dir: str, epoch: int) -> str:
    return os.path.join(exp_dir, f"model_epoch_{epoch:08d}")


def list_checkpoints(exp_dir: str) -> List[Tuple[int, str]]:
    """(epoch, directory) of every checkpoint in `exp_dir`, oldest first."""
    if not os.path.isdir(exp_dir):
        return []
    out = []
    for name in os.listdir(exp_dir):
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(exp_dir, name)))
    return sorted(out)


def find_last_checkpoint(exp_dir: str) -> Optional[Tuple[int, str]]:
    cps = list_checkpoints(exp_dir)
    return cps[-1] if cps else None


def save_checkpoint(exp_dir: str, epoch: int, state, stats=None, purge: int = 1) -> None:
    """Save the TrainState (and `stats`) as epoch `epoch`, then delete all
    but the last `purge` checkpoints (none when `purge` <= 0). An IO error
    is logged as a warning and training goes on (reference
    training_loop.py:643-657). The file is written under a temporary name
    and renamed, so a checkpoint directory never holds a partial file."""
    try:
        t0 = time.perf_counter()
        path = checkpoint_dir(exp_dir, epoch)
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, CHECKPOINT_FILE)
        ckpt = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.optimizer.state_dict(),
            "optimizer_steps": state.optimizer.steps,
            "step": state.step,
            "epoch": epoch,
        }
        if state.ema is not None:
            ckpt["ema"] = state.ema
        if state.sampler_state is not None:
            ckpt["sampler_state"] = dict(vars(state.sampler_state))
        with open(target + ".tmp", "wb") as f:
            torch.save(ckpt, f)
        os.replace(target + ".tmp", target)
        logger.info("saved %s: %d bytes in %.3f s", target, os.path.getsize(target), time.perf_counter() - t0)
        if stats is not None:
            stats.save(os.path.join(exp_dir, "train_stats.json"))
        if purge and purge > 0:
            for _, p in list_checkpoints(exp_dir)[:-purge]:
                shutil.rmtree(p, ignore_errors=True)
    except (OSError, RuntimeError) as e:  # keep training alive on IO errors
        logger.warning("checkpoint save failed: %s", str(e))  # not `e`: its traceback holds the state


def restore_checkpoint(exp_dir: str, state_like, epoch: int = -1):
    """Load epoch `epoch` (the last when negative) into `state_like` in
    place, on the device of its model. Returns (state, epoch), or (None, -1)
    when there is no such checkpoint. A state that holds an EMA or a
    sampler state takes them from the file and raises, naming the file,
    when it has none; a file's EMA or sampler state that the state does
    not hold is left unread."""
    if epoch >= 0:
        path = checkpoint_dir(exp_dir, epoch)
        if not os.path.isdir(path):
            return None, -1
        found = (epoch, path)
    else:
        found = find_last_checkpoint(exp_dir)
        if found is None:
            return None, -1
    ep, path = found
    t0 = time.perf_counter()
    target = os.path.join(path, CHECKPOINT_FILE)
    ckpt = torch.load(target, map_location=module_device(state_like.model), weights_only=True)
    for key, held in (("ema", state_like.ema), ("sampler_state", state_like.sampler_state)):
        if held is not None and key not in ckpt:
            raise ValueError(f"{target} holds no {key!r}, which this run's state expects")
    state_like.model.load_state_dict(ckpt["model"])
    if state_like.ema is not None:
        if set(ckpt["ema"]) != set(state_like.ema):
            raise ValueError(f"{target}: the EMA's parameter names differ from the model's")
        state_like.ema = ckpt["ema"]
    if state_like.sampler_state is not None:
        state_like.sampler_state = type(state_like.sampler_state)(**ckpt["sampler_state"])
    # torch keeps a non-capturable optimizer's step counts on the host
    for s in ckpt["optimizer"]["state"].values():
        if "step" in s:
            s["step"] = s["step"].cpu()
    state_like.optimizer.load_state_dict(ckpt["optimizer"], ckpt["optimizer_steps"])
    state_like.step = ckpt["step"]
    logger.info("restored %s in %.3f s", target, time.perf_counter() - t0)
    return state_like, ep
