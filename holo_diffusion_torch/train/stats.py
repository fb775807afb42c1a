"""Training statistics (a copy of holo_diffusion_tpu/train/stats.py; the
reference's Implicitron `Stats`, training_loop.py:317-392): per-epoch
averages of host floats by stat set ("train", "val"), a `sec/it` clock per
set, status lines, a history of each finished epoch's averages, and JSON
persistence that starts afresh from a corrupt file (the caller re-derives
the epoch from the checkpoint).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional


class Stats:
    def __init__(self, log_vars: Optional[List[str]] = None):
        self.log_vars = log_vars
        self.epoch = -1
        self.history: List[Dict] = []  # one dict per completed epoch
        self._sums: Dict[str, Dict[str, float]] = {}
        self._counts: Dict[str, Dict[str, int]] = {}
        self._it: Dict[str, int] = {}
        self._set_start: Dict[str, float] = {}
        self._first_window: Dict[str, float] = {}
        self._last_event = time.time()

    # -- epoch lifecycle -------------------------------------------------
    def new_epoch(self):
        self.epoch += 1
        self._sums = {}
        self._counts = {}
        self._it = {}
        self._set_start = {}
        self._first_window = {}
        self._last_event = time.time()

    def update(self, preds: Dict[str, float], stat_set: str = "train"):
        """Accumulate scalar entries of `preds` (non-scalars are ignored;
        unknown keys are ignored if log_vars is set — Implicitron behavior)."""
        sums = self._sums.setdefault(stat_set, {})
        counts = self._counts.setdefault(stat_set, {})
        # per-stat-set clock: a val epoch that follows a long train epoch must
        # not inherit the train epoch's elapsed time in its sec/it
        now = time.time()
        if stat_set not in self._set_start:
            self._set_start[stat_set] = now
            # fallback window for single-update sets (e.g. n_batches_val=1):
            # the set's only iteration began at the previous update event of
            # any set (or epoch start), not at its own completion time
            self._first_window[stat_set] = now - self._last_event
        self._last_event = now
        self._it[stat_set] = self._it.get(stat_set, 0) + 1
        for k, v in preds.items():
            if self.log_vars is not None and k not in self.log_vars:
                continue
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            sums[k] = sums.get(k, 0.0) + fv
            counts[k] = counts.get(k, 0) + 1
        # sec/it average: elapsed since this stat_set's FIRST update this epoch,
        # which spans it-1 iterations (the clock starts after iteration 1);
        # with a single update so far, use the fallback window instead of ~0
        if self._it[stat_set] == 1:
            sums["sec/it"] = self._first_window[stat_set]
            counts["sec/it"] = 1
        else:
            sums["sec/it"] = now - self._set_start[stat_set]
            counts["sec/it"] = self._it[stat_set] - 1

    def averages(self, stat_set: str = "train") -> Dict[str, float]:
        sums = self._sums.get(stat_set, {})
        counts = self._counts.get(stat_set, {})
        return {k: sums[k] / max(counts.get(k, 1), 1) for k in sums}

    def status_line(self, stat_set: str = "train", max_vars: int = 6) -> str:
        avg = self.averages(stat_set)
        main = [
            f"{k}={avg[k]:.4g}"
            for k in sorted(avg)
            if k in ("objective", "loss_rgb_mse", "loss_rgb_psnr", "sec/it")
        ]
        it = self._it.get(stat_set, 0)
        return f"[epoch {self.epoch} | {stat_set} it {it}] " + " ".join(main)

    def finalize_epoch(self):
        entry = {"epoch": self.epoch}
        for stat_set in self._sums:
            entry[stat_set] = self.averages(stat_set)
        self.history.append(entry)

    # -- persistence -----------------------------------------------------
    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {"epoch": self.epoch, "log_vars": self.log_vars,
                 "history": self.history},
                f,
            )

    @classmethod
    def load(cls, path: str) -> "Stats":
        with open(path) as f:
            data = json.load(f)
        st = cls(log_vars=data.get("log_vars"))
        st.epoch = data["epoch"]
        st.history = data.get("history", [])
        return st

    @classmethod
    def load_or_new(cls, path: str, log_vars=None) -> "Stats":
        """Resume stats; recover from a corrupt/missing file by starting fresh
        (the reference re-derives the epoch from the checkpoint filename,
        training_loop.py:368-377 — our caller does the same)."""
        if os.path.exists(path):
            try:
                return cls.load(path)
            except (OSError, ValueError, KeyError, TypeError):
                pass
        return cls(log_vars=log_vars)
