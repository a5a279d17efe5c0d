"""Per-split epoch logger writing ``<run_dir>/<split>/stats.json`` (the
port's subset of ``graphgps_tpu/logging_utils.py`` ``SplitLogger``)."""
from __future__ import annotations

import json
import logging
import os
from typing import Dict, List

import numpy as np

from .metrics import compute_task_metrics

log = logging.getLogger("graphgps_torch")


class SplitLogger:
    """Accumulates (pred, true, loss) per batch; emits one stats line per
    epoch."""

    def __init__(self, split: str, out_dir: str, task_type: str,
                 precision: int = 5):
        self.split = split
        self.out_dir = out_dir
        self.task_type = task_type
        self.precision = precision
        self.params = 0
        os.makedirs(os.path.join(out_dir, split), exist_ok=True)
        self.reset()

    def reset(self):
        self._preds: List[np.ndarray] = []
        self._trues: List[np.ndarray] = []
        self._loss = 0.0
        self._lr = 0.0
        self._size = 0
        self._iters = 0
        self._time = 0.0

    def update_stats(self, pred: np.ndarray, true: np.ndarray, loss: float,
                     lr: float, time_used: float, batch_size: int):
        self._preds.append(np.asarray(pred))
        self._trues.append(np.asarray(true))
        self._loss += float(loss) * batch_size
        self._lr = float(lr)
        self._size += batch_size
        self._iters += 1
        self._time += time_used

    def write_epoch(self, cur_epoch: int) -> Dict[str, float]:
        p = self.precision
        stats: Dict[str, float] = dict(
            epoch=cur_epoch,
            loss=round(self._loss / max(self._size, 1), p + 3),
            lr=self._lr, params=int(self.params),
            time_iter=round(self._time / max(self._iters, 1), p + 3),
            time_epoch=round(self._time, p + 3),
        )
        if self._preds:
            task = compute_task_metrics(self.task_type,
                                        np.concatenate(self._preds),
                                        np.concatenate(self._trues))
            stats.update({k: round(v, p) for k, v in task.items()})
        with open(os.path.join(self.out_dir, self.split, "stats.json"), "a") as f:
            f.write(json.dumps(stats) + "\n")
        log.info("%s: %s", self.split,
                 {k: v for k, v in stats.items() if k != "params"})
        self.reset()
        return stats
