"""Evaluation modes (counterpart of ``graphgps_tpu/train/loop.py``:
``eval_epoch`` :812, ``inference_only`` :1060, ``ogblsc_inference`` :1075;
the L1 loss of ``graphgps_tpu/models/losses.py``)."""
from __future__ import annotations

import logging
import os
import time
from typing import Dict

import numpy as np
import torch

from ..logging_utils import SplitLogger

log = logging.getLogger("graphgps_torch")


def l1_loss(pred, true, mask):
    """Mean |pred − true| over the real graphs (NaN targets count as 0)."""
    vals = (pred - torch.nan_to_num(true)).abs()
    m = mask.to(vals.dtype).reshape(mask.shape + (1,) * (vals.ndim - mask.ndim))
    return (vals * m).sum() / torch.clamp((torch.ones_like(vals) * m).sum(),
                                          min=1.0)


def compute_loss(cfg, pred, true, mask):
    if cfg.model.loss_fun != "l1":
        raise NotImplementedError(
            f"model.loss_fun={cfg.model.loss_fun!r} is not ported (ROADMAP "
            "Queue 1 item 17)")
    loss = l1_loss(pred, true, mask)
    if cfg.model.size_average == "sum":
        d = 1 if true.ndim == 1 else int(true.shape[-1])
        loss = loss * mask.sum() * d
    return loss


@torch.no_grad()
def eval_step(cfg, model, batch):
    pred, true = model(batch)
    pred = pred.float()
    mask = batch.graph_mask
    return compute_loss(cfg, pred, true, mask), pred, true, mask


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eval_epoch(cfg, model, loader, logger: SplitLogger) -> None:
    """Evaluate one split; results stay on the device until the epoch ends,
    then come to the host in one go."""
    results = []
    t_epoch = time.perf_counter()
    for real, batch in loader:
        results.append((*eval_step(cfg, model, batch), real))
    _sync(loader.device)
    per_batch = (time.perf_counter() - t_epoch) / max(len(results), 1)
    for loss, pred, true, mask, real in results:
        m = mask.cpu().numpy()
        logger.update_stats(pred.cpu().numpy()[m], true.cpu().numpy()[m],
                            float(loss), 0.0, per_batch, real)


def inference_only(cfg, loaders, model, run_dir: str) -> Dict:
    """Evaluate every split; one stats line each."""
    history = {}
    for split, loader in loaders.items():
        lg = SplitLogger(split, run_dir, cfg.dataset.task_type)
        eval_epoch(cfg, model, loader, lg)
        history[split] = [lg.write_epoch(0)]
    return history


def ogblsc_inference(cfg, loaders, model, run_dir: str) -> Dict:
    """OGB-LSC submission writer: MAE on labelled splits; a
    ``y_pred_pcqm4m-v2_<split>.npz`` for splits whose targets are all NaN."""
    history = {}
    for split, loader in loaders.items():
        preds, trues = [], []
        for _real, batch in loader:
            _, pred, true, mask = eval_step(cfg, model, batch)
            m = mask.cpu().numpy()
            preds.append(pred.cpu().numpy()[m])
            trues.append(true.cpu().numpy()[m])
        pred = np.concatenate(preds).reshape(-1)
        true = np.concatenate(trues).reshape(-1)
        if np.isnan(true).all():
            out = os.path.join(run_dir, f"y_pred_pcqm4m-v2_{split}.npz")
            np.savez_compressed(out, y_pred=pred.astype(np.float32))
            log.info("%s: wrote submission %s (%d preds)", split, out, len(pred))
            history[split] = [dict(n=len(pred), submission=out)]
        else:
            m = ~np.isnan(true)
            mae = float(np.abs(pred[m] - true[m]).mean()) if m.any() else 0.0
            log.info("%s: MAE %.5f over %d", split, mae, int(m.sum()))
            history[split] = [dict(mae=mae, n=int(m.sum()))]
    return history


TRAIN_MODES = {"inference-only": inference_only,
               "PCQM4Mv2-inference": ogblsc_inference}
