"""Optimizer, gradient clipping and epoch-indexed learning-rate schedules
(counterpart of ``graphgps_tpu/optim/optimizers.py``: ``adam``/``adamW``
:27-38 on optax's defaults, ``linear_with_warmup`` :51-61,
``cosine_with_warmup`` :65-76, ``polynomial_with_warmup`` :79-93,
``none`` :95-98 and ``ReduceLROnPlateau``/``reduce_on_plateau`` :114-166,
``make_tx``'s ``clip_by_global_norm`` :229-286, ``set_lr`` :289-306). As in
the JAX package the schedule is a function of the epoch index, or the
plateau scheduler's host state, and the loop sets the learning rate once per
epoch."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Union

import torch

# optax.adam / optax.adamw defaults
BETAS = (0.9, 0.999)
EPS = 1e-8


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                    capturable: bool = False):
    """``adamW`` (decoupled weight decay ``cfg.optim.weight_decay``) or
    ``adam``, on optax's defaults; the learning rate is set per epoch.
    ``capturable``: the form a CUDA graph can capture (the K-step path on
    the card): its step count on the device, and its learning rate a
    one-element tensor there that :func:`set_lr` fills in place."""
    name = cfg.optim.optimizer
    params = list(params)
    lr, extra = cfg.optim.base_lr, {}
    if capturable:
        lr = torch.tensor(float(lr), device=params[0].device)
        extra = dict(capturable=True)
    if name == "adamW":
        return torch.optim.AdamW(params, lr=lr, betas=BETAS, eps=EPS,
                                 weight_decay=cfg.optim.weight_decay, **extra)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS, **extra)
    raise NotImplementedError(
        f"optim.optimizer={name!r} is not ported (adamW, adam; ROADMAP Queue "
        "1 item 17)")


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler state. The loop calls ``update(metric)``
    once per evaluated epoch with the selection metric and sets ``lr`` as
    the next epoch's learning rate. An improvement must beat the best by more
    than ``eps``; after more than ``patience`` epochs without one the rate
    drops by ``factor``, not below ``min_lr``, and only by more than
    ``eps``."""

    base_lr: float
    factor: float = 0.5
    patience: int = 10
    mode: str = "min"
    min_lr: float = 0.0
    eps: float = 1e-8

    lr: float = dataclasses.field(default=0.0)
    best: float = dataclasses.field(default=math.inf)
    num_bad: int = dataclasses.field(default=0)

    def __post_init__(self):
        self.lr = self.base_lr
        self.best = math.inf if self.mode == "min" else -math.inf

    def update(self, metric: float) -> float:
        better = (metric < self.best - self.eps if self.mode == "min"
                  else metric > self.best + self.eps)
        if better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return dict(lr=self.lr, best=self.best, num_bad=self.num_bad)

    def load_state_dict(self, d: dict) -> None:
        self.lr, self.best, self.num_bad = d["lr"], d["best"], d["num_bad"]


def build_schedule(cfg) -> Union[Callable[[int], float], ReduceLROnPlateau]:
    """The learning rate of an epoch: ``linear_with_warmup``,
    ``cosine_with_warmup`` or ``polynomial_with_warmup`` (the
    HF-transformers formulas: half a cosine cycle; power 1 down to
    ``optim.min_lr``; lr 0 in epoch 0 when there is warm-up) or ``none``
    (constant); or, for ``reduce_on_plateau``, the scheduler's host state,
    whose ``lr`` the loop reads and whose ``update`` it calls."""
    name = cfg.optim.scheduler
    base = cfg.optim.base_lr
    if name == "reduce_on_plateau":
        # min for an argmin metric or a regression task, else max (auc, f1)
        mode = ("min" if cfg.metric_agg == "argmin"
                or cfg.dataset.task_type == "regression" else "max")
        return ReduceLROnPlateau(base_lr=base, factor=cfg.optim.reduce_factor,
                                 patience=cfg.optim.schedule_patience,
                                 mode=mode, min_lr=cfg.optim.min_lr)
    if name == "none":
        return lambda epoch: base
    if name == "linear_with_warmup":
        warm, total = cfg.optim.num_warmup_epochs, cfg.optim.max_epoch

        def f(epoch: int) -> float:
            if epoch < warm:
                return base * epoch / max(1, warm)
            return base * max(0.0, (total - epoch) / max(1, total - warm))

        return f
    if name == "cosine_with_warmup":
        warm, total = cfg.optim.num_warmup_epochs, cfg.optim.max_epoch

        def f(epoch: int) -> float:
            if epoch < warm:
                return base * epoch / max(1, warm)
            progress = (epoch - warm) / max(1, total - warm)
            return base * max(0.0, 0.5 * (1.0 + math.cos(
                math.pi * 0.5 * 2.0 * progress)))

        return f
    if name == "polynomial_with_warmup":
        warm, total = cfg.optim.num_warmup_epochs, cfg.optim.max_epoch
        lr_end = cfg.optim.min_lr

        def f(epoch: int) -> float:
            if epoch < warm:
                return base * epoch / max(1, warm)
            if epoch > total:
                return lr_end
            remaining = 1 - (epoch - warm) / max(1, total - warm)
            return (base - lr_end) * remaining + lr_end

        return f
    raise NotImplementedError(
        f"optim.scheduler={name!r} is not ported (linear_with_warmup, "
        "cosine_with_warmup, polynomial_with_warmup, reduce_on_plateau, "
        "none; ROADMAP Queue 1 item 17)")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """The learning rate of every group. A capturable optimizer's rate is a
    tensor on its parameters' device, written in place (a captured step
    reads it there); one that a checkpoint left elsewhere is put back on
    that device first."""
    for group in opt.param_groups:
        if not group.get("capturable"):
            group["lr"] = lr
            continue
        dev = group["params"][0].device
        cur = group["lr"]
        if not torch.is_tensor(cur) or cur.device != dev:
            group["lr"] = cur = torch.zeros((), device=dev)
        cur.fill_(lr)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """optax's rule in place: with ``n = sqrt(Σ‖g‖²)`` over all gradients,
    every ``g`` becomes ``(g / n) * max_norm`` when ``n ≥ max_norm`` and stays
    otherwise (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). Runs
    on the device with no host synchronisation. Returns ``n``."""
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm
