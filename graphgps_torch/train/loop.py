"""Train and evaluation modes (counterpart of ``graphgps_tpu/train/loop.py``:
``train_step`` :146-153, ``train_epoch`` :732-768, K steps per dispatch
``scan_steps_core``/``make_scan_steps`` :196-307 and ``train_epoch_scan``
:771, ``eval_epoch`` :812, ``custom_train`` :884-1057, ``inference_only``
:1060, ``ogblsc_inference`` :1075, ``_loss_mask`` :81; the L1,
cross-entropy, binary and weighted cross-entropy losses and the dispatch of
``graphgps_tpu/models/losses.py`` :23, :41, :52, :73, :104)."""
from __future__ import annotations

import logging
import os
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from ..logging_utils import SplitLogger
from ..models.gps_layer import StepSeeds, seed_values
from ..ops import kernels
from ..optim import (ReduceLROnPlateau, build_optimizer, build_schedule,
                     clip_by_global_norm, set_lr)
from . import checkpoint

log = logging.getLogger("graphgps_torch")


def _masked_mean(vals, mask):
    m = mask.to(vals.dtype).reshape(mask.shape + (1,) * (vals.ndim - mask.ndim))
    return (vals * m).sum() / torch.clamp((torch.ones_like(vals) * m).sum(),
                                          min=1.0)


def _f32(t):
    """``t`` in at least float32 (a float64 run, the reference of a
    precision check, stays float64)."""
    return t if t.dtype == torch.float64 else t.float()


def l1_loss(pred, true, mask):
    """Mean |pred − true| over the real graphs (NaN targets count as 0)."""
    return _masked_mean((pred - torch.nan_to_num(true)).abs(), mask)


def binary_cross_entropy(pred, true, mask):
    """Binary cross-entropy with logits over the real graphs; pred (B,) or
    (B, 1), true the 0/1 labels (any dtype)."""
    pred = _f32(pred.reshape(pred.shape[0], -1)[:, 0])
    t = torch.nan_to_num(true.float()).reshape(pred.shape)
    vals = (torch.clamp(pred, min=0) - pred * t
            + torch.log1p(torch.exp(-pred.abs())))
    return _masked_mean(vals, mask)


def _class_targets(pred, true):
    """Integer class targets (R,) for logits (R, C), clipped to the classes."""
    if true.ndim == pred.ndim:   # (R, 1) graph-label column → (R,)
        true = true[..., 0]
    return true.long().clamp(0, pred.shape[-1] - 1)


def cross_entropy(pred, true, mask):
    """Multiclass cross-entropy with integer targets over the real rows;
    pred (R, C), true (R,) or (R, 1)."""
    tgt = _class_targets(pred, true)
    logp = torch.log_softmax(_f32(pred), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return _masked_mean(nll, mask)


def weighted_cross_entropy(pred, true, mask):
    """Cross-entropy weighted by the inverse class frequencies of the
    batch's real rows: class c weighs ``total / max(count_c · C, 1)``, and
    the mean is over the rows' weights."""
    C = pred.shape[-1]
    tgt = _class_targets(pred, true)
    m = mask.float()
    counts = torch.zeros(C, dtype=torch.float32,
                         device=pred.device).index_add(0, tgt, m)
    total = torch.clamp(m.sum(), min=1.0)
    w = (total / torch.clamp(counts * C, min=1.0))[tgt]
    logp = torch.log_softmax(_f32(pred), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    return (nll * w * m).sum() / torch.clamp((w * m).sum(), min=1.0)


def compute_loss(cfg, pred, true, mask):
    """The loss of the task (``losses.py:104-138``): ``l1`` for the
    regression recipes; ``cross_entropy`` (or ``auto``) is binary
    cross-entropy on a ``classification_binary`` task and the multiclass
    one on ``classification``; ``weighted_cross_entropy`` as named."""
    name, tt = cfg.model.loss_fun, cfg.dataset.task_type
    if name in ("cross_entropy", "ce", "auto"):
        name = {"classification_binary": "binary_cross_entropy",
                "classification": "cross_entropy"}.get(tt)
    if name == "l1":
        loss = l1_loss(pred, true, mask)
        d = 1 if true.ndim == 1 else int(true.shape[-1])
    elif name == "binary_cross_entropy":
        loss = binary_cross_entropy(pred, true, mask)
        d = 1
    elif name == "cross_entropy":
        loss = cross_entropy(pred, true, mask)
        d = 1
    elif name == "weighted_cross_entropy":
        if cfg.model.size_average == "sum":
            raise ValueError(
                "model.size_average='sum' is not supported for "
                "weighted_cross_entropy: its denominator is class-weighted; "
                "use 'mean'")
        return weighted_cross_entropy(pred, true, mask)
    else:
        raise NotImplementedError(
            f"model.loss_fun={cfg.model.loss_fun!r} on task_type={tt!r} is "
            "not ported (multi-target and multilabel losses: ROADMAP Queue 1 "
            "item 17)")
    if cfg.model.size_average == "sum":
        loss = loss * mask.sum() * d
    return loss


def loss_mask(batch, pred):
    """The padding mask at the predictions' level: the graph mask for one
    row per graph, the node mask for one row per node slot, and on a
    transductive split the node mask AND the split's node mask (JAX
    ``_loss_mask``): the loss and the metrics cover the split's nodes."""
    if pred.shape[0] == batch.num_graphs:
        return batch.graph_mask
    if pred.shape[0] == batch.num_node_slots:
        split = batch.extras.get("split_mask")
        if split is not None:
            return batch.node_mask & split.reshape(-1).bool()
        return batch.node_mask
    raise ValueError(f"predictions of {pred.shape[0]} rows match neither the "
                     f"{batch.num_graphs} graphs nor the "
                     f"{batch.num_node_slots} node slots")


@torch.no_grad()
def eval_step(cfg, model, batch):
    pred, true = model(batch)
    pred = _f32(pred)
    mask = loss_mask(batch, pred)
    return compute_loss(cfg, pred, true, mask), pred, true, mask


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _drain(results, logger: SplitLogger, lr: float, per_batch: float):
    """Per-batch (loss, pred, true, mask, real) results to the host and into
    ``logger``, after the epoch's work."""
    for loss, pred, true, mask, real in results:
        m = mask.cpu().numpy()
        logger.update_stats(pred.cpu().numpy()[m], true.cpu().numpy()[m],
                            float(loss), lr, per_batch, real)


def eval_epoch(cfg, model, loader, logger: SplitLogger) -> None:
    """Evaluate one split in evaluation mode; results stay on the device
    until the epoch ends, then come to the host in one go."""
    was_training = model.training
    model.eval()
    results = []
    t_epoch = time.perf_counter()
    for real, batch in loader:
        results.append((*eval_step(cfg, model, batch), real))
    _sync(loader.device)
    _drain(results, logger, 0.0,
           (time.perf_counter() - t_epoch) / max(len(results), 1))
    model.train(was_training)


def _step(cfg, model, opt, batch, seeds):
    """The body of a training step, its gradients None on entry: forward in
    training mode (dropout seeds from ``seeds``), the task's loss over the
    real graphs or nodes, backward, optax-rule gradient clipping, update.
    Returns (loss, pred, true, mask), detached. A CUDA graph captures it
    as it is (no host synchronisation, nothing drawn on the host)."""
    pred, true = model(batch, seeds)
    pred = _f32(pred)
    mask = loss_mask(batch, pred)
    loss = compute_loss(cfg, pred, true, mask)
    loss.backward()
    # a parameter the loss does not reach (the last layer's edge-tail norm)
    # gets a zero gradient, as in JAX: adamW then decays it and its moments
    # as optax does, where torch would skip it
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if cfg.optim.clip_grad_norm:
        clip_by_global_norm([p.grad for p in model.parameters()],
                            cfg.optim.clip_grad_norm_value)
    opt.step()
    return loss.detach(), pred.detach(), true, mask


# the dropout seeds a model's last eager step took, where it drew nothing
# else from its generator (no LapPE signs): the next step draws that many
# at once and copies them to the device in one copy (``StepSeeds``)
_SEEDS_TAKEN: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def train_step(cfg, model, opt, batch, gen: Optional[torch.Generator]):
    """One optimizer step: :func:`_step` with the step's dropout seeds (and
    LapPE's signs) drawn from ``gen`` as its modules take them, the seeds
    into int32 tensors on the batch's device. Returns (loss, pred, true,
    mask), detached."""
    opt.zero_grad(set_to_none=True)
    if gen is None:
        return _step(cfg, model, opt, batch, None)
    seeds = StepSeeds(gen, batch.device, expect=_SEEDS_TAKEN.get(model, 0))
    out = _step(cfg, model, opt, batch, seeds)
    seeds.settle()
    _SEEDS_TAKEN[model] = 0 if seeds.host_draws else seeds.used
    return out


def train_epoch(cfg, model, opt, loader, logger: SplitLogger, lr: float,
                gen: Optional[torch.Generator]) -> None:
    """One pass over the train split, one step per batch; the epoch's wall
    time is spread evenly over its steps, as the JAX loop reports it."""
    model.train()
    results = []
    t_epoch = time.perf_counter()
    for real, batch in loader:
        results.append((*train_step(cfg, model, opt, batch, gen), real))
    _sync(loader.device)
    _drain(results, logger, lr,
           (time.perf_counter() - t_epoch) / max(len(results), 1))


# graphs' extras a DeviceLoader takes in the JAX driver (``_dev_ok_extras``,
# ``graphgps_tpu/driver.py:114-119``): only there does JAX run K steps per
# dispatch
DEVICE_LOADER_EXTRAS = {"edge_label", "edge_label_index", "edge_label_mask"}
# eager steps a run takes on the card before it captures its training step
WARMUP_STEPS = 2


def k_steps_eligible(cfg, train_graph_extras) -> bool:
    """Whether ``train.steps_per_dispatch`` > 1 runs K steps per dispatch:
    JAX's rule (``graphgps_tpu/train/loop.py:896-904``), which takes them
    with no gradient accumulation and no mesh (the port runs one device) on
    a DeviceLoader train split, and JAX's loader choice, a DeviceLoader when
    ``train.device_loader`` is on, no negative edges are resampled and the
    train graphs' extras are at most the edge-label keys. Where JAX falls
    back to one step per dispatch for want of a DeviceLoader it logs its
    warning; so does this."""
    if cfg.train.steps_per_dispatch <= 1:
        return False
    if max(1, cfg.optim.batch_accumulation) != 1:
        return False
    resample = (cfg.dataset.resample_negative
                and "edge_label_index" in train_graph_extras)
    if (cfg.train.device_loader and not resample
            and set(train_graph_extras) <= DEVICE_LOADER_EXTRAS):
        return True
    log.warning("train.steps_per_dispatch>1 needs a DeviceLoader (dataset "
                "without host-collated extras) — falling back to one step "
                "per dispatch")
    return False


def epoch_groups(loader, K: int):
    """The epoch's ``(n_groups, K, B)`` int64 table of graph indices (JAX
    ``train_epoch_scan``): the loader's shuffle (``seed + epoch``, which
    advances its epoch), its batches in order, the trailing group padded
    with all-(−1) filler batches; and the ``(n_groups, K)`` real graphs per
    batch (0 for a filler)."""
    B = loader.batch_size
    n = loader.arenas.num_graphs_total
    idx = np.arange(n)
    if loader.shuffle:
        np.random.default_rng(loader.seed + loader.epoch).shuffle(idx)
    loader.epoch += 1
    n_batches = -(-n // B)
    n_groups = -(-n_batches // K)
    sel = -np.ones((n_groups * K * B,), np.int64)
    sel[:n] = idx
    sel = sel.reshape(n_groups, K, B)
    return sel, (sel >= 0).sum(axis=2)


class KSteps:
    """K training steps per dispatch (JAX ``make_scan_steps``), each step
    assembling its batch on the device from a row of the group's index
    table. A filler batch (all padding, only in an epoch's last group) is
    not run: parameters, optimizer state, BatchNorm statistics and the step
    count stay as the real steps leave them, as JAX's guard keeps them.

    On the CPU each real step runs eagerly (:func:`train_step` on the
    assembled batch). On the card the run's first ``WARMUP_STEPS`` steps run
    eagerly on a side stream (they build the optimizer's state, the edge
    tail's backward tickets and the step's seed count), then one step is
    captured as a CUDA graph (:meth:`capture`) and every later step is a
    replay: a dispatch copies the group's indices and seeds to the device
    at once, then for each real step copies its row into the static row
    buffer and replays. ``opt`` is then capturable (``build_optimizer``)."""

    def __init__(self, cfg, model, opt, loader, gen: torch.Generator):
        self.cfg, self.model, self.opt, self.loader = cfg, model, opt, loader
        self.gen = gen
        self.K = cfg.train.steps_per_dispatch
        self.on_card = loader.device.type == "cuda"
        self.eager_steps = 0
        self.n_seeds: Optional[int] = None
        self.graph = None
        self.row = self.out = None

    def _eager(self, sel_row):
        """One eager step on the batch of ``sel_row`` (B,) numpy indices."""
        sel = torch.as_tensor(sel_row, dtype=torch.int64,
                              device=self.loader.device)
        batch = self.loader.arenas.assemble(sel, self.loader.max_nodes)
        self.opt.zero_grad(set_to_none=True)
        seeds = StepSeeds(self.gen, batch.device, expect=self.n_seeds or 0)
        out = _step(self.cfg, self.model, self.opt, batch, seeds)
        seeds.settle()
        if self.n_seeds not in (None, seeds.used):
            raise RuntimeError(f"a training step took {seeds.used} dropout "
                               f"seeds, an earlier one {self.n_seeds}")
        self.n_seeds = seeds.used
        self.eager_steps += 1
        return out

    def _warmup(self, sel_row):
        """An eager step on a side stream, as a capture wants its warm-up."""
        side = torch.cuda.Stream(self.loader.device)
        side.wait_stream(torch.cuda.current_stream(self.loader.device))
        with torch.cuda.stream(side):
            out = self._eager(sel_row)
        torch.cuda.current_stream(self.loader.device).wait_stream(side)
        return out

    def _captured_step(self):
        B = self.loader.batch_size
        batch = self.loader.arenas.assemble(self.row[:B],
                                            self.loader.max_nodes)
        seeds = StepSeeds(table=self.row[B:].to(torch.int32))
        # the BatchNorms replace their running statistics (a kernel's
        # backward still holds the old ones as its moment shift): the step
        # ends by writing each replaced buffer's new value into the old
        # tensor and putting that back, so each replay reads the last one's
        buffers = [(m, k, t) for m in self.model.modules()
                   for k, t in m._buffers.items() if t is not None]
        out = _step(self.cfg, self.model, self.opt, batch, seeds)
        with torch.no_grad():
            for m, k, t in buffers:
                if m._buffers[k] is not t:
                    t.copy_(m._buffers[k])
                    m._buffers[k] = t
        if seeds.used != self.n_seeds:
            raise RuntimeError(f"the captured step took {seeds.used} dropout "
                               f"seeds, the eager ones {self.n_seeds}")
        return out

    def capture(self) -> None:
        """Capture one training step: batch assembly from the static row's
        first B entries (graph indices), the step with its seeds from the
        rest, gradients set to None before (not inside) the capture. The
        capture executes nothing and moves no host state."""
        dev = self.loader.device
        self.row = torch.zeros(self.loader.batch_size + self.n_seeds,
                               dtype=torch.int64, device=dev)
        self.opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize(dev)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = self._captured_step()

    def replay(self, row_dev):
        """One captured step on ``row_dev`` (B + n_seeds,) int64 on the
        device; returns its outputs, cloned before the next replay."""
        self.row.copy_(row_dev)
        self.graph.replay()
        kernels.note_replay()
        return tuple(t.clone() for t in self.out)

    def __call__(self, sel, reals):
        """One dispatch: the group's ``sel`` (K, B) numpy indices and
        ``reals`` (K,) real graphs per batch → (loss, pred, true, mask,
        real) rows of its real steps."""
        rows = [k for k in range(self.K) if reals[k] > 0]
        if not self.on_card:
            return [(*self._eager(sel[k]), int(reals[k])) for k in rows]
        results = []
        while rows and self.graph is None and \
                self.eager_steps < WARMUP_STEPS:
            k = rows.pop(0)
            results.append((*self._warmup(sel[k]), int(reals[k])))
        if not rows:
            return results
        if self.graph is None:
            self.capture()
        # the group's indices and its real steps' seeds, drawn at once in
        # step order, in one copy to the device
        table = torch.zeros((len(rows), sel.shape[1] + self.n_seeds),
                            dtype=torch.int64)
        table[:, :sel.shape[1]] = torch.as_tensor(sel[rows])
        table[:, sel.shape[1]:] = _draw_table(self.gen, len(rows),
                                              self.n_seeds)
        table = table.to(self.loader.device, non_blocking=True)
        for i, k in enumerate(rows):
            results.append((*self.replay(table[i]), int(reals[k])))
        return results


def _draw_table(gen, steps: int, n: int) -> torch.Tensor:
    """(steps, n) dropout seeds as ``steps`` eager steps draw them from
    ``gen``, n a step (``StepSeeds``)."""
    return seed_values(gen, steps * n).reshape(steps, n)


def train_epoch_k(cfg, model, k_steps: KSteps, loader, logger: SplitLogger,
                  lr: float) -> None:
    """One pass over the train split K steps per dispatch (JAX
    ``train_epoch_scan``): the epoch's group table, one dispatch per group,
    the filler batches' rows dropped, the epoch's wall time spread evenly
    over its real steps."""
    model.train()
    sel, reals = epoch_groups(loader, k_steps.K)
    results = []
    replays = kernels.graph_replays()
    t_epoch = time.perf_counter()
    for gi in range(sel.shape[0]):
        results.extend(k_steps(sel[gi], reals[gi]))
    _sync(loader.device)
    _drain(results, logger, lr,
           (time.perf_counter() - t_epoch) / max(len(results), 1))
    log.info("train: %d steps in %d dispatches of K=%d, %d of them graph "
             "replays", len(results), sel.shape[0], k_steps.K,
             kernels.graph_replays() - replays)


def check_train_supported(cfg) -> None:
    """The training options this slice runs; others name their ROADMAP
    item."""
    if max(1, cfg.optim.batch_accumulation) > 1:
        raise NotImplementedError(
            "optim.batch_accumulation > 1 is not ported (ROADMAP Queue 1 "
            "item 17)")
    if cfg.train.profiler or cfg.train.finetune or cfg.wandb.use:
        raise NotImplementedError(
            "train.profiler, train.finetune and wandb are not ported "
            "(ROADMAP Queue 1 item 17)")


def _metric_cmp(agg: str):
    return (lambda a, b: a < b) if agg == "argmin" else (lambda a, b: a > b)


def resolve_metric_best(cfg) -> str:
    """'auto' → the task's default (``graphgps_tpu/config/config.py:452``
    ``resolve_metric_best``)."""
    if cfg.metric_best != "auto":
        return "auc" if cfg.metric_best == "auroc" else cfg.metric_best
    tt = cfg.dataset.task_type
    if "classification_multilabel" in tt:
        return "ap"
    return "accuracy" if "classification" in tt else "mae"


def is_eval_epoch(cfg, epoch: int) -> bool:
    return ((epoch + 1) % max(1, cfg.train.eval_period) == 0
            or epoch == cfg.optim.max_epoch - 1 or epoch == 0)


def is_ckpt_epoch(cfg, epoch: int) -> bool:
    return ((epoch + 1) % max(1, cfg.train.ckpt_period) == 0
            or epoch == cfg.optim.max_epoch - 1)


def custom_train(cfg, loaders, model, run_dir: str,
                 gen: Optional[torch.Generator] = None) -> Dict:
    """The epoch loop: the learning rate set per epoch from the schedule (or
    the plateau scheduler's ``lr``, updated after each evaluated epoch with
    the selection metric), one train epoch, evaluation of val and test every
    ``eval_period``, the best epoch by ``metric_best`` (falling back to the
    loss, argmin, when the metric is missing), and checkpoints of the best
    epoch or every ``ckpt_period``, which carry the plateau scheduler's
    state. ``gen`` draws the dropout seeds. With ``train.steps_per_dispatch``
    K > 1 where JAX takes K steps (:func:`k_steps_eligible`) each train
    epoch runs K steps per dispatch (:func:`train_epoch_k`); on the card
    through replays of one captured step, with a capturable optimizer. A
    resumed run takes up the train split's shuffle at its next epoch."""
    check_train_supported(cfg)
    if cfg.train.preempt_save:
        log.warning("train.preempt_save: preemption handling is not ported "
                    "(ROADMAP Queue 1 item 17); a stopped run resumes from "
                    "its last checkpoint with train.auto_resume")
    train_loader = loaders["train"]
    k_path = k_steps_eligible(cfg, set(train_loader.arenas.extras))
    opt = build_optimizer(cfg, model.parameters(),
                          capturable=k_path
                          and train_loader.device.type == "cuda")
    schedule = build_schedule(cfg)
    plateau = schedule if isinstance(schedule, ReduceLROnPlateau) else None
    metric = resolve_metric_best(cfg)
    agg = cfg.metric_agg
    if cfg.metric_best == "auto" and metric in ("mae", "mse", "rmse", "loss"):
        agg = "argmin"
    better = _metric_cmp(agg)
    loggers = {s: SplitLogger(s, run_dir, cfg.dataset.task_type)
               for s in loaders}
    for lg in loggers.values():
        lg.params = cfg.share.get("params", 0)
    start_epoch = 0
    if cfg.train.auto_resume:
        start_epoch = checkpoint.load_ckpt(run_dir, model, opt,
                                           cfg.train.epoch_resume, gen,
                                           plateau)
        # the shuffle of the epoch resumed at, so that a resumed run takes
        # an uninterrupted one's batches; the JAX loop restarts its shuffle
        # at epoch 0 here (it leaves the loader's counter alone)
        train_loader.epoch = start_epoch
    k_steps = KSteps(cfg, model, opt, train_loader, gen) if k_path else None
    ckpt = cfg.train.enable_ckpt
    history: Dict[str, List[Dict]] = {s: [] for s in loaders}
    best_val, best_epoch = None, -1
    for epoch in range(start_epoch, cfg.optim.max_epoch):
        lr = plateau.lr if plateau is not None else schedule(epoch)
        set_lr(opt, lr)
        t0 = time.perf_counter()
        if k_steps is not None:
            train_epoch_k(cfg, model, k_steps, train_loader, loggers["train"],
                          lr)
        else:
            train_epoch(cfg, model, opt, train_loader, loggers["train"], lr,
                        gen)
        epoch_s = time.perf_counter() - t0
        history["train"].append(loggers["train"].write_epoch(epoch))
        if is_eval_epoch(cfg, epoch):
            for split in ("val", "test"):
                if split in loaders:
                    eval_epoch(cfg, model, loaders[split], loggers[split])
                    history[split].append(loggers[split].write_epoch(epoch))
            val_hist = history.get("val") or history["train"]
            if metric not in val_hist[-1] and best_epoch < 0:
                log.warning("selection metric %r missing from the stats "
                            "(keys: %s): selecting on loss (argmin)", metric,
                            sorted(val_hist[-1]))
                metric, agg = "loss", "argmin"
                better = _metric_cmp(agg)
            cur = val_hist[-1].get(metric, val_hist[-1]["loss"])
            if plateau is not None:
                plateau.update(cur)
            if best_val is None or better(cur, best_val):
                best_val, best_epoch = cur, epoch
                if ckpt and cfg.train.ckpt_best:
                    checkpoint.save_ckpt(run_dir, model, opt, epoch, gen,
                                         plateau)
                    if cfg.train.ckpt_clean:
                        checkpoint.clean_ckpt(run_dir, epoch)
            log.info("epoch %d lr %.2e %s=%.5f (best %.5f @ %d) epoch_time "
                     "%.2fs", epoch, lr, metric, cur, best_val, best_epoch,
                     epoch_s)
        if ckpt and not cfg.train.ckpt_best and is_ckpt_epoch(cfg, epoch):
            checkpoint.save_ckpt(run_dir, model, opt, epoch, gen, plateau)
    log.info("best %s=%s @ epoch %d", metric, best_val, best_epoch)
    return history


def inference_only(cfg, loaders, model, run_dir: str, gen=None) -> Dict:
    """Evaluate every split; one stats line each (``gen`` unused)."""
    history = {}
    for split, loader in loaders.items():
        lg = SplitLogger(split, run_dir, cfg.dataset.task_type)
        eval_epoch(cfg, model, loader, lg)
        history[split] = [lg.write_epoch(0)]
    return history


def ogblsc_inference(cfg, loaders, model, run_dir: str, gen=None) -> Dict:
    """OGB-LSC submission writer: MAE on labelled splits; a
    ``y_pred_pcqm4m-v2_<split>.npz`` for splits whose targets are all NaN
    (``gen`` unused)."""
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


TRAIN_MODES = {"custom": custom_train, "inference-only": inference_only,
               "PCQM4Mv2-inference": ogblsc_inference}
