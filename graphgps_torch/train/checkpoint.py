"""Training checkpoints in the port's own format (counterpart of
``graphgps_tpu/train/loop.py:450-685`` ``save_ckpt``/``load_ckpt``/
``clean_ckpt``): one ``torch.save`` file per epoch,
``<run_dir>/ckpt/<epoch>.pt``, holding the model's parameters and buffers
(the BatchNorm running statistics), the optimizer's state, the dropout
generator's state, the plateau scheduler's state (``lr``, ``best``,
``num_bad``; None under the epoch schedules) and the epoch. A file is written under a temporary name
and renamed, so a reader never sees half a checkpoint. The JAX package's
orbax checkpoints are not read (ROADMAP Queue 1 item 17)."""
from __future__ import annotations

import os
from typing import Iterable, Optional, Union

import torch


def ckpt_dir(run_dir: str) -> str:
    return os.path.join(run_dir, "ckpt")


def ckpt_path(run_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir(run_dir), f"{epoch}.pt")


def saved_epochs(run_dir: str) -> list:
    d = ckpt_dir(run_dir)
    if not os.path.isdir(d):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(d)
                  if f.endswith(".pt") and f[:-3].isdigit())


def save_ckpt(run_dir: str, model, opt, epoch: int,
              gen: Optional[torch.Generator] = None, scheduler=None) -> str:
    """``scheduler``: the plateau scheduler, whose state is stored, or
    None."""
    path = ckpt_path(run_dir, epoch)
    os.makedirs(ckpt_dir(run_dir), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(dict(model=model.state_dict(), optimizer=opt.state_dict(),
                    generator=None if gen is None else gen.get_state(),
                    scheduler=(None if scheduler is None
                               else scheduler.state_dict()),
                    epoch=epoch), tmp)
    os.replace(tmp, path)
    return path


def load_ckpt(run_dir: str, model, opt=None, epoch: int = -1,
              gen: Optional[torch.Generator] = None, scheduler=None) -> int:
    """Restore the given epoch (the latest when ``epoch`` < 0 or not
    saved) into ``model`` (and ``opt``, ``gen``, and the plateau
    ``scheduler`` when the checkpoint holds its state). Returns the next
    epoch to run, 0 when there is no checkpoint."""
    epochs = saved_epochs(run_dir)
    if not epochs:
        return 0
    target = epoch if epoch in epochs else epochs[-1]
    state = torch.load(ckpt_path(run_dir, target), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state["model"])
    if opt is not None:
        opt.load_state_dict(state["optimizer"])
    if gen is not None and state["generator"] is not None:
        gen.set_state(state["generator"])
    if scheduler is not None and state.get("scheduler") is not None:
        scheduler.load_state_dict(state["scheduler"])
    return state["epoch"] + 1


def clean_ckpt(run_dir: str, keep: Union[int, Iterable[int]]) -> None:
    """Delete every checkpoint file but the epochs in ``keep``."""
    keep = {keep} if isinstance(keep, int) else set(keep)
    d = ckpt_dir(run_dir)
    if not os.path.isdir(d):
        return
    for f in os.listdir(d):
        head = f.split(".", 1)[0]
        if head.isdigit() and int(head) not in keep:
            os.remove(os.path.join(d, f))
