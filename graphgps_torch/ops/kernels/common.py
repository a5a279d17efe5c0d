"""Helpers shared by the kernel wrappers and their plain versions."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def act_fn(name: str):
    """The activations the kernels take (codes in ``build.ACTS``); gelu is
    the exact-erf form."""
    if name == "relu":
        return torch.relu
    if name == "gelu":
        return F.gelu
    if name == "identity":
        return lambda z: z
    raise NotImplementedError(f"activation {name!r} is not ported")


def check_rate(rate: float) -> None:
    """The main path evaluates; dropout inside the kernels comes with the
    training slice (ROADMAP Queue 1 item 9)."""
    if rate > 0.0:
        raise ValueError(f"dropout rate {rate} > 0 is not supported yet: the "
                         "port runs evaluation only")


def true_f32() -> None:
    """Plain versions compare with the kernels in true f32: no TF32 in
    matrix products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
