"""Segment-masked multi-head attention with an optional additive bias, by an
online softmax over key tiles: the CUDA kernels of ``csrc/flash_mha.cu``
(replacing ``graphgps_tpu/ops/pallas/flash_mha.py:67`` ``flash_mha``, which
wraps the TPU flash kernel of ``jax.experimental.pallas.ops.tpu.
flash_attention``; its backward lives in that library) and their plain
PyTorch versions.

The library's semantics, which differ from the port's ``mha_core``: the
logits are ``(q kᵀ + bias) · scale`` (the scale multiplies the bias too),
``scale = 1/sqrt(Dh)``, and where the segment ids (``key_mask`` as int:
padded 0, real 1) of a query and a key differ, ``-0.7 · float32.max`` is
added. So a padded query row attends over the padded keys of its graph,
while a real row equals the dense rung's. The kernels run at the true head
width: the TPU's padding of Dh to 128 lanes (``pad_head_dim``) has no
counterpart. The forward runs in f64 on the FP64 tensor cores from the f32
inputs and rounds o and the rows' log-sum-exps to f32 once, so o is the
exact attention correctly rounded (to within f64 rounding); the backward
runs on the tensor cores in 3xTF32 (``csrc/attn_tc.cuh``). Both pad the
head to a multiple of 8 columns in shared memory only."""
from __future__ import annotations

import ctypes

import torch

from . import build
from .common import needs_grad, true_f32

# the widest head the kernels take (csrc/flash_mha.cu FA_MAX_DH): the
# widest padded width they are instantiated for, forward and backward
MAX_HEAD_DIM = 128
# the library's DEFAULT_MASK_VALUE
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

# the forward takes its scale in f64, the backward in f32
_FWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_double, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_void_p]


def flash_mha_plain(q, k, v, key_mask, bias=None):
    """Plain version of :func:`flash_mha`, same signature: the library's
    reference formula (``mha_reference_no_custom_vjp``) in PyTorch ops, on
    every row, padded ones included."""
    true_f32()
    scale = 1.0 / float(q.shape[-1]) ** 0.5
    logits = torch.einsum("bhqc,bhkc->bhqk", q, k)
    if bias is not None:
        logits = logits + bias
    logits = logits * scale
    ids = key_mask.to(torch.int32)
    same = ids[:, :, None] == ids[:, None, :]
    logits = logits + torch.where(same, 0.0, MASK_VALUE).to(
        logits.dtype)[:, None]
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkc->bhqc", w, v)


def flash_mha_backward_plain(q, k, v, key_mask, bias, do):
    """Plain version of :func:`flash_mha_backward`, same signature (without
    ``kept``): autograd through :func:`flash_mha_plain`."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        if bias is not None:
            ins.append(bias.detach().requires_grad_())
        o = flash_mha_plain(*ins[:3], key_mask, ins[3] if bias is not None
                            else None)
        grads = torch.autograd.grad(o, ins, do)
    return (*grads[:3], grads[3] if bias is not None else None)


def f32_ulps(a, b):
    """|a - b| in f32 ulps, elementwise, for f32 tensors: the distance of
    their bit patterns on the ordered integer line. The forward's output is
    held to its plain version evaluated in f64 and rounded by it."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def _check_args(q, k, v, key_mask, bias):
    """Raise unless the arguments are what the kernels take; returns
    (B, H, N, Dh, device)."""
    B, H, N, Dh = q.shape
    dev = q.device
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_mha: head width {Dh} above the kernels' "
                         f"{MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(name, t, (B, H, N, Dh), dev)
    build.require("key_mask", key_mask, (B, N), dev, torch.bool)
    if bias is not None:
        build.require("bias", bias, (B, H, N, N), dev)
    return B, H, N, Dh, dev


def _scale(Dh: int) -> float:
    return 1.0 / float(Dh) ** 0.5


def _launch_forward(q, k, v, key_mask, bias):
    """The forward kernel. Returns o and the kept (segment ids (B, N) int32,
    the rows' log-sum-exps (B*H*N)) the backward takes back."""
    B, H, N, Dh, dev = _check_args(q, k, v, key_mask, bias)
    ids = key_mask.to(torch.int32)
    o = torch.empty_like(q)
    lse = torch.empty((B * H * N,), device=dev)
    fn = build.cfunc("flash_mha", "flash_mha_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, (q, k, v, ids)),
             None if bias is None else build.ptr(bias), build.ptr(o),
             build.ptr(lse), B, H, N, Dh, _scale(Dh), build.stream_of(dev))
    build.check_launch("flash_mha", err)
    flash_mha.launches += 1
    return o, (ids, lse)


def flash_mha_backward(q, k, v, key_mask, bias, o, do, kept=None):
    """The backward of :func:`flash_mha` given its output ``o`` and the
    cotangent ``do`` (B, H, N, Dh): returns (dq, dk, dv, dbias), dbias None
    without a bias. CPU tensors take the plain version; CUDA tensors launch
    the kernel, which also takes the forward kernel's ``kept`` (the segment
    ids and the rows' log-sum-exps)."""
    if q.device.type == "cpu":
        return flash_mha_backward_plain(q, k, v, key_mask, bias, do)
    if q.device.type != "cuda" or kept is None:
        raise ValueError(f"flash_mha_backward: unsupported device {q.device}, "
                         "or no kept tensors")
    B, H, N, Dh, dev = _check_args(q, k, v, key_mask, bias)
    ids, lse = kept
    build.require("ids", ids, (B, N), dev, torch.int32)
    build.require("lse", lse, (B * H * N,), dev)
    build.require("o", o, (B, H, N, Dh), dev)
    build.require("do", do, (B, H, N, Dh), dev)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dbias = None if bias is None else torch.empty_like(bias)
    drow = torch.empty((B * H * N,), device=dev)
    fn = build.cfunc("flash_mha", "flash_mha_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (q, k, v, ids)),
             None if bias is None else build.ptr(bias),
             *map(build.ptr, (o, lse, do, dq, dk, dv)),
             None if dbias is None else build.ptr(dbias), build.ptr(drow),
             B, H, N, Dh, _scale(Dh), build.stream_of(dev))
    build.check_launch("flash_mha_backward", err)
    flash_mha_backward.launches += 1
    return dq, dk, dv, dbias


class _FlashMha(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, bias):
        o, (ids, lse) = _launch_forward(q, k, v, key_mask, bias)
        ctx.save_for_backward(q, k, v, key_mask, bias, o, ids, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, bias, o, ids, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_mha_backward(
            q, k, v, key_mask, bias, o, do.contiguous(), kept=(ids, lse))
        return dq, dk, dv, None, dbias


def flash_mha(q, k, v, key_mask, bias=None):
    """q, k, v: (B, H, N, Dh); key_mask: (B, N) bool, the segment ids
    (padded 0, real 1); bias: (B, H, N, N) additive, or None. Returns
    (B, H, N, Dh) as the library's flash attention computes it (module
    docstring); q, k, v and the bias get gradients. CPU tensors take the
    plain version (autograd differentiates it); CUDA tensors launch the
    kernel, and the backward kernel when differentiated."""
    if q.device.type == "cpu":
        return flash_mha_plain(q, k, v, key_mask, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {q.device}")
    if not needs_grad(q, k, v, bias):
        return _launch_forward(q, k, v, key_mask, bias)[0]
    return _FlashMha.apply(q, k, v, key_mask, bias)


flash_mha.launches = 0
flash_mha_backward.launches = 0
