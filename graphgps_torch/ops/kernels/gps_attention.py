"""The GPS layer's Transformer branch for graphs of at most 128 node slots --
QKV projection, key-masked multi-head attention with dropout on the
probabilities, out-projection: the CUDA kernels of ``csrc/gps_attention.cu``
(replacing ``graphgps_tpu/ops/pallas/fused_gps_attn.py:279``
``fused_gps_attention`` and its backward ``_vjp_bwd`` :330) and their plain
PyTorch versions. The signature is JAX's: ``kmask`` is (B, N) float 0/1 and
the kernels take ``scale = 1/sqrt(d / H)`` themselves."""
from __future__ import annotations

import ctypes

import torch

from ..mha import merge_heads, mha_core, split_heads
from . import build
from .common import apply_dropout, check_rate, keep_rule, needs_grad, true_f32

# the key-mask mode of the tensor-core attention body (csrc/attn_tc.cuh)
# keeps a lane's keys' mask in one 32-bit word, and pads heads to at most 128
# columns
MAX_NODES = 128
MAX_HEAD_DIM = 128

_CONF_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_float,
                                       ctypes.c_void_p]
_FWD_ARGTYPES = [ctypes.c_void_p] * 11 + _CONF_ARGTYPES
_BWD_ARGTYPES = [ctypes.c_void_p] * 18 + _CONF_ARGTYPES
# positions of the differentiable inputs among the six tensors
GRAD_INPUTS = (0, 2, 3, 4, 5)   # x, wqkv, bqkv, wo, bo


def attn_scale(d: int, H: int) -> float:
    return 1.0 / float(d // H) ** 0.5


def gps_attention_plain(x, kmask, wqkv, bqkv, wo, bo, seed, H: int,
                        rate: float = 0.0):
    """Plain version of :func:`fused_gps_attention`, same signature: the
    QKV product, dense masked attention (``mha_core`` with its rule for
    masked logits, ``grad_through_mask``, the TPU kernel's: a graph with no
    real node has uniform weights that pass gradient to its q and k) with
    dropout site 0 on the (B*H*N, N) view of the probabilities -- the bits
    the layer's dense ``mha`` rung draws at the same seed -- and the
    out-projection."""
    check_rate(rate)
    true_f32()
    B, N, d = x.shape
    qkv = x @ wqkv + bqkv
    q, k, v = (split_heads(qkv[..., i * d:(i + 1) * d], H) for i in range(3))
    drop = None
    if rate > 0.0:
        drop = lambda p: apply_dropout(p, seed, 0, rate)  # noqa: E731
    o = mha_core(q, k, v, kmask > 0, scale=attn_scale(d, H), drop=drop)
    return merge_heads(o) @ wo + bo


def gps_attention_backward_plain(x, kmask, wqkv, bqkv, wo, bo, seed, H, rate,
                                 gy):
    """Plain version of :func:`gps_attention_backward`, same signature
    (without ``kept``): autograd through :func:`gps_attention_plain` with
    the same mask."""
    inputs = (x, kmask, wqkv, bqkv, wo, bo)
    with torch.enable_grad():
        ins = list(inputs)
        for i in GRAD_INPUTS:
            ins[i] = inputs[i].detach().requires_grad_()
        y = gps_attention_plain(*ins, seed, H, rate)
        return torch.autograd.grad(y, [ins[i] for i in GRAD_INPUTS], gy)


def _check_args(x, kmask, wqkv, bqkv, wo, bo, H):
    """Raise unless the arguments are what the kernels take; returns
    (B, N, d, device)."""
    B, N, d = x.shape
    dev = x.device
    if not (H > 0 and d % H == 0 and N <= MAX_NODES
            and d // H <= MAX_HEAD_DIM):
        raise ValueError(
            f"fused_gps_attention: N={N}, d={d}, H={H} outside the kernels' "
            f"envelope (N ≤ {MAX_NODES}, H dividing d into heads of at most "
            f"{MAX_HEAD_DIM} columns)")
    build.require("x", x, (B, N, d), dev)
    build.require("kmask", kmask, (B, N), dev)
    build.require("wqkv", wqkv, (d, 3 * d), dev)
    build.require("bqkv", bqkv, (3 * d,), dev)
    build.require("wo", wo, (d, d), dev)
    build.require("bo", bo, (d,), dev)
    return B, N, d, dev


def _conf(B, N, d, H, seed, rate, dev):
    t, sc = keep_rule(rate)
    return (B, N, d, H, attn_scale(d, H), build.seed_arg(seed, t, dev), t, sc,
            build.stream_of(dev))


def _launch_forward(args, seed, H, rate):
    """The forward kernel. Returns y and the kept (qkv (B*N, 3d),
    o (B*N, d), the softmax's row maxima and sums (B*H*N)) the backward
    takes back."""
    B, N, d, dev = _check_args(*args, H)
    f32 = dict(device=dev, dtype=torch.float32)
    y = torch.empty_like(args[0])
    qkv = torch.empty((B * N, 3 * d), **f32)
    o = torch.empty((B * N, d), **f32)
    mrow = torch.empty((B * H * N,), **f32)
    lrow = torch.empty((B * H * N,), **f32)
    fn = build.cfunc("gps_attention", "gps_attention_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, args + (y, qkv, o, mrow, lrow)),
             *_conf(B, N, d, H, seed, rate, dev))
    build.check_launch("fused_gps_attention", err)
    fused_gps_attention.launches += 1
    return y, (qkv, o, mrow, lrow)


def gps_attention_backward(x, kmask, wqkv, bqkv, wo, bo, seed, H: int,
                           rate: float, gy, kept=None):
    """The backward of :func:`fused_gps_attention` given the cotangent gy
    (B, N, d): returns (dx, dwqkv, dbqkv, dwo, dbo). CPU tensors take the
    plain version; CUDA tensors launch the kernel, which also takes the
    forward kernel's ``kept`` (qkv, o and the softmax's row maxima and
    sums)."""
    inputs = (x, kmask, wqkv, bqkv, wo, bo)
    if x.device.type == "cpu":
        return gps_attention_backward_plain(*inputs, seed, H, rate, gy)
    check_rate(rate)
    if x.device.type != "cuda" or kept is None:
        raise ValueError(f"gps_attention_backward: unsupported device "
                         f"{x.device}, or no kept tensors")
    B, N, d, dev = _check_args(*inputs, H)
    qkv, o, mrow, lrow = kept
    build.require("gy", gy, (B, N, d), dev)
    build.require("qkv", qkv, (B * N, 3 * d), dev)
    build.require("o", o, (B * N, d), dev)
    for name, t in (("mrow", mrow), ("lrow", lrow)):
        build.require(name, t, (B * H * N,), dev)
    em = lambda *s: torch.empty(s, device=dev)  # noqa: E731
    dx = torch.empty_like(x)
    dwqkv, dbqkv, dwo, dbo = em(d, 3 * d), em(3 * d), em(d, d), em(d)
    d_o, dqkv, drow = em(B * N, d), em(B * N, 3 * d), em(B * H * N)
    scratch = em(build.cfunc("gps_attention", "gps_attention_backward_scratch",
                             [ctypes.c_int] * 3, ctypes.c_longlong)(B, N, d))
    fn = build.cfunc("gps_attention", "gps_attention_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (x, kmask, wqkv, wo, qkv, o, mrow, lrow, gy, dx,
                              dwqkv, dbqkv, dwo, dbo, d_o, dqkv, drow,
                              scratch)),
             *_conf(B, N, d, H, seed, rate, dev))
    build.check_launch("gps_attention_backward", err)
    gps_attention_backward.launches += 1
    return dx, dwqkv, dbqkv, dwo, dbo


class _GpsAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *inputs):
        args, conf = inputs[:6], inputs[6:]
        y, kept = _launch_forward(args, *conf)
        ctx.save_for_backward(*args, *kept)
        ctx.conf = conf
        return y

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        grads = gps_attention_backward(*saved[:6], *ctx.conf,
                                       gy.contiguous(), kept=saved[6:])
        out = [None] * 9
        for i, gr in zip(GRAD_INPUTS, grads):
            out[i] = gr
        return tuple(out)


def fused_gps_attention(x, kmask, wqkv, bqkv, wo, bo, seed, H: int,
                        rate: float = 0.0):
    """x: (B, N, d); kmask: (B, N) float 1/0 (the keys with 0 are masked);
    wqkv: (d, 3d) = [Wq|Wk|Wv] and bqkv: (3d,); wo/bo the out-projection --
    (in, out) weights as in the JAX package; ``seed`` draws the dropout of
    the attention probabilities at ``rate``.

    Returns y (B, N, d) = ``outProj(MHA(qkvProj(x)))``; x and the four
    weights get gradients. CPU tensors take the plain version (autograd
    differentiates it); CUDA tensors launch the kernel (N ≤ 128, heads of at
    most 128 columns), and the backward kernel when differentiated."""
    args = (x, kmask, wqkv, bqkv, wo, bo)
    if x.device.type == "cpu":
        return gps_attention_plain(*args, seed, H, rate)
    check_rate(rate)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gps_attention: unsupported device {x.device}")
    if not needs_grad(*args):
        return _launch_forward(args, seed, H, rate)[0]
    return _GpsAttention.apply(*args, seed, H, rate)


fused_gps_attention.launches = 0
gps_attention_backward.launches = 0
