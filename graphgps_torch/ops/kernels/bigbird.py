"""BigBird block-sparse attention over a static block plan, forward and
backward: the CUDA kernels of ``csrc/bigbird.cu`` (replacing
``graphgps_tpu/ops/pallas/splash_bigbird.py:87`` ``splash_bigbird``, which
runs the TPU splash-attention kernel of ``jax.experimental.pallas.ops.tpu.
splash_attention`` over the plan; its backward lives in that library) and
their plain PyTorch versions.

Splash's semantics as ``splash_bigbird`` uses it: q is multiplied by
``1/sqrt(Dh)`` before ``q kᵀ``; a (query, key) pair is allowed where the
plan holds (``ops/bigbird.py`` ``block_plan``) and their segment ids
(``key_mask`` as int: padded 0, real 1) are equal; a pair in the plan
whose ids differ gets the library's mask value ``-0.7 · float32.max``
(assigned, not added), a pair off the plan is never visited; ``o =
softmax · v``. So a padded query row attends over the padded keys its plan
allows, and a real row equals the dense path's. The kernels run at the
true head width (the TPU's padding of Dh to 128 lanes has no
counterpart).

The plan becomes, once per (N, block size, random blocks, seed) and
device, two CSR lists: the keys of each query block and, transposed, the
query rows of each key block, each cut into tasks of at most TASK_LEN
entries (the global blocks attend to or are attended by every node), with
partial slots where a block has more than one task."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build
from .common import needs_grad, true_f32

# the kernels hold a head's columns in four registers per lane
MAX_HEAD_DIM = 128
# the library's DEFAULT_MASK_VALUE
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# entries of a block's list one warp walks (keys, or query rows)
TASK_LEN = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 15 + [_I] * 8 + [ctypes.c_float, _P]
_BWD_ARGTYPES = [_P] * 31 + [_I] * 11 + [ctypes.c_float, _P]


def _lists(owner, n: int, bs: int):
    """CSR lists of an (nb, nb) boolean ``owner`` (rows: the blocks that
    own a list): (ptr (nb+1,), idx) with the nodes of each row's blocks
    below ``n``, in ascending order."""
    nb = owner.shape[0]
    ptr = np.zeros(nb + 1, np.int64)
    idx = []
    for b in range(nb):
        nodes = np.flatnonzero(np.repeat(owner[b], bs)[:n])
        idx.append(nodes)
        ptr[b + 1] = ptr[b] + len(nodes)
    return ptr, np.concatenate(idx)


def _tasks(ptr):
    """Tasks of at most TASK_LEN entries per block: (blk, lo, hi, part)
    arrays, the combine entries (blk, first part, parts) of the blocks cut
    into more than one task, and the number of partial slots."""
    tasks, comb, parts = [], [], 0
    for b in range(len(ptr) - 1):
        lo, hi = int(ptr[b]), int(ptr[b + 1])
        n_t = max(1, -(-(hi - lo) // TASK_LEN))
        if n_t == 1:
            tasks.append((b, lo, hi, -1))
            continue
        comb.append((b, parts, n_t))
        for t in range(n_t):
            tasks.append((b, lo + t * TASK_LEN, min(hi, lo + (t + 1) * TASK_LEN),
                          parts + t))
        parts += n_t
    return (np.asarray(tasks, np.int32).reshape(-1, 4),
            np.asarray(comb, np.int32).reshape(-1, 3), parts)


@functools.lru_cache(maxsize=32)
def plan_tables(n: int, block_size: int, num_random_blocks: int, seed: int):
    """Host tables of a plan: for the query side ("q": the keys of each
    query block) and the key side ("k": the query rows of each key block)
    (ptr, idx, tasks, combine entries, partial slots)."""
    from ..bigbird import block_plan

    plan = block_plan(n, block_size, num_random_blocks, seed)
    out = {}
    for side, owner in (("q", plan), ("k", plan.T)):
        ptr, idx = _lists(owner, n, block_size)
        tasks, comb, parts = _tasks(ptr)
        out[side] = (ptr.astype(np.int32), idx.astype(np.int32), tasks, comb,
                     parts)
    return out


@functools.lru_cache(maxsize=32)
def _tables_on(device, n: int, bs: int, r: int, seed: int):
    """The plan's tables as int32 tensors on ``device`` (made once): per
    side (ptr, idx, blk, lo, hi, part, c_blk, c_p0, c_np, n_tasks, n_comb,
    parts)."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {}
    for side, (ptr, idx, tasks, comb, parts) in plan_tables(
            n, bs, r, seed).items():
        out[side] = (dev(ptr), dev(idx), *(dev(tasks[:, i]) for i in range(4)),
                     *(dev(comb[:, i]) for i in range(3)), len(tasks),
                     len(comb), parts)
    return out


def bigbird_plain(q, k, v, key_mask, block_size: int, num_random_blocks: int,
                  seed: int):
    """Plain version of :func:`bigbird_block_sparse`, same signature: the
    library's semantics (module docstring) on (B, H, N, N) logits, every
    row, padded ones included."""
    from ..bigbird import plan_mask

    true_f32()
    N, Dh = q.shape[2], q.shape[3]
    plan = plan_mask(N, block_size, num_random_blocks, seed, q.device)
    ids = key_mask.to(torch.int32)
    same = (ids[:, :, None] == ids[:, None, :])[:, None]
    logits = torch.einsum("bhqc,bhkc->bhqk", q * (1.0 / float(Dh) ** 0.5), k)
    logits = torch.where(same, logits, MASK_VALUE)
    logits = torch.where(plan, logits, -torch.inf)
    return torch.einsum("bhqk,bhkc->bhqc", torch.softmax(logits, dim=-1), v)


def bigbird_backward_plain(q, k, v, key_mask, block_size: int,
                           num_random_blocks: int, seed: int, do):
    """Plain version of :func:`bigbird_backward` (without ``o`` and
    ``kept``): autograd through :func:`bigbird_plain`."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        o = bigbird_plain(*ins, key_mask, block_size, num_random_blocks, seed)
        return torch.autograd.grad(o, ins, do)


def _check_args(q, k, v, key_mask):
    """Raise unless the arguments are what the kernels take; returns
    (B, H, N, Dh, device)."""
    B, H, N, Dh = q.shape
    dev = q.device
    if Dh > MAX_HEAD_DIM:
        raise ValueError(f"bigbird: head width {Dh} above the kernels' "
                         f"{MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(name, t, (B, H, N, Dh), dev)
    build.require("key_mask", key_mask, (B, N), dev, torch.bool)
    return B, H, N, Dh, dev


def _scale(Dh: int) -> float:
    return 1.0 / float(Dh) ** 0.5


def _side_args(side):
    """The table pointers and counts of one side, in the C order."""
    ptr, idx, blk, lo, hi, part, c_blk, c_p0, c_np, nt, nc, parts = side
    return ([build.ptr(t) for t in (ptr, idx, blk, lo, hi, part, c_blk, c_p0,
                                     c_np)], (nt, nc, parts))


def _launch_forward(q, k, v, key_mask, bs: int, r: int, seed: int):
    """The forward kernels. Returns o and the kept (segment ids (B, N)
    int32, the rows' log-sum-exps (B*H*N)) the backward takes back."""
    B, H, N, Dh, dev = _check_args(q, k, v, key_mask)
    tables = _tables_on(dev, N, bs, r, seed)
    ptrs, (nt, nc, parts) = _side_args(tables["q"])
    ids = key_mask.to(torch.int32)
    o = torch.empty_like(q)
    lse = torch.empty((B * H * N,), device=dev)
    scratch = torch.empty((max(1, B * H * parts * bs * (Dh + 2)),),
                          device=dev)
    fn = build.cfunc("bigbird", "bigbird_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, (q, k, v, ids)), *ptrs[1:], build.ptr(o),
             build.ptr(lse), build.ptr(scratch), nt, nc, parts, B, H, N, Dh,
             bs, _scale(Dh), build.stream_of(dev))
    build.check_launch("bigbird", err)
    bigbird_block_sparse.launches += 1
    return o, (ids, lse)


def bigbird_backward(q, k, v, key_mask, block_size: int,
                     num_random_blocks: int, seed: int, o, do, kept=None):
    """The backward of :func:`bigbird_block_sparse` given its output ``o``
    and the cotangent ``do`` (B, H, N, Dh): returns (dq, dk, dv). CPU
    tensors take the plain version; CUDA tensors launch the kernels, which
    also take the forward kernel's ``kept`` (the segment ids and the rows'
    log-sum-exps)."""
    if q.device.type == "cpu":
        return bigbird_backward_plain(q, k, v, key_mask, block_size,
                                      num_random_blocks, seed, do)
    if q.device.type != "cuda" or kept is None:
        raise ValueError(f"bigbird_backward: unsupported device {q.device}, "
                         "or no kept tensors")
    B, H, N, Dh, dev = _check_args(q, k, v, key_mask)
    ids, lse = kept
    build.require("ids", ids, (B, N), dev, torch.int32)
    build.require("lse", lse, (B * H * N,), dev)
    build.require("o", o, (B, H, N, Dh), dev)
    build.require("do", do, (B, H, N, Dh), dev)
    bs = block_size
    tables = _tables_on(dev, N, bs, num_random_blocks, seed)
    qptrs, (qnt, qnc, qparts) = _side_args(tables["q"])
    kptrs, (knt, knc, kparts) = _side_args(tables["k"])
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    drow = torch.empty((B * H * N,), device=dev)
    q_scratch = torch.empty((max(1, B * H * qparts * bs * Dh),), device=dev)
    k_scratch = torch.empty((max(1, B * H * kparts * bs * 2 * Dh),),
                            device=dev)
    fn = build.cfunc("bigbird", "bigbird_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (q, k, v, ids, o, lse, do)), *qptrs, *kptrs,
             *map(build.ptr, (dq, dk, dv, drow, q_scratch, k_scratch)),
             qnt, qnc, qparts, knt, knc, kparts, B, H, N, Dh, bs, _scale(Dh),
             build.stream_of(dev))
    build.check_launch("bigbird_backward", err)
    bigbird_backward.launches += 1
    return dq, dk, dv


class _BigBird(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_mask, bs, r, seed):
        o, (ids, lse) = _launch_forward(q, k, v, key_mask, bs, r, seed)
        ctx.conf = (bs, r, seed)
        ctx.save_for_backward(q, k, v, key_mask, o, ids, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, ids, lse = ctx.saved_tensors
        dq, dk, dv = bigbird_backward(q, k, v, key_mask, *ctx.conf, o,
                                      do.contiguous(), kept=(ids, lse))
        return dq, dk, dv, None, None, None, None


def bigbird_block_sparse(q, k, v, key_mask, block_size: int,
                         num_random_blocks: int, seed: int):
    """q, k, v: (B, H, N, Dh); key_mask: (B, N) bool, the segment ids
    (padded 0, real 1). Returns (B, H, N, Dh) as splash computes BigBird
    over the plan of (N, ``block_size``, ``num_random_blocks``, ``seed``)
    (module docstring); q, k and v get gradients. CPU tensors take the
    plain version (autograd differentiates it); CUDA tensors launch the
    kernels, and the backward kernels when differentiated."""
    if q.device.type == "cpu":
        return bigbird_plain(q, k, v, key_mask, block_size,
                             num_random_blocks, seed)
    if q.device.type != "cuda":
        raise ValueError(f"bigbird: unsupported device {q.device}")
    if not needs_grad(q, k, v):
        return _launch_forward(q, k, v, key_mask, block_size,
                               num_random_blocks, seed)[0]
    return _BigBird.apply(q, k, v, key_mask, block_size, num_random_blocks,
                          seed)


bigbird_block_sparse.launches = 0
bigbird_backward.launches = 0
