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

The plan becomes, once per (N, block size, random blocks, seed, head
width) and device, tables of items for each side: the query side (the
keys of each query block: forward and dq) and the key side (the query rows
of each key block: dk and dv). An item is one CUDA block of GROUPS groups
of 4 lanes. It stages rows of the other side, one head's, in shared memory
with 16-byte copies: the rows its lists need, in ascending order (for a run
of up to :func:`run_blocks` own blocks: their window, the global blocks
and the random blocks), at most :func:`max_rows`. Each own row of a task is
a unit, one group's: it walks its block's list, entries that name staged
rows. A list longer than that (the global rows, which see all N nodes; the
global keys, which all N nodes see) is cut into chunks of consecutive rows,
tasks of TASK_LEN entries: a chunk's item adds its tasks up into one
partial slot, and a combine kernel merges the chunks' slots in a fixed
order. The chunks' items come last."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import build
from .common import needs_grad, true_f32

# the kernels hold a head's columns in four registers per lane
MAX_HEAD_DIM = 128
# the library's DEFAULT_MASK_VALUE
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# groups of 4 lanes a CUDA block runs (one own row each), entries of a
# chunk's task, staged rows an item holds at most, and the shared memory
# those rows may take (floats)
GROUPS = 32
TASK_LEN = 16
MAX_ROWS = 128
STAGE_FLOATS = 16384

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 15 + [_I] * 10 + [ctypes.c_float, _P]
_BWD_ARGTYPES = [_P] * 29 + [_I] * 15 + [ctypes.c_float, _P]


class Side(NamedTuple):
    """The item tables of one side (int32 arrays): ``row`` the rows each
    item stages, in order, ``item_row`` (items + 1) an item's rows in
    ``row``, ``task`` (tasks, 5) a task's own block, its
    entries [lo, hi) in ``slot``, its partial slot (-1: the result itself)
    and whether it is its block's first, ``item_task`` (items + 1) an
    item's tasks, ``slot`` the staged row of each entry within its item (a
    chunk's tasks share its partial slot); ``comb`` (entries, 3) the blocks
    cut into chunks (block, first slot, slots), ``parts`` the partial
    slots, ``rows`` the most rows an item stages, ``entries`` the most
    entries an item's tasks hold."""
    row: np.ndarray
    item_row: np.ndarray
    task: np.ndarray
    item_task: np.ndarray
    slot: np.ndarray
    comb: np.ndarray
    parts: int
    rows: int
    entries: int


def stage_ld(dh: int) -> int:
    """A staged row's stride in floats (``bb_ld`` of ``csrc/bigbird.cu``):
    Dh rounded up to 16 bytes, the copies' size."""
    return -(-dh // 4) * 4


def max_rows(dh: int) -> int:
    """Rows an item may stage at head width ``dh``: two rows of ``stage_ld``
    and three scalars each within STAGE_FLOATS, at most MAX_ROWS, at least
    one chunk's TASK_LEN."""
    return max(TASK_LEN, min(MAX_ROWS, STAGE_FLOATS // (2 * stage_ld(dh)
                                                         + 3)))


def run_blocks(bs: int) -> int:
    """Own blocks an item takes at most: one own row a group."""
    return max(1, GROUPS // bs)


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


def _items(ptr, idx, bs: int, rows: int) -> Side:
    """The items of one side's lists (module docstring): runs of up to
    ``run_blocks(bs)`` consecutive blocks whose lists together name at most
    ``rows`` staged rows, and a longer list cut into chunks of as many
    TASK_LEN-entry tasks, at most ``rows`` entries, one partial slot a
    chunk."""
    run_max = run_blocks(bs)
    chunk = min(rows, run_max * TASK_LEN) // TASK_LEN * TASK_LEN
    row, item_row, task, item_task, slot, comb = [], [0], [], [0], [], []
    parts, most, most_e, n_slot = 0, 0, 0, 0

    def item(nodes, tasks):
        """An item staging ``nodes`` (sorted) with ``tasks`` (block, its
        entries as nodes, part, first)."""
        nonlocal most, most_e, n_slot
        row.append(nodes)
        most_e = max(most_e, sum(len(t[1]) for t in tasks))
        item_row.append(item_row[-1] + len(nodes))
        for blk, entries, part, first in tasks:
            slot.append(np.searchsorted(nodes, entries))
            task.append((blk, n_slot, n_slot + len(entries), part, first))
            n_slot += len(entries)
        item_task.append(len(task))
        most = max(most, len(nodes))

    lists = [idx[ptr[b]:ptr[b + 1]] for b in range(len(ptr) - 1)]
    long = [b for b, nodes in enumerate(lists) if len(nodes) > rows]
    b = 0
    while b < len(lists):
        if b in long:
            b += 1
            continue
        run, staged = [b], lists[b]
        while (len(run) < run_max and b + len(run) < len(lists)
               and b + len(run) not in long):
            more = np.union1d(staged, lists[b + len(run)])
            if len(more) > rows:
                break
            run.append(b + len(run))
            staged = more
        item(staged, [(r, lists[r], -1, 1) for r in run])
        b += len(run)
    # the chunks last, the lighter items in the grid's last wave
    for b in long:
        nodes = lists[b]
        n_c = -(-len(nodes) // chunk)
        comb.append((b, parts, n_c))
        for c0 in range(0, len(nodes), chunk):
            part = nodes[c0:c0 + chunk]
            item(part, [(b, part[t0:t0 + TASK_LEN], parts + c0 // chunk,
                         int(c0 + t0 == 0))
                        for t0 in range(0, len(part), TASK_LEN)])
        parts += n_c
    def i32(a, *shape):
        return np.asarray(a, np.int32).reshape(shape)

    flat = lambda a: i32(np.concatenate(a) if a else [], -1)  # noqa: E731
    return Side(flat(row), i32(item_row, -1), i32(task, -1, 5),
                i32(item_task, -1), flat(slot), i32(comb, -1, 3), parts,
                most, most_e)


@functools.lru_cache(maxsize=32)
def plan_tables(n: int, block_size: int, num_random_blocks: int, seed: int,
                rows: int = MAX_ROWS):
    """Host tables of a plan, at most ``rows`` staged rows an item: for the
    query side ("q": the keys of each query block) and the key side ("k":
    the query rows of each key block), a :class:`Side` each."""
    from ..bigbird import block_plan

    plan = block_plan(n, block_size, num_random_blocks, seed)
    return {side: _items(*_lists(owner, n, block_size), block_size, rows)
            for side, owner in (("q", plan), ("k", plan.T))}


@functools.lru_cache(maxsize=32)
def _tables_on(device, n: int, bs: int, r: int, seed: int, rows: int):
    """The plan's tables as int32 tensors on ``device`` (made once): per
    side (row, item_row, task, item_task, slot, c_blk, c_p0, c_np, items,
    combine entries, parts, rows, entries)."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    out = {}
    for side, t in plan_tables(n, bs, r, seed, rows).items():
        out[side] = (*(dev(a) for a in (t.row, t.item_row, t.task,
                                        t.item_task, t.slot)),
                     *(dev(t.comb[:, i]) for i in range(3)),
                     len(t.item_row) - 1, len(t.comb), t.parts, t.rows,
                     t.entries)
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
    """The table pointers and counts (items, combine entries, partial
    slots, most staged rows, most entries) of one side, in the C order."""
    return [build.ptr(t) for t in side[:8]], side[8:]


def _launch_forward(q, k, v, key_mask, bs: int, r: int, seed: int):
    """The forward kernels. Returns o and the kept (the segment ids as the
    mask's bytes (B, N), the rows' log-sum-exps (B*H*N)) the backward takes
    back."""
    B, H, N, Dh, dev = _check_args(q, k, v, key_mask)
    tables = _tables_on(dev, N, bs, r, seed, max_rows(Dh))
    ptrs, counts = _side_args(tables["q"])
    ids = key_mask.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((B * H * N,), device=dev)
    scratch = torch.empty((max(1, B * H * counts[2] * bs * (Dh + 2)),),
                          device=dev)
    fn = build.cfunc("bigbird", "bigbird_forward", _FWD_ARGTYPES)
    err = fn(*map(build.ptr, (q, k, v, ids)), *ptrs, build.ptr(o),
             build.ptr(lse), build.ptr(scratch), *counts, B, H, N, Dh, bs,
             _scale(Dh), build.stream_of(dev))
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
    build.require("ids", ids, (B, N), dev, torch.bool)
    build.require("lse", lse, (B * H * N,), dev)
    build.require("o", o, (B, H, N, Dh), dev)
    build.require("do", do, (B, H, N, Dh), dev)
    bs = block_size
    tables = _tables_on(dev, N, bs, num_random_blocks, seed, max_rows(Dh))
    qptrs, qcounts = _side_args(tables["q"])
    kptrs, kcounts = _side_args(tables["k"])
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    drow = torch.empty((B * H * N,), device=dev)
    q_scratch = torch.empty((max(1, B * H * qcounts[2] * bs * Dh),),
                            device=dev)
    k_scratch = torch.empty((max(1, B * H * kcounts[2] * bs * 2 * Dh),),
                            device=dev)
    fn = build.cfunc("bigbird", "bigbird_backward", _BWD_ARGTYPES)
    err = fn(*map(build.ptr, (q, k, v, ids, o, lse, do)), *qptrs, *kptrs,
             *map(build.ptr, (dq, dk, dv, drow, q_scratch, k_scratch)),
             *qcounts, *kcounts, B, H, N, Dh, bs, _scale(Dh),
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
