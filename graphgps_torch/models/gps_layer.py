"""The GPS layer: a local message-passing branch ∥ a Transformer global
branch, then the FFN (counterpart of ``graphgps_tpu/models/gps_layer.py``
``GPSLayer`` :37-531).

Three paths, chosen by the local layer, the width and the settings as the
JAX package chooses them (its VMEM caps are the TPU's and are not kept):

- **merged** (CustomGatedGCN, ``dim_h % 128 == 0``, at most 128 node
  slots per graph, ``gt.attn_impl`` auto or fused, and the JAX switch
  ``GGPS_FUSED_FRONT`` not 0; JAX :144-215 and :471-495). Three kernels per
  layer: the front (GatedGCN core + attention + dropout and residual), the
  edge tail, and the combine+FFN; three dropout seeds. The attention
  branch's norm takes its statistics from the front's moment partials.
- **unmerged** (CustomGatedGCN at any other width from 64 up, or where the
  merged front does not run; JAX :138-148, :250-268, :270-392, :449-518).
  The standalone GatedGCN core kernel (on
  long graphs the Linears and the edge gate, ``local_gnn.py``), then the
  Transformer branch (:meth:`GPSLayer.attention`). When the tails are
  deferred -- in training with dropout on, or at a lane width -- the edge
  tail runs through ``fused_pre_tail``, the attention branch's residual
  through ``fused_drop_add`` (a plain add at rate 0), and the x-tail, the
  attention norm's apply, the branch sum and the FFN through
  ``fused_combine_ffn``: four dropout seeds (edge tail, attention,
  drop-add, combine). Otherwise (evaluation, or training without dropout,
  at a width that is no multiple of 128) the tails, the branch sum and the
  FFN are plain PyTorch.
- **plain local** (``local="GCN"`` or ``"GINE"``; JAX :218-243, :89-117
  and :496-518). The GCN or GINE layer (``local_gnn.py``; GINE's edge
  features pass through), its residual ``x + drop(h_local)`` through
  ``fused_drop_add`` (a plain add at rate 0; flax ``nn.Dropout``'s exact
  rate outside the tail envelope, below a width of 64) and its norm; the
  Transformer branch, its residual likewise and its norm; the branch
  sum; the FFN through ``fused_ffn`` where JAX takes ``fused_ffn_padded``
  (the tail envelope, and a width that is a multiple of 128 or training
  with dropout), else plain PyTorch. Each norm is a full MaskedBatchNorm
  with ``batch_norm``, else the identity (JAX's ``Norm`` with both norms
  off). Four dropout seeds: local drop-add, attention, attention drop-add,
  FFN. GINE takes every width; GCN and CustomGatedGCN from 64.

The Transformer branch of the unmerged and plain local paths
(:meth:`GPSLayer.attention`) takes JAX's rungs (:270-392) in JAX's order, by
``gt.attn_impl``: ``fused_gps_attention`` (QKV projection, masked attention
with hashed dropout on the probabilities, out-projection, in one call)
under auto or fused within its envelope (:func:`fused_eligible`), under
auto only from :func:`fused_auto_wins`' B·N on, and fused outside it
raises; then, under auto, ``fused_wide_attention`` (the same in an online
softmax over key tiles) for graphs of more than 128 and at most 768 node
slots; then the ``mha`` dispatch (``ops/mha.py`` ``mha_dispatch``: PyTorch
ops with a dense softmax, the chunked attention beyond 1,024 slots or
64 MB of scores, as JAX leaves both to XLA, or, under flash, the
``flash_mha`` kernel). dense and chunked force their rung. With the BigBird
global model (``gt.layer_type`` ``GCN+BigBird`` or
``CustomGatedGCN+BigBird``; JAX :428-445) the branch is BigBird on the same
QKV and out-projection weights instead, never the merged front or the fused
and wide rungs: ``original_full`` the dense masked attention,
``block_sparse`` the ``bigbird_attention`` dispatch (``ops/bigbird.py``:
the block-sparse kernel on the card without attention dropout from
``GGPS_SPLASH_MIN_N`` node slots on the 128 grid, the dense attention with
the plan's bias otherwise), the plan drawn from the layer's index. (JAX on
the TPU sends BigBird at 129-768 node slots under auto to its wide
attention kernel, full attention; the port keeps BigBird there.)

All end in the final norm with the padded node slots zeroed. Weights are
held in the kernels' (in, out) layout, with their flax counterparts. The
layout depends on the width alone, not on the path, so that one checkpoint
serves both paths as one flax tree serves every rung in JAX (:254-267): at
a multiple of 128 a CustomGatedGCN layer holds ``w_front``/``b_front``, the
joint ``[A|D|E|B|Wq|Wk|Wv]`` (``GatedGCNLayer_0/Dense_{0,3,4,1}`` and
``qkv_kernel``/``qkv_bias``), and its unmerged path takes contiguous copies
of the ``[A|D|E|B]`` and ``[Wq|Wk|Wv]`` columns (:meth:`GPSLayer.node_proj`,
:meth:`GPSLayer.qkv_proj`: 1 MB a layer at d = 256, against converting the
model and its optimizer state when a checkpoint changes paths); at other
widths it holds ``local.w_node``/``local.b_node`` = ``[A|D|E|B]`` and
``w_qkv``/``b_qkv``, each contiguous as the kernels need them; ``local``
(``GatedGCNLayer_0``, ``GINELayer_0`` or ``GCNLayer_0``), ``w_out``/
``b_out`` (``out_kernel``/``out_bias``), ``w_ffn1``..``b_ffn2``
(``Dense_0``/``Dense_1``) and the norms: ``norm_attn`` (``Norm_0``) and
``norm_out`` (``Norm_1``); on the plain local path ``norm_local``,
``norm_attn`` and ``norm_out`` (``Norm_0``..``Norm_2``, present with
``batch_norm``).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from ..data.graph import GraphBatch
from ..ops.kernels import (build, fused_combine_ffn, fused_drop_add,
                           fused_ffn, fused_gps_attention,
                           fused_wide_attention)
from ..ops.bigbird import ATTENTION_TYPES, bigbird_attention
from ..ops.kernels.common import exact_dropout
from ..ops.mha import merge_heads, mha, mha_dispatch, split_heads
from .common import MaskedBatchNorm, dense_params, get_act
from .local_gnn import FrontPack, GatedGCNLayer, GCNLayer, GINELayer

# dropout seeds per layer and step. Merged: front, edge tail, combine+FFN;
# unmerged: edge tail, attention, drop-add, combine+FFN; plain local: local
# drop-add, attention, attention drop-add, FFN
SEEDS_PER_LAYER = 3
SEEDS_PER_LAYER_UNMERGED = 4
# the local layers of the plain local path, all the local layers and the
# global models a GPSLayer takes
PLAIN_LOCAL = ("GCN", "GINE")
LOCAL_TYPES = ("CustomGatedGCN",) + PLAIN_LOCAL
GLOBAL_TYPES = ("Transformer", "BigBird")
# the merged front holds a graph's N x N scores in shared memory
MERGED_MAX_NODES = 128
# the unmerged and plain local paths' attention: fused_wide_attention above
# WIDE_MIN_NODES node slots per graph and up to the TPU kernel's own limit
# (``wide_eligible``, fused_attn_wide.py :365), the mha dispatch elsewhere
WIDE_MIN_NODES = 128
WIDE_MAX_NODES = 768
# below this width the JAX package runs no fused kernel (fused_gatedgcn.py
# :498, fused_tail.py :495); CustomGatedGCN and GCN layers need it, GINE's
# path runs plain below it, as JAX's
MIN_DIM = 64
# the values of gt.attn_impl a GPSLayer takes (JAX's but ring)
ATTN_IMPLS = ("auto", "dense", "chunked", "flash", "fused")
# fused_gps_attention's auto threshold on B·N (fused_auto_wins,
# fused_gps_attn.py:450)
FUSED_AUTO_ROWS = 8192


def fused_eligible(N: int, d: int, H: int) -> bool:
    """The envelope of the fused attention rung (``fused_eligible``,
    ``fused_gps_attn.py:438``): at most 128 node slots, a multiple of 8, a
    lane-aligned width that H divides. The kernels take all of it."""
    return N <= 128 and N % 8 == 0 and d % 128 == 0 and d % H == 0


def fused_auto_wins(B: int, N: int) -> bool:
    """Whether ``auto`` takes the fused rung of an eligible batch: from
    FUSED_AUTO_ROWS of B·N on, or as ``GGPS_FUSED_AUTO`` (0 or 1) forces it
    (``fused_auto_wins``, ``fused_gps_attn.py:450``, read per call)."""
    env = os.environ.get("GGPS_FUSED_AUTO")
    if env is not None:
        return env == "1"
    return B * N >= FUSED_AUTO_ROWS


def front_switched_off() -> bool:
    """The JAX package's switch of its merged front, ``GGPS_FUSED_FRONT=0``
    (``fused_front_eligible``, ``fused_layer.py:456``, read per call)."""
    return os.environ.get("GGPS_FUSED_FRONT", "1") == "0"


def tail_eligible(rows: int, d: int, act: str) -> bool:
    """The envelope of the FFN-block kernels (``fused_tail.py:479``
    ``tail_eligible``, behind ``ln_ffn_eligible`` and ``combine_eligible``
    of ``fused_combine.py``): a width of 64 or more, an activation the
    kernels take and a multiple of 8 rows. Its TPU block and mesh
    conditions do not carry over."""
    return d >= MIN_DIM and act in build.ACTS and rows % 8 == 0


def merged_width(dim_h: int) -> bool:
    """The path a width takes by default: the merged front at a multiple of
    128 (``fused_front_eligible``, ``fused_layer.py`` :461)."""
    return dim_h % 128 == 0


def seed_values(gen: torch.Generator, n: int) -> torch.Tensor:
    """``n`` seeds in [0, 2^31) from ``gen`` as int32: one draw of n takes
    what n draws of one would, so a step's seeds drawn at once equal its
    modules' draws in turn."""
    return torch.randint(0, 2 ** 31, (n,), generator=gen).to(torch.int32)


class StepSeeds:
    """A training step's dropout seeds in int32 tensors on the model's
    device, which the kernels read there (``csrc/common.cuh`` ``Drop``): a
    CUDA graph that captures the step replays with whatever seeds the
    tensors hold. Modules take them in turn through :func:`draw_seeds`,
    ``n`` at a time, as a list of 0-d int32 views of a device tensor.

    Eager (``gen``): the seeds are those that draws from the host generator
    in the order and number of the takes give, each view carrying the
    value it holds (``host_value``: the torch-op hash then keys on the
    host, where a device seed costs ~20 one-element launches a site). With
    ``expect`` (the count an earlier step took) the first take draws that
    many at once and copies them to ``device`` in one copy; a take past
    them draws then, and :meth:`settle` (the step's end, or a draw on the
    host) puts the generator where draws take by take would have left it,
    so a seeded run draws the same whatever ``expect`` says. Fixed
    (``table``, an (n,) int32 tensor on the device): the takes are
    consecutive views of ``table`` and draw nothing; a step that takes more
    than it holds raises. ``used`` counts the seeds taken, ``host_draws``
    whether a module drew from the generator itself."""

    def __init__(self, gen: Optional[torch.Generator] = None, device=None,
                 table: Optional[torch.Tensor] = None, expect: int = 0):
        if (gen is None) == (table is None):
            raise ValueError("StepSeeds: give a generator or a seed table")
        self.gen, self.device, self.table = gen, device, table
        self.expect = expect
        self.used = 0
        self.host_draws = False
        self._ahead = self._start = None

    def take(self, n: int) -> list:
        if self.table is not None:
            if self.used + n > self.table.numel():
                raise RuntimeError(
                    f"the step takes more than the {self.table.numel()} "
                    "dropout seeds of its table")
            out = self.table[self.used:self.used + n].unbind(0)
        else:
            if self.used == 0 and self.expect and not self.host_draws:
                self._start = self.gen.get_state()
                self._ahead = _on_device(seed_values(self.gen, self.expect),
                                         self.device)
            if self._ahead is not None and \
                    self.used + n <= len(self._ahead):
                out = self._ahead[self.used:self.used + n]
            else:
                self.settle()
                out = _on_device(seed_values(self.gen, n), self.device)
        self.used += n
        return list(out)

    def settle(self) -> None:
        """Drop the seeds drawn ahead, the generator set to where draws take
        by take leave it after the ``used`` seeds."""
        if self._ahead is not None:
            if self.used != len(self._ahead):
                self.gen.set_state(self._start)
                seed_values(self.gen, self.used)
            self._ahead = self._start = None

    def host_generator(self) -> torch.Generator:
        """The host generator, for draws that stay on the host (LapPE's sign
        flips); a fixed table has none."""
        if self.gen is None:
            raise RuntimeError("a step on a fixed seed table draws nothing on "
                               "the host")
        self.settle()
        self.host_draws = True
        return self.gen


def draw_seeds(gen, n: int) -> list:
    """``n`` dropout seeds as 0-d int32 tensors: from a training step's
    :class:`StepSeeds`, views of a tensor on the model's device; from a host
    generator (a direct call of a model in training mode), on the host,
    which the kernels' plain versions take."""
    if gen is None:
        raise ValueError("training with dropout needs a dropout generator")
    if isinstance(gen, StepSeeds):
        return gen.take(n)
    return _on_device(seed_values(gen, n), "cpu")


def _on_device(host: torch.Tensor, device) -> list:
    """The 0-d views of ``host`` (int32 seeds drawn on the host) copied to
    ``device`` in one copy, each carrying the value it holds
    (``host_value``, which the torch-op hash keys on)."""
    out = list(host.to(device, non_blocking=True).unbind(0))
    for t, v in zip(out, host.tolist()):
        t.host_value = v
    return out


class GPSLayer(nn.Module):
    def __init__(self, dim_h: int, num_heads: int, act: str = "relu",
                 eps: float = 1e-5, dropout: float = 0.0,
                 attn_dropout: float = 0.0, local: str = "CustomGatedGCN",
                 batch_norm: bool = True, attn_impl: str = "auto",
                 global_type: str = "Transformer",
                 bigbird: Optional[dict] = None, layer_index: int = 0):
        """A CustomGatedGCN layer at a multiple of 128 takes the merged
        front per batch wherever JAX does (:meth:`takes_merged`); its weight
        layout follows the width alone. A ``local="GCN"`` or ``"GINE"``
        layer takes the plain local path, with its three norms
        MaskedBatchNorms under ``batch_norm`` and the identity otherwise (a
        CustomGatedGCN layer always has BatchNorm). ``attn_impl`` is
        ``gt.attn_impl`` (ATTN_IMPLS). ``global_type`` BigBird takes ``bigbird``'s
        ``attention_type``, ``block_size`` and ``num_random_blocks``
        (``gt.bigbird``) and draws its plan from the seed ``layer_index``,
        as JAX's layer does."""
        super().__init__()
        if dim_h % num_heads:
            raise ValueError(f"dim_h={dim_h} is not divisible by "
                             f"num_heads={num_heads}")
        if dim_h < MIN_DIM and local != "GINE":
            raise NotImplementedError(
                f"dim_h={dim_h} < {MIN_DIM}: the layer's path without fused "
                "kernels is not ported (ROADMAP Queue 1 item 5)")
        if local not in LOCAL_TYPES:
            raise NotImplementedError(
                f"local GNN {local!r}: the port has {LOCAL_TYPES} (ROADMAP "
                "Queue 1 item 13)")
        if attn_impl not in ATTN_IMPLS:
            raise NotImplementedError(
                f"gt.attn_impl={attn_impl!r}: the port's GPSLayer takes "
                f"{ATTN_IMPLS}")
        if global_type not in GLOBAL_TYPES:
            raise NotImplementedError(
                f"global model {global_type!r}: the port's GPSLayer takes "
                f"{GLOBAL_TYPES} (ROADMAP Queue 1 item 15)")
        bigbird = dict(bigbird or {})
        self.bigbird_type = bigbird.get("attention_type", "block_sparse")
        if global_type == "BigBird" and self.bigbird_type not in \
                ATTENTION_TYPES:
            raise ValueError(f"unknown bigbird attention_type "
                             f"{self.bigbird_type!r}")
        self.bigbird_block = int(bigbird.get("block_size", 3))
        self.bigbird_random = int(bigbird.get("num_random_blocks", 3))
        self.global_type = global_type
        self.layer_index = layer_index
        self.dim_h = dim_h
        self.num_heads = num_heads
        self.act = act
        self.eps = eps
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.attn_impl = attn_impl
        self.plain_local = local in PLAIN_LOCAL
        # the joint front weight, held at a multiple of 128 on either path
        self.holds_front = not self.plain_local and merged_width(dim_h)
        if self.holds_front:
            # A, D, E, B, Wq, Wk, Wv side by side, each drawn as a (d, d) Dense
            ws, bs = zip(*(dense_params(dim_h, dim_h) for _ in range(7)))
            self.w_front = nn.Parameter(torch.cat(ws, dim=1).detach())
            self.b_front = nn.Parameter(torch.cat(bs).detach())
        else:
            ws, bs = zip(*(dense_params(dim_h, dim_h) for _ in range(3)))
            self.w_qkv = nn.Parameter(torch.cat(ws, dim=1).detach())
            self.b_qkv = nn.Parameter(torch.cat(bs).detach())
        bn = batch_norm or not self.plain_local
        if self.plain_local:
            self.local = (GCNLayer(dim_h) if local == "GCN"
                          else GINELayer(dim_h, act))
            self.norm_local = MaskedBatchNorm(dim_h, eps) if bn else None
        else:
            self.local = GatedGCNLayer(dim_h, act, eps,
                                       own_node_proj=not self.holds_front)
        self.w_out, self.b_out = dense_params(dim_h, dim_h)
        self.norm_attn = (MaskedBatchNorm(dim_h, eps,
                                          stats_only=not self.plain_local)
                          if bn else None)
        self.w_ffn1, self.b_ffn1 = dense_params(dim_h, 2 * dim_h)
        self.w_ffn2, self.b_ffn2 = dense_params(2 * dim_h, dim_h)
        self.norm_out = MaskedBatchNorm(dim_h, eps) if bn else None

    @property
    def rates(self):
        """(dropout, attn_dropout) in force: both 0 in evaluation."""
        if not self.training:
            return 0.0, 0.0
        return self.dropout, self.attn_dropout

    @property
    def defer(self) -> bool:
        """Whether the unmerged path defers its tails into the combine+FFN
        kernel (``want_defer``, JAX :144-148, and ``use_ft``,
        ``local_gnn.py`` :262-270)."""
        return self.dim_h % 128 == 0 or self.rates[0] > 0.0

    def takes_merged(self, batch: GraphBatch) -> bool:
        """Whether this batch takes the merged front (JAX :156-172): a
        layer that holds the joint front weight, at most MERGED_MAX_NODES
        node slots, ``attn_impl`` auto or fused, and ``GGPS_FUSED_FRONT``
        not 0."""
        return (self.holds_front and batch.max_nodes <= MERGED_MAX_NODES
                and self.global_type == "Transformer"
                and self.attn_impl in ("auto", "fused")
                and not front_switched_off())

    def node_proj(self):
        """The GatedGCN's ``[A|D|E|B]`` (d, 4d) weight and (4d,) bias of the
        unmerged path: the local layer's own, or at a multiple of 128 a
        contiguous copy of the joint front weight's first 4d columns."""
        if not self.holds_front:
            return self.local.w_node, self.local.b_node
        d = self.dim_h
        return self.w_front[:, :4 * d].contiguous(), self.b_front[:4 * d]

    def qkv_proj(self):
        """``[Wq|Wk|Wv]`` (d, 3d) and its (3d,) bias, as :meth:`node_proj`
        (the joint weight's last 3d columns at a multiple of 128)."""
        if not self.holds_front:
            return self.w_qkv, self.b_qkv
        d = self.dim_h
        return self.w_front[:, 4 * d:].contiguous(), self.b_front[4 * d:]

    def takes_fused(self, B: int, N: int) -> bool:
        """Whether the Transformer branch takes ``fused_gps_attention``
        (JAX :280-294): ``attn_impl`` auto or fused, within
        :func:`fused_eligible`, and under auto from :func:`fused_auto_wins`
        on. fused outside the envelope raises JAX's ValueError."""
        if (self.attn_impl not in ("auto", "fused")
                or self.global_type != "Transformer"):
            return False
        ok = fused_eligible(N, self.dim_h, self.num_heads)
        if self.attn_impl == "fused" and not ok:
            raise ValueError(
                "gt.attn_impl='fused' needs Transformer global attention + "
                f"N≤128, lane-aligned dims (got N={N}, d={self.dim_h}, "
                "log_attn_weights=False)")
        return ok and (self.attn_impl == "fused" or fused_auto_wins(B, N))

    def front_pack(self, seed: int = 0) -> FrontPack:
        drop, attn = self.rates
        return FrontPack(w_front=self.w_front, b_front=self.b_front,
                         w_out=self.w_out, b_out=self.b_out,
                         ca=self.norm_attn.running_mean, H=self.num_heads,
                         scale=1.0 / float(self.dim_h // self.num_heads) ** 0.5,
                         seed=seed, attn_rate=attn, drop_rate=drop)

    def combine_args(self, x_tail: tuple, s_attn, seed: int = 0,
                     moments=None, mask=None) -> tuple:
        """The arguments of :func:`fused_combine_ffn`, from the local
        layer's x-tail arguments and the attention branch's ``s_attn``; the
        attention norm's statistics from the front's ``moments`` or, with
        ``mask``, from ``s_attn`` itself."""
        mu_a, var_a, ga_a, be_a = self.norm_attn(s_attn, mask, moments)
        return (*x_tail, s_attn, mu_a, torch.rsqrt(var_a + self.eps), ga_a,
                be_a, self.w_ffn1, self.b_ffn1, self.w_ffn2, self.b_ffn2, seed,
                self.rates[0], self.act)

    def attention(self, batch: GraphBatch, x, seed: int = 0):
        """The Transformer branch of the unmerged and plain local paths up to
        the out-projection: (B*N, d), on JAX's rungs in JAX's order (module
        docstring): ``fused_gps_attention`` where :meth:`takes_fused`, under
        auto ``fused_wide_attention`` for graphs of more than WIDE_MIN_NODES
        and at most WIDE_MAX_NODES node slots, else the ``mha`` dispatch
        (dense, chunked or flash)."""
        d, H = self.dim_h, self.num_heads
        B, N = batch.num_graphs, batch.max_nodes
        rate = self.rates[1]
        w_qkv, b_qkv = self.qkv_proj()
        xd = batch.dense_view(x)
        if self.global_type == "BigBird":
            return self.bigbird_branch(batch, xd, w_qkv, b_qkv, seed)
        if self.takes_fused(B, N):
            return fused_gps_attention(
                xd, batch.front_index[3], w_qkv, b_qkv, self.w_out,
                self.b_out, seed, H, rate).reshape(-1, d)
        if (self.attn_impl == "auto"
                and WIDE_MIN_NODES < N <= WIDE_MAX_NODES):
            return fused_wide_attention(
                xd, batch.counts, w_qkv, b_qkv, self.w_out, self.b_out, seed,
                H, 1.0 / float(d // H) ** 0.5, rate).reshape(-1, d)
        qkv = xd @ w_qkv + b_qkv
        q, k, v = (split_heads(qkv[..., i * d:(i + 1) * d], H)
                   for i in range(3))
        o = mha_dispatch(q, k, v, batch.dense_view(batch.node_mask), seed,
                         rate, impl=self.attn_impl)
        return merge_heads(o).reshape(-1, d) @ self.w_out + self.b_out

    def bigbird_branch(self, batch: GraphBatch, xd, w_qkv, b_qkv, seed: int):
        """The BigBird global branch up to the out-projection (JAX
        :428-445): ``original_full`` is the dense masked attention
        (``mha``), ``block_sparse`` the ``bigbird_attention`` dispatch (the
        block-sparse kernel on the card without attention dropout from
        ``GGPS_SPLASH_MIN_N`` node slots, the dense path with the plan's
        bias otherwise), with the plan of seed ``layer_index``."""
        d, H = self.dim_h, self.num_heads
        rate = self.rates[1]
        qkv = xd @ w_qkv + b_qkv
        q, k, v = (split_heads(qkv[..., i * d:(i + 1) * d], H)
                   for i in range(3))
        key_mask = batch.dense_view(batch.node_mask)
        if self.bigbird_type == "original_full":
            from ..ops.kernels.common import apply_dropout

            drop = None
            if rate > 0.0:
                drop = lambda p: apply_dropout(p, seed, 0, rate)  # noqa: E731
            o = mha(q, k, v, key_mask, drop)
        else:
            o = bigbird_attention(q, k, v, key_mask, self.bigbird_block,
                                  self.bigbird_random, self.layer_index, rate,
                                  seed)
        return merge_heads(o).reshape(-1, d) @ self.w_out + self.b_out

    def forward_merged(self, batch: GraphBatch, x, e, gen):
        seeds = [0] * SEEDS_PER_LAYER
        if any(self.rates):
            seeds = draw_seeds(gen, SEEDS_PER_LAYER)
        front = self.front_pack(seeds[0])
        x_tail, s_attn, e, pa = self.local(batch, x, e, front, seeds[1])
        mom_a = None
        if self.training:
            d = self.dim_h
            mom_a = (pa[0, :d], pa[0, d:], batch.real_counts[0], front.ca)
        return fused_combine_ffn(*self.combine_args(x_tail, s_attn, seeds[2],
                                                    mom_a)), e

    def forward_unmerged(self, batch: GraphBatch, x, e, gen):
        # seeds: edge tail, attention, drop-add, combine+FFN
        seeds = [0] * SEEDS_PER_LAYER_UNMERGED
        if any(self.rates):
            seeds = draw_seeds(gen, SEEDS_PER_LAYER_UNMERGED)
        rate = self.rates[0]
        defer = self.defer
        local, e = self.local.unmerged(batch, x, e, defer, seeds[0], rate,
                                       self.node_proj())
        h_attn = self.attention(batch, x, seeds[1])
        if rate > 0.0:
            s_attn = fused_drop_add(x, h_attn, seeds[2], rate)
        else:
            s_attn = x + h_attn
        if defer:
            return fused_combine_ffn(*self.combine_args(
                local, s_attn, seeds[3], mask=batch.node_mask)), e
        return self.ffn(local + self.norm_attn.normalize(
            s_attn, batch.node_mask)), e

    def ffn(self, h, seed: int = 0):
        """``h + FFN(h)``: ``fused_ffn`` where the JAX layer takes
        ``fused_ffn_padded`` (:497-511: the tail envelope, and a width that
        is a multiple of 128 or training with dropout), else plain PyTorch
        (:512-518) with flax ``nn.Dropout``'s exact rate on the hidden units
        and the output (sites 0 and 1 of ``seed``), which drops only below
        the envelope's width of 64: every width from 64 with a multiple of
        8 rows is in it."""
        rate = self.rates[0]
        if (tail_eligible(h.shape[0], self.dim_h, self.act)
                and (self.dim_h % 128 == 0 or rate > 0.0)):
            return fused_ffn(h, self.w_ffn1, self.b_ffn1, self.w_ffn2,
                             self.b_ffn2, seed, rate, self.act)
        h2 = get_act(self.act)(h @ self.w_ffn1 + self.b_ffn1)
        h2 = exact_dropout(h2, seed, 0, rate) @ self.w_ffn2 + self.b_ffn2
        return h + exact_dropout(h2, seed, 1, rate)

    def branch_sum(self, batch: GraphBatch, x, e, seeds):
        """The plain local path up to the FFN: ``norm(x + drop(local(x))) +
        norm(x + drop(attention(x)))`` and e, from the first three of the
        layer's ``seeds`` (local drop-add, attention, attention drop-add).
        The drop-add is ``fused_drop_add`` in the tail envelope (JAX's
        ``_drop_add``), flax ``nn.Dropout``'s exact rate below it."""
        rate, mask = self.rates[0], batch.node_mask
        fused = tail_eligible(x.shape[0], self.dim_h, "identity")

        def tail(norm, v, seed):
            if rate > 0.0 and fused:
                s = fused_drop_add(x, v, seed, rate)
            else:
                s = x + exact_dropout(v, seed, 0, rate)
            return s if norm is None else norm(s, mask)

        h_local, e = self.local(batch, x, e)
        h = tail(self.norm_local, h_local, seeds[0])
        return h + tail(self.norm_attn, self.attention(batch, x, seeds[1]),
                        seeds[2]), e

    def forward_plain_local(self, batch: GraphBatch, x, e, gen):
        # seeds: local drop-add, attention, attention drop-add, FFN
        seeds = [0] * SEEDS_PER_LAYER_UNMERGED
        if any(self.rates):
            seeds = draw_seeds(gen, SEEDS_PER_LAYER_UNMERGED)
        h, e = self.branch_sum(batch, x, e, seeds)
        return self.ffn(h, seeds[3]), e

    def forward(self, batch: GraphBatch, x, e,
                gen: Optional[torch.Generator] = None):
        """``gen`` draws the layer's dropout seeds in training."""
        if self.plain_local:
            h, e = self.forward_plain_local(batch, x, e, gen)
        elif self.takes_merged(batch):
            h, e = self.forward_merged(batch, x, e, gen)
        else:
            h, e = self.forward_unmerged(batch, x, e, gen)
        if self.norm_out is not None:
            h = self.norm_out(h, batch.node_mask)
        # zero padded slots so they never leak into aggregations
        h = torch.where(batch.node_mask[:, None], h, 0.0)
        return h, e
