#!/usr/bin/env python3
"""Smoke test of graphgps_torch on one NVIDIA GPU (H100, sm_90a).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and fails (non-zero exit, no result line) without
one. Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from ``graphgps_torch/csrc`` (one
   ``nvcc`` per source, all at once), and find tensor-core instructions
   (HMMA) in the SASS of every kernel of the attention body in the
   ``flash_mha``, ``wide_attention``, ``gps_attention`` and ``gps_front``
   libraries, of every kernel of the tensor-core GEMM in the last two,
   ``combine_ffn``, ``gatedgcn``, ``ln_ffn`` and ``bn_ffn``, and of
   ``bn_ffn``'s two fused kernels, and f64 tensor-core instructions (DMMA)
   in every instance of ``flash_mha``'s forward kernel;
3. hold each forward kernel of the merged layer path against its plain
   PyTorch version on the card, on the inputs layer 0 of the first main path
   gives it (PCQM4Mv2 GPS-deep: batch 256, d=256, 8 heads, seeded weights,
   non-trivial BatchNorm statistics), and time both, ``pre_tail`` also with
   the L2 cache flushed before each call (``cold_ms``); before them, the
   card's launch floor (the device ms of a one-element ``Tensor.add_``) on a
   line of its own; after them ``gatedgcn`` and ``drop_add`` forward and
   backward at GPS-deep's layer with the front off (G');
3b. with dropout 0.1 on every site, run each of the three functions forward
   and backward through the kernels and through autograd of the plain
   versions on the same inputs; hold each backward kernel against the plain
   gradients, check that two runs give the same bits and that every site
   keeps 230/256 of its units, and time both (``pre_tail``'s backward also
   L2-cold);
3c. the kernels of the unmerged layer path (``gatedgcn``, ``drop_add``, and
   ``pre_tail`` and ``combine_ffn`` at their second widths), forward and
   backward as in 3 and 3b with dropout 0.05, on layer 0's inputs of the
   second main path (ogbg-molhiv GPS: batch 32, d=64, 4 heads) and at batch
   256, d=304, 4 heads (``pcqm4m-GPS+RWSE.yaml``), ``drop_add`` also L2-cold
   at ogbg-molhiv's; the attention dropout's mask keeps 128/256 at rate 0.5;
3d. the kernels of the long-graph rung of the unmerged path, ``edge_gate``
   and ``wide_attention``, forward and backward, on layer 0's inputs of the
   third main path (VOC superpixels GPS: batch 32, 512 node slots and 1,024
   edge slots per graph, d=96, 4 heads; attention dropout 0.5 and 0), and
   the edge gate also at 3,072 edge slots per graph (the real data's edge
   count), on a batch with a hub receiver (a third of a graph's edges into
   one node), a graph with no real edge and stray endpoints, and on graphs
   of 1,024 node slots, all on seeded random inputs, every edge-gate call
   over its batch's edge orders built beforehand (one launch of the plan
   kernel ``segment_plan``, held against its plain version and timed
   beside ``torch.argsort``); the attention mask keeps 128/256 at 0.5;
   ``F.multi_head_attention_forward``, the one PyTorch call that computes
   the wide attention's function, is held against the kernel at rate 0 and
   timed forward and backward as those rows' ``library_ms``; the wide
   attention's device time is split between its attention body and its
   projections by a profile; and the wide attention again on a seeded
   batch in which one graph has no real node (counts 0: uniform weights);
3e. the Graphormer MLP block's kernel, ``ln_ffn``, forward and backward, on
   layer 0's inputs of the fourth main path (ZINC Graphormer: batch 256, 41
   rows per graph with the token, d=80) at dropout 0.1/0.1, at the recipe's
   training rates 0.1/0 and at 0/0, within rtol 1e-5 and atol 1e-5 of each
   tensor's largest entry, with bit-identical backward reruns and each
   site's kept fraction on the u8 grid;
3f. SAN's attention-norm apply + FFN kernel, ``bn_ffn``, forward and
   backward, on layer 0's inputs of the fifth main path in training
   (ogbg-molhiv SAN: batch 64, 40 node slots a graph, R = 2,560, d=64; the
   attention block's residual sum and its batch statistics) at the recipe's
   rate 0.01 and at 0, and at the molpcba-SAN width on seeded inputs (batch
   512 x 40 slots, R = 20,480, d=304) at rate 0.2, within rtol 1e-5 and
   atol 1e-5 of each tensor's largest entry, with bit-identical backward
   reruns, each kept fraction on the u8 grid, and relu's derivative in the
   plain backward on the kernel's side of each kink (a unit that the two
   computations' rounding puts on different sides must lie within rounding
   of 0); each row names its route (``fused``: one launch forward, two
   backward; ``sequence``: the launch sequence over the tensor-core GEMM);
   no single PyTorch call computes the norm apply and the FFN, so
   these rows have no ``library_ms``;
3g. the GPS FFN block's kernel, ``ffn``, forward and backward, on layer
   0's inputs of the sixth main path in training (wn-squirrel
   GCN+Transformer: one graph of 5,201 nodes in 5,248 node slots, d=96; the
   branch sum of its GCN and attention branches at the recipe's dropout) at
   the recipe's rate 0.2 and at 0, with gelu (the recipe's) and relu, at
   the actor width on seeded inputs (R = 7,680, d=64) at 0.2, and at d=304
   on seeded inputs (R = 20,480) at 0.2, within rtol 1e-5 and atol 1e-5 of
   each tensor's largest entry, with bit-identical backward reruns, each
   kept fraction on the u8 grid, and relu's derivative in the plain
   versions on the kernel's side of each kink; each row names its route
   (``fused``: one launch forward, two backward, at d=96 and 64;
   ``sequence``: the launch sequence over the tensor-core GEMM, at d=304);
   no single PyTorch call computes the FFN block, so these rows have no
   ``library_ms``; and ``drop_add`` forward and backward on the attention
   branch of the same layer (Q: 5,248 rows of 96) at the recipe's rate;
3h. the GPS layer's fused attention rung, ``gps_attention``, forward and
   backward, on layer 0's inputs of the first main path (GPS-deep: batch
   256, 40 node slots, d=256, 8 heads) at the recipe's attention dropout
   0.1 and at 0, at the pcqm4m-GPS width (d=304, 4 heads, rate 0.5) and at
   the edge of JAX's envelope (64 graphs of 128 node slots, d=256, 4 heads
   of 64, rate 0.1) on seeded inputs, at 3d's attention tolerances, with bit-identical backward
   reruns and the mask's kept fraction on the u8 grid;
   ``F.multi_head_attention_forward`` with the padded keys' mask is held
   against the kernel at rate 0 and timed as ``library_ms``;
3i. the flash attention, ``flash_mha``, forward and backward, on layer 0's
   q, k, v of the third main path (VOC superpixels: batch 32, 512 node
   slots, 400-500 real, 4 heads of 24) without a bias and with a seeded
   one, at wn-squirrel's one graph (5,248 slots, 5,201 real), and at heads
   of 20 columns and at 520 slots with a bias, all three on seeded inputs;
   every forward output entry within FLASH_F64_ULPS f32 ulp of the plain
   version evaluated in f64 and rounded to f32 (the forward computes in
   f64 and rounds once);
   ``F.scaled_dot_product_attention`` with the same-segment mask
   (and the bias folded into a float mask) is held against the kernel and
   timed as ``library_ms``;
3j. the segment sums, ``segment_csr`` and ``segment_tiled`` (one kernel
   behind two wrappers, forward only: their backward is a gather), each on
   its id vector's plan built beforehand, on layer 0's GCN messages of the
   sixth main path (wn-squirrel: 5,248 node slots, its edge slots, d=96)
   into the receivers, the tiled one also on a cotangent into the senders
   (the gather's backward), then on seeded inputs with hub segments (a
   power law over the same 5,248 segments), with every edge in one segment,
   and at MalNet's size (E 313,000, S 80,000, d 64) uniform and with hubs,
   within rtol 1e-5 and atol 1e-5 of each tensor's largest entry, with
   bit-identical reruns; each row also times the plan, a call with the plan
   shared by a step's three calls, and the kernel and ``index_add`` with
   the L2 cache flushed before each call; ``Tensor.index_add``, the one
   PyTorch call for the same function, is held against the kernel and
   timed as ``library_ms``; the plan kernel, ``segment_plan``, is held
   against its plain version on every plan and timed on the receivers'
   (``torch.searchsorted`` of the segment bounds as its ``library_ms``);
3k. BigBird's block-sparse attention, ``bigbird``, forward and backward, at
   wn-squirrel's one graph (5,248 slots, 5,201 real, 4 heads of 24, block
   3, 3 random blocks, the plans of its three layers) and at 4 graphs of
   2,048 slots (1,900-2,048 real) on seeded inputs, at 3d's attention
   tolerances with bit-identical backward reruns;
   ``F.scaled_dot_product_attention`` with the boolean mask of allowed
   pairs is held against the kernel and timed as ``library_ms``;
4. per main path (GPS-deep 16x256 at batch 256, ogbg-molhiv 10x64 at batch
   32, VOC superpixels 4x96 at batch 32 on graphs of 400-500 nodes, ZINC
   Graphormer 12x80 with 8 heads and the graph token at batch 256,
   ogbg-molhiv SAN 10x64 with 4 heads, LapPE's Transformer and the plateau
   scheduler at batch 64, wn-squirrel GCN+Transformer 3x96 with 4 heads on
   its one transductive graph, the chunked attention and the split masks,
   then GPS-deep with the JAX package's switch ``GGPS_FUSED_FRONT=0`` (the
   unmerged path at d=256 and the fused attention rung, cut to
   FRONT_OFF_LAYERS layers) and VOC
   superpixels under ``gt.attn_impl flash`` (training at attention dropout
   0, which flash requires), then wn-squirrel under the JAX package's
   switches ``GGPS_TILED_SEGMENT=1`` and ``GGPS_USE_CSR_KERNEL=1`` and as
   ``gt.layer_type GCN+BigBird`` (training at attention dropout 0, which
   the block-sparse kernel requires), these three over
   SWITCH_RATE_BATCHES batches a pass), each with every launch count set to
   0 just before a run and read just after:
   a. the port's entry point ``graphgps_torch.driver.main`` in ``train.mode
      inference-only``: the launches per batch the path implies;
   b. the entry point in ``train.mode custom`` (3 epochs, warm-up 1,
      checkpoints on): one stats line per epoch and split (val and test at
      the evaluated epochs: every ``eval_period`` and the last) with finite
      losses (``auc`` on ogbg-molhiv, ``f1`` on VOC, ``accuracy`` on
      wn-squirrel, ``mae`` otherwise), the launches per layer
      and training step (forward ones
      also per evaluated batch where evaluation runs them; the edge tail's
      backward in all layers but the last, whose edge output does not reach
      the loss), and the best epoch's checkpoint reloads into a fresh model
      with the same selection metric (and, under ``reduce_on_plateau``, the
      scheduler's state of that epoch);
   c. one training step on the card and on the CPU (the plain path) from the
      same weights (calibrated BatchNorm statistics; the Graphormer and
      wn-squirrel have none), batch and dropout seeds: loss, every
      gradient, the updated running statistics and the updated parameters;
      where a gradient is outside the tolerance, the same step in float64
      on the CPU is the reference of a gradient behind an ill-conditioned
      norm;
   d. one batch's predictions (logits) against the same model on the CPU
      with calibrated BatchNorm statistics; the inference rate in graphs/s
      over full batches, then a profile of the loop's first PROFILE_BATCHES
      batches for the device time by CUDA kernel and the device's idle
      share;
   e. the same for training steps (forward, backward, clipping, adamW),
      with the peak device memory (on wn-squirrel, whose epoch is one step,
      over SQUIRREL_RATE_BATCHES repeats of its one batch);
   and after each of the last five paths, one model's evaluation
   predictions on one val batch on both sides of its switch (merged front
   vs the fused rung; auto's wide attention vs flash; index_add vs the
   tiled and the CSR kernel; the block-sparse kernel vs BigBird's dense
   path with ``GGPS_SPLASH_MIN_N`` raised; on the real nodes), with each
   side's launches;
5. K training steps per dispatch (``train.steps_per_dispatch``), on the card
   replays of one captured CUDA graph of the training step, for GPS-deep on
   the merged path (16x256, batch 256, dropout 0.1 / 0.1, K = 3) and
   ogbg-molhiv (10x64, batch 32, dropout 0.05 / 0.5: the unmerged kernels
   and the torch-op attention mask, K = 4), K such that the stand-in's
   train split ends in a partial group, from 4's calibrated states:
   a. the entry point in ``train.mode custom`` for 2 epochs: finite stats
      lines, the graph replays (every step but the eager warm-up ones) and
      the launches: the per-step table for the eager steps and the capture,
      none for a replay;
   b. K captured steps against K eager steps on the same batches with the
      same seeds: the loss of every step, every parameter, running
      statistic and Adam moment after them, bit for bit where two eager
      steps from one state are bit-equal (the ``5-eager-bits`` line), else
      within 4c's rules (the line says which held);
   c. one batch replayed with two seed rows gives two different steps,
      each equal to the eager step with its seeds from the same state:
      loss, predictions, and every parameter, running statistic and Adam
      moment after it, by b's rule;
   d. a second group of other graphs, replayed, against its eager steps as
      in b (the batch's views are built inside the captured step);
   e. host ms a step and device ms a step (CUDA events around the
      replays), captured against eager, with the wrapper launches a step,
      the peak memory allocated by each (and the memory reserved with the
      graph's pool) and the eager step's profiled busy ms of 4e;
   the phase's seconds against its budget of KSTEP_BUDGET_S.

A watchdog prints every thread's stack and exits non-zero if the script
runs WATCHDOG_S seconds.

A ``{"phase_done": ...}`` line gives the seconds since the start after each
phase. Each kernel row's ``bound_ms`` is the larger of its bytes at the
HBM rate and its operations at the rate ``bound_rate`` names: the f32 CUDA
cores' 67 TFLOP/s, or for the kernels on the attention body and the
tensor-core GEMM (``wide_attention`` and ``wide_attention_bwd``,
``flash_mha_bwd``, ``gps_front`` and ``gps_front_bwd``, ``gps_attention``
and ``gps_attention_bwd``, ``combine_ffn`` and ``combine_ffn_bwd``,
``gatedgcn`` and ``gatedgcn_bwd``, ``ln_ffn`` and ``ln_ffn_bwd``,
``bn_ffn`` and ``bn_ffn_bwd``: 3xTF32 on the tensor cores) 495 / 3 = 165
TFLOP/s, or for ``flash_mha``'s forward
(f64 on the FP64 tensor cores) 67 TFLOP/s. The line
before the last is ``{"kernels": [...]}`` (the six kernels
of the merged path at GPS-deep's shapes, the four of the unmerged path at
ogbg-molhiv's, the four of the long-graph rung at VOC's, the two of the
Graphormer MLP block at ZINC's, the two of SAN's norm apply + FFN at
ogbg-molhiv SAN's, the two of the GPS FFN block at wn-squirrel's, the two
of the fused attention rung at GPS-deep's, the two of the flash attention
at VOC's, the two segment sums and their plan kernel at wn-squirrel's
aggregation and BigBird's two at wn-squirrel's first layer: twenty-nine;
each row also carries the launch floor); the last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import faulthandler
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

CFG = "configs/GPS/pcqm4m-GPSdeep+RWSE.yaml"
MOLHIV_CFG = "configs/GPS/ogbg-molhiv-GPS+RWSE.yaml"
PCQM_GPS_CFG = "configs/GPS/pcqm4m-GPS+RWSE.yaml"
VOC_CFG = "configs/GPS/vocsuperpixels-GPS.yaml"
ZINC_CFG = "configs/Graphormer/zinc-Graphormer.yaml"
SAN_CFG = "configs/SAN/ogbg-molhiv-SAN.yaml"
SQUIRREL_CFG = "configs/GPS/wn-squirrel-GPS.yaml"
# the transductive stand-in at wn-squirrel's node count: one graph of 5,201
# nodes (5,248 node slots), one batch per split
SQUIRREL_OPTS = ["dataset.synth_num_graphs", "5201"]
# the VOC stand-in at the real data's size: graphs of 400-500 nodes (512 node
# slots), 21 classes; 160 graphs give 4 full training batches of 32 and one
# half-filled batch each for val and test (graphs with no real node)
VOC_OPTS = ["dataset.synth_min_nodes", "400", "dataset.synth_max_nodes", "500",
            "dataset.synth_num_tasks", "21", "dataset.synth_num_graphs", "160"]
# edge slots per graph of the real PascalVOC-SP graphs
VOC_REAL_EDGES = 3072
# the edge gate on graphs wider than the 900 node slots its shared-memory
# kernel took before the edge orders: (graphs, node slots, edge slots)
EDGE_GATE_WIDE_SLOTS = 1024
EDGE_GATE_WIDE = (8, EDGE_GATE_WIDE_SLOTS, 2 * EDGE_GATE_WIDE_SLOTS)
SEED = 0
# launches per layer of each kernel: (per training step, per evaluated
# batch). GPS-deep takes the merged path in training and evaluation; at
# d = 64 ogbg-molhiv takes the unmerged path, whose evaluation runs the
# GatedGCN core alone (plain tails and FFN)
GPSDEEP_LAUNCHES = {
    "gps_front": (1, 1), "pre_tail": (1, 1), "combine_ffn": (1, 1),
    "gps_front_bwd": (1, 0), "pre_tail_bwd": (1, 0), "combine_ffn_bwd": (1, 0)}
MOLHIV_LAUNCHES = {
    "gatedgcn": (1, 1), "gatedgcn_bwd": (1, 0), "drop_add": (1, 0),
    "drop_add_bwd": (1, 0), "pre_tail": (1, 0), "pre_tail_bwd": (1, 0),
    "combine_ffn": (1, 0), "combine_ffn_bwd": (1, 0)}
# VOC takes the long-graph rung: the Linears as torch.matmul, the edge gate,
# plain tails; the wide attention; plain FFN -- in training and evaluation.
# The edge gate's orders: one plan launch per batch (PER_BATCH_KERNELS)
VOC_LAUNCHES = {
    "edge_gate": (1, 1), "edge_gate_bwd": (1, 0), "wide_attention": (1, 1),
    "wide_attention_bwd": (1, 0), "segment_plan": (1, 1)}
# the Graphormer: the MLP block per layer, every other part in PyTorch ops
ZINC_LAUNCHES = {"ln_ffn": (1, 1), "ln_ffn_bwd": (1, 0)}
# SAN: the norm apply + FFN per layer in training only. In evaluation
# (d = 64, no multiple of 128) JAX takes the plain norm and FFN, and so does
# the port: 0 launches per evaluated batch
SAN_LAUNCHES = {"bn_ffn": (1, 0), "bn_ffn_bwd": (1, 0)}
# GPS-deep with the merged front off (GGPS_FUSED_FRONT=0): the unmerged path
# at a multiple of 128, its tails deferred in training and evaluation; the
# fused attention rung (B*N = 10,240 >= 8,192); the drop-add in training
GPSDEEP_UNMERGED_LAUNCHES = {
    "gatedgcn": (1, 1), "gatedgcn_bwd": (1, 0), "pre_tail": (1, 1),
    "pre_tail_bwd": (1, 0), "gps_attention": (1, 1),
    "gps_attention_bwd": (1, 0), "drop_add": (1, 0), "drop_add_bwd": (1, 0),
    "combine_ffn": (1, 1), "combine_ffn_bwd": (1, 0)}
# VOC under gt.attn_impl flash: the long-graph rung's edge gate, and the
# flash attention in place of the wide one
VOC_FLASH_LAUNCHES = {
    "edge_gate": (1, 1), "edge_gate_bwd": (1, 0), "flash_mha": (1, 1),
    "flash_mha_bwd": (1, 0), "segment_plan": (1, 1)}
# the switches of the two paths: the JAX package's merged-front switch, and
# the attention rung (training at attention dropout 0: flash takes none)
FRONT_OFF = ("GGPS_FUSED_FRONT", "0")
# the front-off path's depth: its launches are per layer, and its 4c step
# on the CPU is the deepest of the script after GPS-deep's own
FRONT_OFF_LAYERS = 4
VOC_FLASH_OPTS = ["gt.attn_impl", "flash"]
VOC_FLASH_TRAIN_OPTS = ["gt.attn_dropout", "0.0"]
# wn-squirrel (GCN+Transformer): per layer and training step the FFN once
# and the local and attention drop-adds; in evaluation (d = 96, no dropout)
# JAX's plain FFN and plain adds, so no kernel
SQUIRREL_LAUNCHES = {"ffn": (1, 0), "ffn_bwd": (1, 0), "drop_add": (2, 0),
                     "drop_add_bwd": (2, 0)}
# wn-squirrel under the JAX package's segment switches and as GCN+BigBird:
# the same kernels, and per layer the aggregation's segment sum (the tiled
# rung also the backward of the GCN's gather h[senders]) or the BigBird
# attention (training at attention dropout 0, which the kernel requires)
TILED_ON = ("GGPS_TILED_SEGMENT", "1")
CSR_ON = ("GGPS_USE_CSR_KERNEL", "1")
# the plan kernel runs per batch, not per layer: one per id vector (the
# tiled rung's receivers and, in the backward, senders; the CSR rung's
# receivers; the edge gate's two orders, one joint plan)
SQUIRREL_TILED_LAUNCHES = {**SQUIRREL_LAUNCHES, "segment_tiled": (2, 1),
                           "segment_plan": (2, 1)}
SQUIRREL_CSR_LAUNCHES = {**SQUIRREL_LAUNCHES, "segment_csr": (1, 1),
                         "segment_plan": (1, 1)}
PER_BATCH_KERNELS = ("segment_plan",)
BIGBIRD_OPTS = ["gt.layer_type", "GCN+BigBird"]
BIGBIRD_TRAIN_OPTS = ["gt.attn_dropout", "0.0"]
SQUIRREL_BIGBIRD_LAUNCHES = {**SQUIRREL_LAUNCHES, "bigbird": (1, 1),
                             "bigbird_bwd": (1, 0)}
# rate batches of those three paths: fewer than SQUIRREL_RATE_BATCHES, so
# the script stays inside its time limit
SWITCH_RATE_BATCHES = 1
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and the
# operations' rates by the units that run them: f32 outside the tensor cores
# (most kernels run f32 on CUDA cores); 3xTF32 on the tensor cores, three
# TF32 products for each f32 one, so the TF32 peak over 3, for the attention
# body (csrc/attn_tc.cuh: wide_attention forward and backward, flash_mha's
# backward, gps_attention's and gps_front's attention) and the tensor-core
# GEMM (csrc/gemm_tc.cuh: the products of gps_attention, gps_front,
# combine_ffn, gatedgcn, ln_ffn and the wide shapes of bn_ffn and ffn; the
# fused routes of bn_ffn and ffn, csrc/ffn_fused.cuh, on the same 3xTF32
# mma.sync); f64 on the FP64 tensor cores for
# flash_mha's forward
PEAK_BYTES = 3.35e12
PEAK_F32 = "f32 CUDA cores, 67 TFLOP/s"
PEAK_3XTF32 = "3xTF32 tensor cores, 165 TFLOP/s"
PEAK_F64_TC = "FP64 tensor cores, 67 TFLOP/s"
PEAKS = {PEAK_F32: 67e12, PEAK_3XTF32: 495e12 / 3, PEAK_F64_TC: 67e12}
# the libraries of the 3xTF32 attention body (HMMA in its attn_* kernels)
TENSOR_CORE_SOURCES = ("flash_mha", "wide_attention", "gps_attention",
                       "gps_front")
# the libraries whose products run on the tensor-core GEMM
GEMM_TC_SOURCES = ("gps_attention", "gps_front", "combine_ffn", "gatedgcn",
                   "ln_ffn", "bn_ffn", "ffn")
# kernels with their own tensor-core products (HMMA), by library: the fused
# routes of bn_ffn and ffn (csrc/ffn_fused.cuh)
HMMA_KERNELS = {"bn_ffn": ("bn_ffn_fused_fwd_kernel",
                           "bn_ffn_fused_bwd_kernel"),
                "ffn": ("ffn_fused_fwd_kernel", "ffn_fused_bwd_kernel")}
# the libraries with f64 tensor-core kernels (DMMA), by kernel name
DMMA_KERNELS = {"flash_mha": "flash_fwd_dmma"}
# kernel vs plain version, both f32 on the card: the sums run in another
# order (tiled GEMM vs cuBLAS, per-column loops vs index_add_)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
# the long-graph kernels' forward: atol relative to the tensor's largest
# entry (nd sums ~6 messages per receiver; y sums up to 512 weighted values)
LONG_RTOL, LONG_ATOL = 1e-4, 1e-5
# the library's multi-head attention against the wide attention's kernel at
# rate 0: that the call timed as the rows' yardstick computes their function
# (another algorithm with the library's own summation order)
LIBRARY_RTOL, LIBRARY_ATOL = 1e-4, 1e-4
# the 16-layer model on the card vs on the CPU, f32 on both: with calibrated
# BatchNorm statistics the plain path's f32 and f64 predictions (~0.08)
# differ by ~7e-8 on the CPU, so this leaves two orders of magnitude for
# another summation order through 16 layers
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
# the front's moment sums run over ~6e3 rows: error relative to the sum of
# the terms' magnitudes (f32 sequential sums stay well inside n*eps ≈ 6e-4)
MOMENT_RTOL = 1e-5
# the rates: full batches per timed pass (40 until the sixth path joined
# the script, 20 until the tensor-core GEMM's builds brought the script to
# 989 s of its 1,200 on an H100: halved each time to keep it inside its
# time limit), and timed passes (3 until the FFN and BigBird kernels'
# longer builds and 3g's d=304 case: the script read 976 s before them and
# 1,048 s after on one host)
RATE_BATCHES = 10
RATE_PASSES = 2
# the profiled pass of 4d and 4e runs the rate loop's first batches only:
# the profiler's processing of the whole loop's events (some 40,000 a
# GPS-deep pass) took most of each path's 4e seconds
PROFILE_BATCHES = 3
# phase 3b: dropout on every site, and the seed of the layer-0 calls
DROP_RATE = 0.1
DROP_SEED = 20260
KEEP_REL_TOL = 0.005
# phase 3c: ogbg-molhiv's rates (residual branches, attention probabilities)
UNMERGED_DROP_RATE = 0.05
UNMERGED_ATTN_RATE = 0.5
# phase 3e: (inner, outer) dropout of the MLP block, the recipe's training
# rates (mlp_dropout 0.1, dropout 0) in the kernels line; the tolerance
# (atol relative to each tensor's largest entry): K = 80 products and
# row sums over 10,496 rows in another order than cuBLAS's
LN_FFN_RATES = ((0.1, 0.1), (0.1, 0.0), (0.0, 0.0))
LN_FFN_RTOL, LN_FFN_ATOL = 1e-5, 1e-5
# phase 3f: SAN's norm apply + FFN, the same tolerance (K = 64 or 304 and
# 608 products, column sums over up to 20,480 rows); the molpcba-SAN width
# (configs/SAN/ogbg-molpcba-SAN.yaml: batch 512, d = 304, dropout 0.2) on
# seeded inputs, 40 node slots a graph as the molhiv stand-in's
BN_FFN_RTOL, BN_FFN_ATOL = 1e-5, 1e-5
MOLPCBA_ROWS, MOLPCBA_DIM, MOLPCBA_RATE = 512 * 40, 304, 0.2
# phase 3g: the FFN block at the actor width (configs/GPS/actor-GPS.yaml:
# 7,600 nodes in 7,680 slots, d = 64) and on the launch sequence at d = 304
# (3f's molpcba-SAN rows, past the fused route's 227 KB) on seeded inputs,
# every row read; the wn-squirrel rows take layer 0's inputs. The same
# tolerance as 3e and 3f
FFN_RTOL, FFN_ATOL = 1e-5, 1e-5
ACTOR_ROWS, ACTOR_DIM = 7680, 64
# rate batches of the wn-squirrel recipe: one epoch is one step over the one
# train batch, and a step runs ~20k launches of the chunked attention (5
# until RATE_BATCHES was halved to 10; 3 until phase 5 joined the script:
# each batch cost its 4e ~20 s, the profiled pass's share most of it)
SQUIRREL_RATE_BATCHES = 2
# phase 3h: the fused attention rung at the pcqm4m-GPS+RWSE width (d 304, 4
# heads, attention dropout 0.5) on seeded inputs
PCQM_GPS_DIM, PCQM_GPS_HEADS, PCQM_GPS_ATTN_RATE = 304, 4, 0.5
# and at the edge of JAX's envelope: 64 graphs of 128 node slots (64-128
# real), d = 256 in 4 heads of 64 (two query blocks of the attention body
# per head)
EDGE_GRAPHS, EDGE_SLOTS, EDGE_DIM, EDGE_HEADS = 64, 128, 256, 4
# phase 3i: the flash attention at wn-squirrel's one graph under flash
# (5,248 node slots, 5,201 real), 4 heads of 24, on seeded inputs
SQUIRREL_SLOTS, SQUIRREL_NODES = 5248, 5201
# and on seeded inputs: ((graphs, node slots, head width, a bias), tag)
FLASH_ODD_CASES = (((16, 512, 20, False), "heads of 20"),
                   ((16, 520, 24, True), "520 slots, a bias"))
# the forward runs in f64 and rounds once: every entry of its output within
# this many f32 ulps of the plain version evaluated in f64 and rounded to
# f32 (the two f64 results differ by f64 rounding, which can move a value
# lying at an f32 rounding boundary by one ulp)
FLASH_F64_ULPS = 1
# phase 3j: the segment sums (rtol, atol x each tensor's largest entry:
# the same adds as index_add_ in another order -- the kernel adds four rows
# at a time and a hub's pieces in order, index_add_ in its atomics' order),
# on hub-skewed cases at wn-squirrel's size and at MalNet's (ogbg
# MalNet-Tiny's cut: E 313,000, S 80,000 = 625 x 128, d 64), and with every
# edge in one segment, on seeded inputs; the calls that share one plan in a
# wn-squirrel step (its three layers' aggregations, or gather backwards);
# the bytes written between L2-cold calls (more than the 50 MB L2)
SEGMENT_RTOL, SEGMENT_ATOL = 1e-5, 1e-5
SKEW_EDGES = 41600
MALNET_EDGES, MALNET_NODES, MALNET_DIM = 313000, 80000, 64
SEGMENT_CALLS_PER_PLAN = 3
L2_FLUSH_BYTES = 64 << 20
# phase 3k: BigBird at wn-squirrel's graph (block 3, 3 random blocks, the
# plans of layers 0-2) and at 4 graphs of 2,048 slots (1,900-2,048 real)
BIGBIRD_BLOCK, BIGBIRD_RANDOM, BIGBIRD_SEEDS = 3, 3, (0, 1, 2)
BIGBIRD_GRAPHS, BIGBIRD_SLOTS, BIGBIRD_MIN_REAL = 4, 2048, 1900
# a relu unit whose side of the kink the kernel's and the plain version's
# rounding part lies within this much of the pre-activations' largest
# entry from 0 (f32 sums of 64 to 304 products)
KINK_RTOL = 1e-5
# a backward kernel vs autograd of its plain version: another summation
# order, and a gradient entry is a sum over rows (or 7d products) that
# cancel, so its f32 rounding follows the tensor's largest entries
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
# phase 4b: epochs of the training run through the entry point
TRAIN_EPOCHS = 3

# phase 5: (path, config, K, launches per layer); K the smallest from 3 up
# that leaves a partial group (GPS-deep's stand-in has 4 train batches,
# ogbg-molhiv's 30)
KSTEP_PATHS = (("pcqm4m-GPSdeep", CFG, 3, GPSDEEP_LAUNCHES),
               ("ogbg-molhiv", MOLHIV_CFG, 4, MOLHIV_LAUNCHES))
KSTEP_EPOCHS = 2
# captured and eager steps timed in 5e
KSTEP_TIMED = 10
KSTEP_BUDGET_S = 90
# the script's watchdog: under the 1,200 s the script is given
WATCHDOG_S = 1140
# each path's 4e training rate, for 5e
TRAIN_RATES = {}
# phase 4c: one training step, card vs CPU. Gradients: 10 or 16 layers of f32
# forward and backward in two summation orders (tiled GEMM and fixed-order
# column sums on the card, MKL on the CPU); the atol is relative to each
# tensor's own largest entry (gradients are small, so no floor of 1; see
# check_train_step for tensors of pure rounding noise). Measured on an H100:
# 4.3e-7 of the worst tensor's scale (PERF.md). Running statistics and loss
# as the model's predictions. Updated parameters: see check_train_step.
STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-4, 1e-4
# 4c also runs in float64 on the CPU. A gradient that passes back through an
# ill-conditioned norm and is outside the tolerance above passes when it is
# within this much of its scale of the f64 gradient. Measured on an H100 over
# six batches of the VOC stand-in (tools/torch_step_precision.py): the card's
# f32 step 2.6e-3 to 7.4e-3 from f64, the CPU's 2.2e-3 to 1.04e-2, the card's
# through the plain versions 2.1e-3 to 1.04e-2, f64 on the card 7e-8 or less
# (PERF.md). The head's gradients pass back through no norm and stay under
# the tolerance above alone.
F64_GRAD_TOL = 2e-2
NO_NORM_BEHIND = ("head.",)
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5


def check_tensor_cores(build) -> None:
    """Every kernel of the attention body (``attn_*``, csrc/attn_tc.cuh) in
    the libraries of TENSOR_CORE_SOURCES, and every kernel of the
    tensor-core GEMM (``gemm_tc_kernel``, csrc/gemm_tc.cuh) in those of
    GEMM_TC_SOURCES, and every kernel HMMA_KERNELS names, holds tensor-core
    products: HMMA in ``cuobjdump -sass``; every kernel named in
    DMMA_KERNELS holds f64 tensor-core
    products, DMMA. Prints the counts (and the attention kernels' SHFL
    count: a quad's row max and sum, no shuffle-broadcast loop) per library;
    fails on such a kernel without them, or on a library without the
    kernels its list names."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    names = dict.fromkeys(TENSOR_CORE_SOURCES + GEMM_TC_SOURCES
                          + tuple(DMMA_KERNELS) + tuple(HMMA_KERNELS))
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass", str(build._lib_path(name))],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if line.strip().startswith("Function :"):
                fn = line.split(":", 1)[1].strip()
                counts[fn] = dict(HMMA=0, DMMA=0, SHFL=0)
            elif fn is not None:
                for op in counts[fn]:
                    counts[fn][op] += op in line
        attn = {f: c for f, c in counts.items() if "attn_" in f}
        gemm = {f: c for f, c in counts.items() if "gemm_tc_kernel" in f}
        own = {f: c for f, c in counts.items()
               if any(k in f for k in HMMA_KERNELS.get(name, ()))}
        dmma = {f: c for f, c in counts.items()
                if name in DMMA_KERNELS and DMMA_KERNELS[name] in f}
        tc_kernels = {**attn, **gemm, **own}
        print(json.dumps(dict(
            sass=name, attention_kernels=len(attn), gemm_tc_kernels=len(gemm),
            fused_tc_kernels=len(own),
            hmma_per_kernel_min=min((c["HMMA"] for c in tc_kernels.values()),
                                    default=0),
            hmma_total=sum(c["HMMA"] for c in tc_kernels.values()),
            shfl_per_kernel_max=max((c["SHFL"] for c in attn.values()),
                                    default=0),
            dmma_kernels=len(dmma),
            dmma_per_kernel_min=min((c["DMMA"] for c in dmma.values()),
                                    default=0))), flush=True)
        if any(c["HMMA"] == 0 for c in tc_kernels.values()):
            fail(f"{name}: an attention or GEMM kernel without tensor-core "
                 "instructions (HMMA) in its SASS")
        if name in TENSOR_CORE_SOURCES and not attn:
            fail(f"{name}: no tensor-core attention kernel in its SASS")
        if name in GEMM_TC_SOURCES and not gemm:
            fail(f"{name}: no tensor-core GEMM kernel in its SASS")
        if len(own) < len(HMMA_KERNELS.get(name, ())):
            fail(f"{name}: a kernel of {HMMA_KERNELS[name]} is missing from "
                 "its SASS")
        if name in DMMA_KERNELS and (
                not dmma or any(c["DMMA"] == 0 for c in dmma.values())):
            fail(f"{name}: no {DMMA_KERNELS[name]} kernel with f64 "
                 "tensor-core instructions (DMMA) in its SASS")


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_rows(torch, prof):
    """(name, device us, calls) of each CUDA kernel or copy the profiler
    saw, the largest first; user annotations (such as the optimizer's step
    range) span kernels already counted and are left out."""
    return sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   and not getattr(e, "is_user_annotation", False)),
                  key=lambda r: -r[1])


PROFILER_TRIES = 3


def profiled_rows(torch, body):
    """``device_rows`` of ``body()`` run under ``torch.profiler`` (with what
    ``body`` returns), or (None, None) when the profiler recorded no device
    time in PROFILER_TRIES runs: now and then a profile on the card's
    machine comes back without its device events."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(PROFILER_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            out = body()
            torch.cuda.synchronize()
        rows = device_rows(torch, prof)
        if sum(r[1] for r in rows) > 0:
            return rows, out
    return None, None


def device_ms(torch, fn, iters: int = 20, warmup: int = 3):
    """(Device time of one call of ``fn``, whether the profiler's record was
    whole): the CUDA kernels it launches, timed by ``torch.profiler`` over
    ``iters`` calls after ``warmup``, so the host's launch gaps between them
    do not count. The calls are alike, so every kernel name is seen a
    multiple of ``iters`` times in a whole record. After some tens of
    profiles the card's machine loses events (as a rule one of a profile,
    once half of a kernel's), so a name's time is its mean over the events
    seen times its launches per call, ceil(seen / iters): the sum over
    ``iters`` in a whole record. A record that was not whole is marked in
    the row (``profile_whole``). Fails, as ``profile_pass`` does, when no
    run records any device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(iters):
            fn()

    rows, _ = profiled_rows(torch, body)
    if rows is None:
        fail(f"the profiler recorded no device time in {PROFILER_TRIES} "
             "runs")
    us = sum(total / seen * -(-seen // iters) for _name, total, seen in rows)
    return us / 1e3, all(seen % iters == 0 for _n, _t, seen in rows)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def moment_scale(torch, v, mask, shift):
    """(1, 2d) [Σ m|v−c| | Σ m(v−c)²]: the magnitude a moment sum's
    rounding error scales with."""
    y = (v.reshape(mask.shape[0], -1) - shift).abs()
    my = mask.float()[:, None] * y
    return torch.cat([my.sum(0), (my * y).sum(0)])[None] + 1e-30


def front_args(layer, batch, x, e):
    """The layer front's arguments as ``GPSLayer`` passes them."""
    return layer.local.front_args(batch, x, e, layer.front_pack())


def branch_outputs(layer, batch, x, e):
    """(xo, gate, s_attn): the pre-norm outputs of a layer's two branches in
    evaluation, on either path."""
    from graphgps_torch.ops.kernels import fused_gps_front

    if layer.takes_merged(batch):
        return fused_gps_front(*front_args(layer, batch, x, e))[:3]
    xo, gate = layer.local.core(batch, x, e)[:2]
    return xo, gate, x + layer.attention(batch, x)


def seeded_model(torch, cfg, splits, batch):
    """The entry point's seeded model (same seed, same weights) with seeded
    BatchNorm scale/bias, in evaluation on ``batch``'s device."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.common import MaskedBatchNorm
    from graphgps_torch.models.networks import build_model

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg, infer_dims(cfg, splits))
    g = torch.Generator().manual_seed(cfg.seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, MaskedBatchNorm):
                d = m.weight.shape[0]
                m.weight.copy_(1.0 + 0.1 * torch.randn(d, generator=g))
                m.bias.copy_(0.1 * torch.randn(d, generator=g))
    return model.to(batch.device).eval()


def drop_seed(torch, device, offset: int = 0):
    """``DROP_SEED + offset`` as a kernel takes a dropout seed on the card:
    a one-element int32 tensor there (``common.device_seed``)."""
    from graphgps_torch.ops.kernels.common import device_seed

    return device_seed(DROP_SEED + offset, device)


def fit(bn, v, mask):
    """A norm's running statistics set to the masked statistics of its
    input ``v``."""
    v = v.reshape(mask.shape[0], -1)[mask]
    bn.running_mean.copy_(v.mean(0))
    bn.running_var.copy_(v.var(0, unbiased=False))


def calibrated_model(torch, cfg, splits, batch):
    """``seeded_model`` with running statistics set, layer by layer, to the
    masked statistics of each norm's input on ``batch`` -- the state
    training leaves them in. An untrained 16-layer stack with arbitrary
    running statistics grows its activations to ~1e4 and is chaotic: f32 and
    f64 runs of the plain path differ by ~5% there."""
    model = seeded_model(torch, cfg, splits, batch)
    nm, em = batch.node_mask, batch.edge_mask
    with torch.no_grad():
        rwse = getattr(model.encoder, "rwse", None)
        if rwse is not None and rwse.raw_norm is not None:
            fit(rwse.raw_norm, batch.pe["pestat_RWSE"], nm)
        x, e = model.encoder(batch)
        for layer in model.layers:
            xo, gate, sa = branch_outputs(layer, batch, x, e)
            fit(layer.local.norm_x, xo, nm)
            fit(layer.local.norm_e, gate, em)
            fit(layer.norm_attn, sa, nm)
            out = layer.norm_out
            w, b = out.weight.clone(), out.bias.clone()
            out.running_mean.zero_()
            out.running_var.fill_(1.0 - out.eps)
            out.weight.fill_(1.0)
            out.bias.zero_()
            h, _ = layer(batch, x, e)          # the pre-norm sum, pads at 0
            fit(out, h, nm)
            out.weight.copy_(w)
            out.bias.copy_(b)
            x, e = layer(batch, x, e)
    return model


def calibrated_san_model(torch, cfg, splits, batch):
    """``calibrated_model`` for a SANTransformer: each SAN layer's attention
    norm fitted to the attention block's residual sum, its last norm to the
    FFN block's output (the plain route of evaluation), layer by layer."""
    model = seeded_model(torch, cfg, splits, batch)
    nm = batch.node_mask
    with torch.no_grad():
        x, e = model.encoder(batch)
        for layer in model.layers:
            h = x + layer.attn(batch, x, e) @ layer.w_o + layer.b_o
            fit(layer.norm1, h, nm)
            fit(layer.norm2, layer.ffn(h, nm, 0), nm)
            x, e = layer(batch, x, e)
    return model


def tensors(args):
    return [a for a in args if hasattr(a, "element_size")]


def as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def timings(torch, fn, plain, library=None) -> dict:
    """Device and host-clock ms per call of a kernel wrapper and of its
    plain version, in turns, and the device ms of the ``library`` call where
    there is one; ``profile_whole`` says that every device time is from a
    profiler record with all its events."""
    (ms, w1), (plain_ms, w2) = device_ms(torch, fn), device_ms(torch, plain)
    lib_ms, w3 = device_ms(torch, library) if library else (None, True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                profile_whole=w1 and w2 and w3,
                wall_ms=time_ms(torch, fn), plain_wall_ms=time_ms(torch, plain))


def bound(n_bytes: int, flops: int, peak: str = PEAK_F32) -> dict:
    """The least time the card could take: bytes over the memory rate or
    the operations over the rate ``peak`` names (the f32 CUDA cores' by
    default), whichever is larger; ``bound_rate`` names the rate."""
    byte_s, flop_s = n_bytes / PEAK_BYTES, flops / PEAKS[peak]
    return dict(bound_ms=max(byte_s, flop_s) * 1e3,
                bound_by="bytes" if byte_s >= flop_s else "operations",
                bound_rate=peak)


def forward_case(torch, c, shapes: dict, timed: bool = True) -> dict:
    """One forward kernel against its plain version on the same tensors:
    prints and returns its row; fails when they disagree. ``c``: name, fn,
    plain, args, flops (on the real rows), source, replaces, ``library``
    (a call of one PyTorch function that computes the same, where there is
    one: timed, used nowhere in the port), and for a
    function whose last outputs are (1, 2d) moment sums the
    ``moment_scales`` of those; ``tol`` = (rtol, atol) makes the atol
    relative to each tensor's largest entry; ``peak`` the rate of the bound's
    operations (PEAK_F32 by default); ``cold``: a tensor larger than the L2
    cache, to time the kernel also with the L2 flushed before each call
    (``cold_ms``). Without ``timed`` the row has no
    times and no bound (no profile: the card's profiler loses events after
    some tens of them)."""
    with torch.no_grad():
        got = as_tuple(c["fn"](*c["args"]))
        ref = as_tuple(c["plain"](*c["args"]))
        torch.cuda.synchronize()
        for g_ in got:
            if not torch.isfinite(g_).all():
                fail(f"{c['name']}: non-finite output")
        # tensors: elementwise; (1, 2d) moment sums: against the sum of
        # their terms' magnitudes, since sum m(v-c) cancels to ~0 when c is
        # the mean
        scales = c.get("moment_scales", [])
        n_t = len(got) - len(scales)
        err = max(float((g_ - r_).abs().max())
                  for g_, r_ in zip(got[:n_t], ref[:n_t]))
        rtol, atol = c.get("tol", (KERNEL_RTOL, KERNEL_ATOL))
        if "tol" in c:
            # atol times the tensor's largest entry
            ok = grads_close(torch, got, ref, rtol, atol, 0.0)[0]
            atol = f"{atol} x max|entry|"
        else:
            ok = all(torch.allclose(g_, r_, rtol=rtol, atol=atol)
                     for g_, r_ in zip(got[:n_t], ref[:n_t]))
        extra = {}
        if scales:
            rel = max(float(((g_ - r_).abs() / scale).max())
                      for g_, r_, scale in zip(got[n_t:], ref[n_t:], scales))
            ok &= rel <= MOMENT_RTOL
            extra = dict(moments_max_rel_err=rel, moments_rtol=MOMENT_RTOL)
        timed_keys = dict(
            **timings(torch, lambda: c["fn"](*c["args"]),
                      lambda: c["plain"](*c["args"]), c.get("library")),
            **bound(nbytes(*tensors(c["args"]), *got), c["flops"],
                    c.get("peak", PEAK_F32))) if timed else {}
        if timed and "cold" in c:
            timed_keys["cold_ms"] = cold_device_ms(
                torch, lambda: c["fn"](*c["args"]), c["cold"])
        row = dict(name=c["name"], route="cuda", source=c["source"],
                   replaces=c["replaces"], max_abs_err=err,
                   rtol=rtol, atol=atol, **timed_keys, shapes=shapes,
                   **extra)
    print(json.dumps(row), flush=True)
    if not ok:
        fail(f"{c['name']}: kernel disagrees with its plain version "
             f"(max abs err {err}, rtol {rtol}, atol {atol})")
    return row


def launch_floor(torch, device) -> float:
    """The card's smallest launch: the device ms of a one-element
    ``Tensor.add_``, timed as the kernels are (``device_ms``), printed on a
    line of its own."""
    one = torch.zeros(1, device=device)
    ms, whole = device_ms(torch, lambda: one.add_(1.0))
    print(json.dumps(dict(launch_floor_ms=ms, call="one-element Tensor.add_",
                          profile_whole=whole)), flush=True)
    return ms


def check_kernels(torch, cfg, splits, device, flush):
    """Phase 3: each kernel of the merged path vs its plain version on
    layer 0's inputs (``pre_tail`` also L2-cold, ``flush`` written between
    calls), and the unmerged path's ``gatedgcn`` and ``drop_add`` at
    GPS-deep's layer with the front off (G'). Returns the rows, the
    calibrated model's state dict and layer 0's inputs."""
    from graphgps_torch.driver import create_loaders
    from graphgps_torch.ops.kernels.combine_ffn import (combine_ffn_plain,
                                                         fused_combine_ffn)
    from graphgps_torch.ops.kernels.gatedgcn import fused_gatedgcn
    from graphgps_torch.ops.kernels.gps_front import (fused_gps_front,
                                                       gps_front_plain)
    from graphgps_torch.ops.kernels.pre_tail import (fused_pre_tail,
                                                      pre_tail_plain)

    loader = create_loaders(cfg, splits, device)["train"]
    real, batch = next(iter(loader))
    model = calibrated_model(torch, cfg, splits, batch)
    layer = model.layers[0]
    gg = layer.local
    B, N, E = batch.num_graphs, batch.max_nodes, batch.edge_block
    d, H = layer.dim_h, layer.num_heads
    with torch.no_grad():
        x, e = model.encoder(batch)
        front_in = front_args(layer, batch, x, e)
        xo, gate, sa = fused_gps_front(*front_in)[:3]
        tail_args = gg.edge_tail_args(e, gate.reshape(B * E, d))
        comb_args = layer.combine_args(gg.x_tail_args(x, xo.reshape(B * N, d)),
                                       sa.reshape(B * N, d))

    n_real = int(batch.node_mask.sum())
    e_real = int(batch.edge_mask.sum())
    attn_pairs = int((batch.node_mask.reshape(B, N).sum(1) ** 2).sum())
    dh = layer.w_ffn1.shape[1]
    cases = [
        dict(name="gps_front", fn=fused_gps_front, plain=gps_front_plain,
             args=front_in, source="graphgps_torch/csrc/gps_front.cu",
             replaces="graphgps_tpu/ops/pallas/fused_layer.py:270",
             moment_scales=[moment_scale(torch, v, m, sh) for v, m, sh in (
                 (xo, batch.node_mask, gg.norm_x.running_mean),
                 (gate, batch.edge_mask, gg.norm_e.running_mean),
                 (sa, batch.node_mask, layer.norm_attn.running_mean))],
             # products on the real rows: joint projection, edge projection,
             # QK^T and PV per head, out-projection (3xTF32 tensor cores)
             flops=2 * n_real * d * 7 * d + 2 * e_real * d * d
             + 4 * attn_pairs * d + 2 * n_real * d * d, peak=PEAK_3XTF32),
        dict(name="pre_tail", fn=fused_pre_tail, plain=pre_tail_plain,
             args=tail_args, source="graphgps_torch/csrc/pre_tail.cu",
             replaces="graphgps_tpu/ops/pallas/fused_tail.py:189",
             flops=tail_flops(gg.act) * e_real * d, cold=flush),
        dict(name="combine_ffn", fn=fused_combine_ffn, plain=combine_ffn_plain,
             args=comb_args, source="graphgps_torch/csrc/combine_ffn.cu",
             replaces="graphgps_tpu/ops/pallas/fused_combine.py:183",
             # the FFN's two products (3xTF32 tensor cores)
             flops=4 * n_real * d * dh, peak=PEAK_3XTF32),
    ]
    shapes = dict(B=B, N=N, E=E, d=d, H=H, real_nodes=n_real,
                  real_edges=e_real)
    results = [forward_case(torch, c, shapes) for c in cases]
    # the GatedGCN core as GPS-deep's layers with the front off run it
    # (G'), forward and backward: printed, not in the kernels line, which
    # takes ogbg-molhiv's rows (3c)
    with torch.no_grad():
        gin = gg.core_args(batch, x, e, layer.node_proj())
        gout = fused_gatedgcn(*gin)
    ggcn = gatedgcn_cases(torch, gin, gg, batch, gout[0].reshape(-1, d),
                          gout[1].reshape(-1, d),
                          cotangents(torch, SEED + 17, device))
    at = dict(shapes, path="pcqm4m-GPSdeep front-off")
    forward_case(torch, ggcn[0], at)
    backward_case(torch, ggcn[1], DROP_SEED, 0.0, at)
    # and its attention branch's drop-add (G': B*N rows of d, the fused
    # attention rung's output), printed likewise
    with torch.no_grad():
        h_attn = layer.attention(batch, x)
    da = drop_add_cases(torch, x, h_attn, drop_seed(torch, device),
                        DROP_RATE, cotangents(torch, SEED + 18, device))
    forward_case(torch, da[0], at)
    backward_case(torch, da[1], DROP_SEED, DROP_RATE, at)
    layer0 = dict(front=front_in, tail=tail_args, comb=comb_args,
                  n_real=n_real, e_real=e_real, attn_pairs=attn_pairs,
                  B=B, N=N, E=E, d=d, H=H, dh=dh, flush=flush)
    return results, {k: v.clone() for k, v in model.state_dict().items()}, \
        layer0


def tail_flops(act: str) -> int:
    """Operations per element of ``x + act(bn(v))``: sub, 2 mul, add, the
    activation (gelu ~8, relu 1) and the residual add."""
    return 5 + (8 if act == "gelu" else 1)


def grads_close(torch, got, want, rtol, atol, floor: float = 1.0):
    """(ok, max abs err, max err over the scale): each tensor within rtol
    and atol × scale, the scale being max(floor, its largest |entry|)."""
    ok, err, rel = True, 0.0, 0.0
    for g_, w_ in zip(got, want):
        scale = max(floor, float(w_.abs().max()))
        e_ = float((g_ - w_).abs().max())
        err, rel = max(err, e_), max(rel, e_ / scale)
        ok &= bool(torch.isfinite(g_).all()) and torch.allclose(
            g_, w_, rtol=rtol, atol=atol * scale)
    return ok, err, rel


def backward_case(torch, c, seed, rate: float, shapes: dict,
                  timed: bool = True) -> dict:
    """One backward kernel, after its forward kernel with dropout ``rate``
    on every site, against autograd of the plain version on the same
    inputs and cotangents: prints and returns its row; fails on a gradient
    outside tolerance, a kept fraction outside the u8 grid's ± 0.5%, or two
    runs that differ in any bit. ``c``: name, run (cots or None → (cots,
    the backward call)), plain (cots → gradients), inputs (the tensors the
    backward reads beside the cotangents), sites [(name, rows, cols[,
    site id, by default the place in the list])], flops, source, replaces,
    ``library`` (cots → a call of autograd through one PyTorch function that
    computes the same forward, where there is one: timed, used nowhere in
    the port), and ``tol`` = (rtol, atol) to make the atol relative to each
    tensor's largest entry with no floor (by default GRAD_RTOL and GRAD_ATOL
    × max(1, largest entry)); ``peak``, ``cold`` and ``timed`` as in
    ``forward_case``."""
    from graphgps_torch.ops.kernels.common import dropout_mask, keep_rule

    cots, bwd = c["run"]()
    got = bwd()
    _, bwd2 = c["run"](cots)
    again = bwd2()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    want = c["plain"](cots)
    rtol, atol = c.get("tol", (GRAD_RTOL, GRAD_ATOL))
    floor = 0.0 if "tol" in c else 1.0
    ok, err, rel = grads_close(torch, got, want, rtol, atol, floor)
    device = cots[0].device
    kept = {name: float((dropout_mask(seed, site[0] if site else i, r_, c_,
                                      rate, device) > 0).float().mean())
            for i, (name, r_, c_, *site) in enumerate(c["sites"])}
    row = dict(name=c["name"], route="cuda", source=c["source"],
               replaces=c["replaces"], max_abs_err=err,
               max_err_over_tensor_max=rel, rtol=rtol,
               atol=(f"{atol} x max|grad|" if floor == 0.0
                     else f"{atol} x max(1, max|grad|)"),
               bit_identical_reruns=same,
               **(dict(**timings(torch, bwd, lambda: c["plain"](cots),
                                 c["library"](cots) if "library" in c
                                 else None),
                       **bound(nbytes(*c["inputs"], *cots, *got),
                               c["flops"], c.get("peak", PEAK_F32)))
                  if timed else {}),
               **(dict(cold_ms=cold_device_ms(torch, bwd, c["cold"]))
                  if timed and "cold" in c else {}),
               rate=rate, kept_fraction=kept, shapes=shapes)
    print(json.dumps(row), flush=True)
    if not same:
        fail(f"{c['name']}: two runs on the same inputs differ")
    if not ok:
        fail(f"{c['name']}: disagrees with autograd of its plain version "
             f"(max abs err {err}, {rel} of the tensor's largest entry)")
    keep = 1.0 - keep_rule(rate)[0] / 256
    for name, frac in kept.items():
        if abs(frac - keep) > KEEP_REL_TOL * keep:
            fail(f"{c['name']}: site {name!r} keeps {frac}, expected {keep}")
    return row


def cotangents(torch, seed: int, device):
    """A maker of seeded random cotangents shaped like given outputs."""
    g = torch.Generator(device=device).manual_seed(seed)
    return lambda outs: [torch.randn(o.shape, generator=g, device=o.device)
                         for o in outs]


def drop_add_cases(torch, x, v, seed, rate: float, cots_for):
    """``drop_add``'s forward and backward cases on the (R, d) rows ``x``
    and ``v`` at dropout ``rate`` (the attention branch's residual)."""
    from graphgps_torch.ops.kernels import drop_add

    R, d = v.shape
    src = "graphgps_torch/csrc/drop_add.cu"

    def run(cots=None):
        out = drop_add._launch_forward(x, v, seed, rate)
        cots = cots or cots_for([out])
        return cots, lambda: (drop_add.drop_add_backward(cots[0], seed, rate),)

    fwd = dict(name="drop_add", fn=drop_add.fused_drop_add,
               plain=drop_add.drop_add_plain, args=(x, v, seed, rate),
               source=src, replaces="graphgps_tpu/ops/pallas/fused_tail.py:270",
               # a product with the mask and the add per element
               flops=2 * R * d)
    bwd = dict(name="drop_add_bwd", run=run,
               plain=lambda c: (drop_add.drop_add_backward_plain(
                   c[0], seed, rate),),
               inputs=[], source=src,
               replaces="graphgps_tpu/ops/pallas/fused_tail.py:298",
               sites=[("attention branch", R, d)], flops=R * d)
    return fwd, bwd


def tail_backward_case(torch, tin, tconf, cots_for, rows: int, d: int,
                       e_real: int) -> dict:
    from graphgps_torch.ops.kernels import pre_tail

    def run(cots=None):
        out = pre_tail._launch_forward(*tin, *tconf)
        cots = cots or cots_for([out])
        return cots, lambda: pre_tail.pre_tail_backward(
            *tin[1:], cots[0], *tconf)

    return dict(name="pre_tail_bwd", run=run,
                plain=lambda c: pre_tail.pre_tail_backward_plain(
                    *tin[1:], c[0], *tconf),
                inputs=tin[1:], source="graphgps_torch/csrc/pre_tail.cu",
                replaces="graphgps_tpu/ops/pallas/fused_tail.py:220",
                sites=[("edge tail", rows, d)],
                # act' (~10), mask, four products and four sums per element
                flops=20 * e_real * d)


def combine_backward_case(torch, cin, cconf, cots_for, R: int, d: int,
                          dh: int, n_real: int) -> dict:
    from graphgps_torch.ops.kernels import combine_ffn

    def run(cots=None):
        out, h, z, a1 = combine_ffn._launch_forward(cin, *cconf, True)
        cots = cots or cots_for([out])
        return cots, lambda: combine_ffn.combine_ffn_backward(
            *cin, cots[0], *cconf, kept=(h, a1, z))

    return dict(name="combine_ffn_bwd", run=run,
                plain=lambda c: combine_ffn.combine_ffn_backward_plain(
                    *cin, c[0], *cconf),
                inputs=cin, source="graphgps_torch/csrc/combine_ffn.cu",
                replaces="graphgps_tpu/ops/pallas/fused_combine.py:235",
                sites=[("local tail", R, d), ("FFN inner", R, dh),
                       ("FFN outer", R, d)],
                # dU = dA2 W2^T, dH = dA1 W1^T, dW1 = H^T dA1, dW2 = Z^T dA2
                # (3xTF32 tensor cores)
                flops=8 * n_real * d * dh, peak=PEAK_3XTF32)


def check_backward(torch, layer0):
    """Phase 3b: the three functions of the merged path with dropout
    DROP_RATE on every site, forward and backward, through the kernels and
    through autograd of their plain versions, on layer 0's inputs at the
    main path's shapes. One JSON line per backward kernel."""
    from graphgps_torch.ops.kernels import gps_front, pre_tail
    from graphgps_torch.ops.kernels.common import dropout_mask

    L = layer0
    device = L["front"][0].device
    B, N, E, d, H, dh = (L[k] for k in ("B", "N", "E", "d", "H", "dh"))
    n, e_, pairs = L["n_real"], L["e_real"], L["attn_pairs"]
    R = B * N
    rate, seed = DROP_RATE, drop_seed(torch, device)
    cots_for = cotangents(torch, SEED + 5, device)

    fin = tuple(L["front"][:15])
    fconf = (seed, H, L["front"][17], rate, rate)
    tin = tuple(L["tail"][:6])
    tconf = (seed, rate, L["tail"][8])
    cin = tuple(L["comb"][:15])
    cconf = (seed, rate, L["comb"][17])

    def run_front(cots=None):
        outs, kept = gps_front._launch_forward(fin, *fconf)
        cots = cots or cots_for(outs)
        kept = (*outs[:3], *kept)
        return cots, lambda: gps_front.gps_front_backward(
            *fin, *fconf, *cots, kept=kept)

    cases = [
        dict(name="gps_front_bwd", run=run_front,
             plain=lambda c: gps_front.gps_front_backward_plain(
                 *fin, *fconf, *c),
             inputs=fin, source="graphgps_torch/csrc/gps_front.cu",
             replaces="graphgps_tpu/ops/pallas/fused_layer.py:352",
             sites=[("attention P", B * H * N, N), ("out-projection", R, d)],
             # dx, dWnq (7d wide), de, dWc, dO, dWo, and per head dv, dP,
             # dq, dk over the real pairs
             flops=4 * n * 7 * d * d + 4 * e_ * d * d + 4 * n * d * d
             + 8 * pairs * d, peak=PEAK_3XTF32),
        dict(tail_backward_case(torch, tin, tconf, cots_for, B * E, d, e_),
             cold=L["flush"]),
        combine_backward_case(torch, cin, cconf, cots_for, R, d, dh, n),
    ]

    # the pre_tail forward kernel's own mask, read back: x_in = 0 and
    # act(bn(v)) = 1 leave exactly the site-0 multiplier
    zeros = torch.zeros((B * E, d), device=device)
    one, zero = torch.ones(d, device=device), torch.zeros(d, device=device)
    drawn = pre_tail._launch_forward(zeros, zeros, zero, one, zero, one, seed,
                                     rate, "identity")
    if not torch.equal(drawn, dropout_mask(seed, 0, B * E, d, rate, device)):
        fail("pre_tail: the kernel's mask differs from the port's hash")

    shapes = dict(B=B, N=N, E=E, d=d, H=H)
    return [backward_case(torch, c, seed, rate, shapes) for c in cases]


def gatedgcn_cases(torch, gin, gg, batch, xo, gate, cots_for):
    """The GatedGCN core's forward and backward cases on its inputs ``gin``
    (``gg.core_args`` of ``batch``), with the scales of its moment sums
    from its outputs ``xo`` and ``gate``; ``cots_for`` draws the backward's
    cotangents."""
    from graphgps_torch.ops.kernels import gatedgcn

    d = xo.shape[-1]
    n_real = int(batch.node_mask.sum())
    e_real = int(batch.edge_mask.sum())
    # the core per real edge and column: two gathers' adds, the sigmoid
    # (~6), the message product, two accumulations, two moment terms; per
    # real node the division, the add and two moment terms
    core = 14 * e_real * d + 6 * n_real * d
    src = "graphgps_torch/csrc/gatedgcn.cu"
    tpu = "graphgps_tpu/ops/pallas/fused_gatedgcn.py"

    def run(cots=None):
        outs, proj = gatedgcn._launch_forward(gin)
        cots = cots or cots_for(outs)
        return cots, lambda: gatedgcn.gatedgcn_backward(
            *gin, *cots, kept=(outs[0], outs[1], proj))

    fwd = dict(name="gatedgcn", fn=gatedgcn.fused_gatedgcn,
               plain=gatedgcn.gatedgcn_plain, args=gin, source=src,
               replaces=f"{tpu}:279",
               moment_scales=[
                   moment_scale(torch, xo, batch.node_mask,
                                gg.norm_x.running_mean),
                   moment_scale(torch, gate, batch.edge_mask,
                                gg.norm_e.running_mean)],
               flops=2 * n_real * d * 4 * d + 2 * e_real * d * d + core,
               peak=PEAK_3XTF32)
    bwd = dict(name="gatedgcn_bwd", run=run,
               plain=lambda c: gatedgcn.gatedgcn_backward_plain(*gin, *c),
               inputs=tensors(gin), source=src, replaces=f"{tpu}:349",
               sites=[],
               # dx, dWn (4d wide), de, dWc, and about twice the forward's
               # core (sigma and the quotient recomputed, five scatters)
               flops=4 * n_real * d * 4 * d + 4 * e_real * d * d + 2 * core,
               peak=PEAK_3XTF32)
    return fwd, bwd


def check_unmerged(torch, tag: str, cfg_path: str, opts, device, cold=None):
    """Phase 3c: the four functions of the unmerged layer path (GatedGCN
    core, edge tail, drop-add, combine+FFN), forward and backward with
    dropout UNMERGED_DROP_RATE, kernels against plain versions, on layer
    0's inputs of the recipe ``cfg_path`` (``opts`` on top) at its batch
    size and width; the drop-add also L2-cold given the flush tensor
    ``cold``. Returns (cfg, splits, rows, the calibrated model's state
    dict); every row carries ``shape=tag``."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders
    from graphgps_torch.ops.kernels import combine_ffn, gatedgcn, pre_tail
    from graphgps_torch.ops.kernels.common import dropout_mask

    cfg = new_cfg()
    load_cfg(cfg, cfg_path)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    _real, batch = next(iter(create_loaders(cfg, splits, device)["train"]))
    model = calibrated_model(torch, cfg, splits, batch)
    layer = model.layers[0]
    if layer.takes_merged(batch):
        fail(f"{tag}: expected the unmerged layer path at d={layer.dim_h}")
    gg = layer.local
    B, N, E = batch.num_graphs, batch.max_nodes, batch.edge_block
    d, H, dh = layer.dim_h, layer.num_heads, layer.w_ffn1.shape[1]
    R = B * N
    rate, seed = UNMERGED_DROP_RATE, drop_seed(torch, device)
    with torch.no_grad():
        x, e = model.encoder(batch)
        gin = gg.core_args(batch, x, e)
        xo, gate = (t.reshape(-1, d) for t in
                    gatedgcn.fused_gatedgcn(*gin)[:2])
        h_attn = layer.attention(batch, x)
        tin = tuple(gg.edge_tail_args(e, gate)[:6])
        cin = tuple(layer.combine_args(gg.x_tail_args(x, xo),
                                       x + h_attn)[:15])
    tconf = cconf = (seed, rate, gg.act)
    n_real = int(batch.node_mask.sum())
    e_real = int(batch.edge_mask.sum())
    shapes = dict(B=B, N=N, E=E, d=d, H=H, real_nodes=n_real,
                  real_edges=e_real)
    cots_for = cotangents(torch, SEED + 6, device)
    ggcn_fwd, ggcn_bwd = gatedgcn_cases(torch, gin, gg, batch, xo, gate,
                                        cots_for)
    da_fwd, da_bwd = drop_add_cases(torch, x, h_attn, seed, rate, cots_for)
    if cold is not None:
        da_fwd["cold"] = da_bwd["cold"] = cold
    fwd = [
        ggcn_fwd,
        dict(name="pre_tail", fn=pre_tail.fused_pre_tail,
             plain=pre_tail.pre_tail_plain, args=(*tin, *tconf),
             source="graphgps_torch/csrc/pre_tail.cu",
             replaces="graphgps_tpu/ops/pallas/fused_tail.py:189",
             flops=tail_flops(gg.act) * e_real * d),
        da_fwd,
        dict(name="combine_ffn", fn=combine_ffn.fused_combine_ffn,
             plain=combine_ffn.combine_ffn_plain, args=(*cin, *cconf),
             source="graphgps_torch/csrc/combine_ffn.cu",
             replaces="graphgps_tpu/ops/pallas/fused_combine.py:183",
             flops=4 * n_real * d * dh, peak=PEAK_3XTF32),
    ]
    rows = [forward_case(torch, c, shapes) for c in fwd]

    bwd = [
        ggcn_bwd,
        tail_backward_case(torch, tin, tconf, cots_for, B * E, d, e_real),
        da_bwd,
        combine_backward_case(torch, cin, cconf, cots_for, R, d, dh, n_real),
    ]
    rows += [backward_case(torch, c, seed, rate, shapes) for c in bwd]

    # the attention dropout (PyTorch ops over the port's hash): the kept
    # fraction of the (B*H*N, N) mask at the recipe's rate
    m = dropout_mask(seed, 0, B * H * N, N, UNMERGED_ATTN_RATE, device)
    frac = float((m > 0).float().mean())
    print(json.dumps(dict(shape=tag, attention_mask_kept=frac,
                          rate=UNMERGED_ATTN_RATE)), flush=True)
    if abs(frac - 0.5) > KEEP_REL_TOL:
        fail(f"{tag}: the attention mask keeps {frac} at rate 0.5")
    for r in rows:
        r["shape"] = tag
    return cfg, splits, rows, \
        {k: v.clone() for k, v in model.state_dict().items()}


def edge_gate_orders_note(torch, s_loc, r_loc, N: int, tag: str,
                          timed: bool = False):
    """The edge gate's orders of endpoints ``s_loc``/``r_loc`` (B, E) at N
    node slots: built on the card (one plan launch after one stable
    argsort) and held equal to their plain version on the CPU; with
    ``timed``, timed (device ms) beside the plain version on the card and
    ``torch.argsort`` of the same keys, the one PyTorch call for the
    permutation (three more profiles: the card's profiler loses events
    after some tens of them, so only the recipe's shape is timed). Printed
    as a note (the plan kernel's own row is 3j's). Returns the orders, with
    ``.ms`` their device ms (None untimed)."""
    from graphgps_torch.ops.kernels import edge_gate, segment_sum

    before = segment_sum.segment_plan.launches
    orders = edge_gate.edge_gate_orders(s_loc, r_loc, N)
    launches = segment_sum.segment_plan.launches - before
    plain = edge_gate.edge_gate_orders(s_loc.cpu(), r_loc.cpu(), N)
    same = (torch.equal(orders.perm.cpu(), plain.perm)
            and torch.equal(orders.plan.ptr.cpu(), plain.plan.ptr))
    t = {}
    if timed:
        keys = edge_gate.order_keys(s_loc, r_loc, N)
        S2 = 2 * (s_loc.shape[0] * N + 1)
        t = timings(torch,
                    lambda: edge_gate.edge_gate_orders(s_loc, r_loc, N),
                    lambda: segment_sum.plan_plain(keys, S2, True),
                    lambda: torch.argsort(keys, stable=True))
        t = {k: t[k] for k in ("ms", "plain_ms", "library_ms",
                               "profile_whole")}
    print(json.dumps(dict(note="edge gate orders", shape=tag,
                          plan_launches=launches, same_as_plain=same,
                          B=s_loc.shape[0], N=N, E=s_loc.shape[1], **t)),
          flush=True)
    if not same or launches != 1:
        fail(f"phase 3d: the edge gate's orders ({tag}) differ from their "
             f"plain version, or took {launches} plan launches")
    orders.ms = t.get("ms")
    return orders


def check_long_graphs(torch, cfg_path: str, opts, device):
    """Phase 3d: the two functions of the long-graph rung (edge gate, wide
    attention), forward and backward, kernels against plain versions, on
    layer 0's inputs of the recipe ``cfg_path`` (``opts`` on top) at its
    batch size and width; the edge gate again at VOC_REAL_EDGES edge slots
    per graph on seeded random inputs. Returns (cfg, splits, rows, the
    calibrated model's state dict); the rows at the recipe's shapes come
    first and carry ``shape="voc"``."""
    import torch.nn.functional as F

    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.ops.kernels import edge_gate, wide_attention
    from graphgps_torch.ops.mha import split_heads

    cfg = new_cfg()
    load_cfg(cfg, cfg_path)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    infer_dims(cfg, splits)
    _real, batch = next(iter(create_loaders(cfg, splits, device)["train"]))
    model = calibrated_model(torch, cfg, splits, batch)
    layer = model.layers[0]
    B, N, E = batch.num_graphs, batch.max_nodes, batch.edge_block
    d, H = layer.dim_h, layer.num_heads
    scale = 1.0 / float(d // H) ** 0.5
    seed = drop_seed(torch, device)
    with torch.no_grad():
        x, e = model.encoder(batch)
        _, gate_in = layer.local.edge_gate_args(batch, x, e)
        gate_in = tuple(t.contiguous() for t in gate_in)
    # the batch's edge orders, built once as a step's eight calls share them
    orders = edge_gate_orders_note(torch, gate_in[3], gate_in[4], N, "voc",
                                   timed=True)
    attn_in = (x.reshape(B, N, d), batch.counts, layer.w_qkv.detach(),
               layer.b_qkv.detach(), layer.w_out.detach(),
               layer.b_out.detach())
    cots_for = cotangents(torch, SEED + 7, device)
    eg_src = "graphgps_torch/csrc/edge_gate.cu"
    wa_src = "graphgps_torch/csrc/wide_attention.cu"
    eg_tpu = "graphgps_tpu/ops/pallas/fused_edge_gate.py"
    wa_tpu = "graphgps_tpu/ops/pallas/fused_attn_wide.py"
    tol = (LONG_RTOL, LONG_ATOL)

    def gate_cases(args, e_real, n_real, orders):
        # per real edge and column: three gathers' adds, the sigmoid (~6),
        # the message product and two accumulations; the backward about
        # twice that (sigma twice, five scatters)
        flops = 12 * e_real * d
        def run(cots=None):
            gate, nd = edge_gate._launch_forward(args, orders)
            cots = cots or cots_for((gate, nd))
            return cots, lambda: edge_gate.edge_gate_backward(
                *args, *cots, kept=(gate,), orders=orders)
        return (dict(name="edge_gate",
                     fn=lambda *a: edge_gate.fused_edge_gate(*a,
                                                             orders=orders),
                     plain=edge_gate.edge_gate_plain, args=args, tol=tol,
                     source=eg_src, replaces=f"{eg_tpu}:120", flops=flops),
                dict(name="edge_gate_bwd", run=run,
                     plain=lambda c: edge_gate.edge_gate_backward_plain(
                         *args, *c),
                     inputs=args[1:], source=eg_src,
                     replaces=f"{eg_tpu}:167", sites=[], flops=2 * flops))

    # the library's yardstick of the wide attention: one call of
    # F.multi_head_attention_forward computes the QKV projection, the
    # key-masked attention, dropout on the probabilities and the
    # out-projection. It takes (N, B, d), (out, in) weights and a mask of the
    # padded keys; its dropout bits are its own, so at a rate above 0 only
    # its time compares. Timed here, used nowhere in the port.
    n_keys = torch.where(batch.counts > 0, batch.counts, N)
    padded = torch.arange(N, device=device)[None, :] >= n_keys[:, None]
    lib_in = [t.contiguous() for t in (
        attn_in[0].transpose(0, 1), attn_in[2].t(), attn_in[3],
        attn_in[4].t(), attn_in[5])]

    def library_mha(rate, xt, w_in, b_in, w_out, b_out):
        return F.multi_head_attention_forward(
            xt, xt, xt, d, H, w_in, b_in, None, None, False, rate, w_out,
            b_out, training=True, key_padding_mask=padded,
            need_weights=False)[0]

    def library_backward(rate):
        leaves = [t.clone().requires_grad_() for t in lib_in]
        y = library_mha(rate, *leaves)
        return lambda cots: lambda: torch.autograd.grad(
            y, leaves, cots[0].transpose(0, 1), retain_graph=True)

    def attn_cases(rate, ins=attn_in, library=True):
        conf = (seed, H, scale, rate)
        counts = ins[1]
        keys = torch.where(counts > 0, counts, N)
        pairs = int(N * keys.sum())       # (query, key) pairs with weight
        proj = 2 * B * N * d * 4 * d      # QKV and out-projection
        def run(cots=None):
            y, kept = wide_attention._launch_forward(ins, *conf)
            cots = cots or cots_for([y])
            return cots, lambda: wide_attention.wide_attention_backward(
                *ins, *conf, cots[0], kept=kept)
        sites = [("attention P", B * H * N, N)] if rate > 0 else []
        lib_f = dict(library=lambda: library_mha(rate, *lib_in)) \
            if library else {}
        lib_b = dict(library=library_backward(rate)) if library else {}
        return (dict(name="wide_attention",
                     fn=wide_attention.fused_wide_attention,
                     plain=wide_attention.wide_attention_plain,
                     args=(*ins, *conf), tol=tol, source=wa_src,
                     replaces=f"{wa_tpu}:244", peak=PEAK_3XTF32, **lib_f,
                     # q k^T and P v over the weighted pairs, per head
                     flops=proj + 4 * pairs * d),
                dict(name="wide_attention_bwd", run=run,
                     plain=lambda c:
                         wide_attention.wide_attention_backward_plain(
                             *ins, *conf, c[0]),
                     inputs=ins, source=wa_src, replaces=f"{wa_tpu}:297",
                     sites=sites, peak=PEAK_3XTF32, **lib_b,
                     # dO, dWo, dx, dWqkv, and per head the logits again,
                     # dP, dq, dk, dv over the weighted pairs
                     flops=2 * proj + 10 * pairs * d))

    n_real, e_real = int(batch.node_mask.sum()), int(batch.edge_mask.sum())
    shapes = dict(B=B, N=N, E=E, d=d, H=H, real_nodes=n_real,
                  real_edges=e_real)
    rows = []
    gf, gb = gate_cases(gate_in, e_real, n_real, orders)
    rows += [forward_case(torch, gf, shapes),
             backward_case(torch, gb, seed, 0.0, shapes)]
    print(json.dumps(dict(
        note="the edge gate's device ms a VOC training step: the orders "
             "once, then 4 layers' forward and backward over them",
        orders_ms=orders.ms, kernels_ms=4 * (rows[0]["ms"] + rows[1]["ms"]),
        step_ms=orders.ms + 4 * (rows[0]["ms"] + rows[1]["ms"]),
        shapes=shapes)), flush=True)
    for rate in (cfg.gt.attn_dropout, 0.0):
        af, ab = attn_cases(rate)
        rows += [dict(forward_case(torch, af, dict(shapes, attn_rate=rate)),
                      attn_rate=rate),
                 dict(backward_case(torch, ab, seed, rate,
                                    dict(shapes, attn_rate=rate)),
                      attn_rate=rate)]
    for r in rows:
        r["shape"] = "voc"

    # the share of the wide attention's device time its projections and
    # column sums (gemm.cuh, common.cuh) take beside the attention body
    # (attn_tc.cuh), at the recipe's rate
    rate = cfg.gt.attn_dropout
    conf = (seed, H, scale, rate)
    y, kept = wide_attention._launch_forward(attn_in, *conf)
    cot = cots_for([y])[0]
    split_ms = {}
    for kind, fn in (("fwd", lambda: wide_attention._launch_forward(
                          attn_in, *conf)),
                     ("bwd", lambda: wide_attention.wide_attention_backward(
                         *attn_in, *conf, cot, kept=kept))):
        fn()
        torch.cuda.synchronize()
        prof, _ = profiled_rows(torch, lambda: [fn() for _ in range(20)])
        if prof is None:
            fail("phase 3d: the profiler recorded no device time of the "
                 "wide attention")
        body = sum(us for name, us, _ in prof if "attn_" in name) / 20e3
        rest = sum(us for name, us, _ in prof if "attn_" not in name) / 20e3
        split_ms[kind] = dict(attention_ms=body, projections_ms=rest,
                              projections_share=rest / (body + rest))
    print(json.dumps(dict(note="wide_attention's device time by part at the "
                               "recipe's rate (profiler, 20 calls)",
                          attn_rate=rate, **split_ms, shapes=shapes)),
          flush=True)

    # a batch with a graph of no real node (uniform weights over its slots)
    # on seeded inputs: the layer's weights, the other graphs 400-500 real
    g = torch.Generator(device=device).manual_seed(SEED + 9)
    empty_counts = torch.randint(400, N + 1, (B,), generator=g,
                                 device=device, dtype=torch.int32)
    empty_counts[0] = 0
    empty_in = (torch.randn(B, N, d, generator=g, device=device),
                empty_counts, *attn_in[2:])
    e_shapes = dict(shapes, real_nodes=int(empty_counts.sum()),
                    attn_rate=rate, empty_graphs=1)
    af, ab = attn_cases(rate, empty_in, library=False)
    for r in (forward_case(torch, af, e_shapes),
              backward_case(torch, ab, seed, rate, e_shapes)):
        r.update(shape="voc, a graph with no real node", attn_rate=rate)
        rows.append(r)

    # the library call computes the kernel's function: held at rate 0, where
    # no dropout bits part them. And a note: the library's attention core
    # alone (no projections, no dropout)
    with torch.no_grad():
        y = wide_attention.fused_wide_attention(*attn_in, seed, H, scale, 0.0)
        y_lib = library_mha(0.0, *lib_in).transpose(0, 1)
        lib_err = float((y - y_lib).abs().max())
        qkv = attn_in[0] @ attn_in[2] + attn_in[3]
        q, k, v = (split_heads(qkv[..., i * d:(i + 1) * d], H).contiguous()
                   for i in range(3))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=~padded[:, None, None, :], scale=scale)
        print(json.dumps(dict(
            note="F.multi_head_attention_forward against wide_attention at "
                 "rate 0; F.scaled_dot_product_attention, f32, the attention "
                 "core alone at rate 0; neither is used in the port",
            library_vs_kernel_max_abs_err=lib_err, rtol=LIBRARY_RTOL,
            atol=f"{LIBRARY_ATOL} x max|entry|",
            sdpa_core_ms=device_ms(torch, sdpa)[0], shapes=shapes)),
              flush=True)
        if not grads_close(torch, [y_lib], [y], LIBRARY_RTOL, LIBRARY_ATOL,
                           0.0)[0]:
            fail("F.multi_head_attention_forward does not compute the wide "
                 f"attention's function at rate 0 (max abs err {lib_err})")

    # the edge gate at the real data's edge count: random endpoints (about
    # six edges per receiver, sorted by receiver as the loader sorts them)
    g = torch.Generator(device=device).manual_seed(SEED + 8)
    E3 = VOC_REAL_EDGES
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=device)  # noqa: E731
    idx = lambda: torch.randint(0, N, (B, E3), generator=g,  # noqa: E731
                                device=device, dtype=torch.int32)
    big = (rnd(B, N, d), rnd(B, N, 2 * d), rnd(B, E3, d), idx(),
           idx().sort(dim=1).values, torch.ones(B, E3, device=device))
    shapes3 = dict(B=B, N=N, E=E3, d=d, real_nodes=B * N, real_edges=B * E3)
    tag3 = f"voc, E={E3}"
    gf, gb = gate_cases(big, B * E3, B * N,
                        edge_gate_orders_note(torch, big[3], big[4], N, tag3))
    for r in (forward_case(torch, gf, shapes3),
              backward_case(torch, gb, seed, 0.0, shapes3)):
        r["shape"] = tag3
        rows.append(r)

    # a hub receiver (a third of graph 0's edges into node 5), a graph with
    # no real edge (graph 1), stray endpoints (graph 2's every 7th sender,
    # graph 3's every 5th receiver outside [0, N)); then graphs of
    # EDGE_GATE_WIDE_SLOTS node slots, more than the shared-memory kernel
    # before the orders took. Held, not timed (kernel_ab.py times the edge
    # gate on hubs)
    for tag, (Bx, Nx, Ex) in (("voc, hub, empty graph, stray endpoints",
                               (B, N, E)),
                              (f"{EDGE_GATE_WIDE_SLOTS} node slots",
                               EDGE_GATE_WIDE)):
        s_ = torch.randint(0, Nx, (Bx, Ex), generator=g, device=device,
                           dtype=torch.int32)
        r_ = torch.randint(0, Nx, (Bx, Ex), generator=g, device=device,
                           dtype=torch.int32)
        em = (torch.rand(Bx, Ex, generator=g, device=device) < 0.9).float()
        if Nx == N:
            r_[0, torch.randperm(Ex, generator=g, device=device)[:Ex // 3]] = 5
            s_[1], r_[1], em[1] = 0, 0, 0.0
        r_ = r_.sort(dim=1).values
        if Nx == N:
            s_[2, ::7] = Nx + 3
            r_[3, ::5] = -1
        args = (rnd(Bx, Nx, d), rnd(Bx, Nx, 2 * d), rnd(Bx, Ex, d), s_, r_,
                em)
        ok = (r_ >= 0) & (r_ < Nx)
        e_n = int((em.bool() & ok).sum())
        at = dict(B=Bx, N=Nx, E=Ex, d=d, real_nodes=Bx * Nx, real_edges=e_n)
        gf, gb = gate_cases(args, e_n, Bx * Nx,
                            edge_gate_orders_note(torch, s_, r_, Nx, tag))
        for r in (forward_case(torch, gf, at, timed=False),
                  backward_case(torch, gb, seed, 0.0, at, timed=False)):
            r["shape"] = tag
            rows.append(r)
    return cfg, splits, rows, \
        {k: v.clone() for k, v in model.state_dict().items()}


def check_ln_ffn(torch, cfg_path: str, opts, device):
    """Phase 3e: the Graphormer MLP block (``ln_ffn``), forward and backward,
    kernel against plain version, on layer 0's inputs of the recipe
    ``cfg_path`` (``opts`` on top) at its batch size and width: the rows
    after layer 0's attention half, the graph token's included, at every
    rate pair of LN_FFN_RATES. Returns (rows, the seeded model's state
    dict); every row carries ``shape`` and its ``rates``."""
    from graphgps_torch.ops.kernels import ln_ffn
    from graphgps_torch.tools.ln_ffn_inputs import ln_ffn_inputs

    batch, model, ins = ln_ffn_inputs(cfg_path, opts, device)
    B = batch.num_graphs
    (R, d), dh = ins[0].shape, ins[3].shape[1]
    S = R // B
    # the rows whose output is read: real nodes and the graph tokens
    real = int(batch.node_mask.sum()) + B
    shapes = dict(B=B, S=S, R=R, d=d, dh=dh, real_rows=real)
    src = "graphgps_torch/csrc/ln_ffn.cu"
    tpu = "graphgps_tpu/ops/pallas/fused_combine.py"
    tol = (LN_FFN_RTOL, LN_FFN_ATOL)
    cots_for = cotangents(torch, SEED + 9, device)
    rows = []
    for r1, r2 in LN_FFN_RATES:
        conf = (drop_seed(torch, device), r1, r2, "gelu")

        def run(cots=None, conf=conf):
            out, kept = ln_ffn._launch_forward(ins, *conf, ln_ffn.EPS, True)
            cots = cots or cots_for([out])
            return cots, lambda: ln_ffn.ln_ffn_backward(*ins, cots[0], *conf,
                                                        kept=kept)

        sites = [("FFN inner", R, dh, 1)] if r1 > 0 else []
        if r2 > 0:
            sites.append(("FFN outer", R, d, 2))
        fwd = dict(name="ln_ffn", fn=ln_ffn.fused_ln_ffn,
                   plain=ln_ffn.ln_ffn_plain, args=(*ins, *conf), tol=tol,
                   source=src, replaces=f"{tpu}:672",
                   # the two products on the rows that are read (3xTF32
                   # tensor cores)
                   flops=4 * real * d * dh, peak=PEAK_3XTF32)
        bwd = dict(name="ln_ffn_bwd", run=run,
                   plain=lambda c, conf=conf: ln_ffn.ln_ffn_backward_plain(
                       *ins, c[0], *conf),
                   inputs=ins, source=src, replaces=f"{tpu}:713",
                   sites=sites, tol=tol,
                   # dU = dA2 W2^T, dY = dA1 W1^T, dW1 = Y^T dA1, dW2 = Z^T dA2
                   flops=8 * real * d * dh, peak=PEAK_3XTF32)
        # one rate per call: both sites' rates are equal where both are on
        at = dict(shapes, rates=[r1, r2])
        rows += [dict(forward_case(torch, fwd, at), rates=[r1, r2]),
                 dict(backward_case(torch, bwd, DROP_SEED, r1, at),
                      rates=[r1, r2])]
    for r in rows:
        r["shape"] = "zinc-Graphormer"
    return rows, {k: v.clone() for k, v in model.state_dict().items()}


def bn_ffn_cases(torch, ins, rate: float, n_real: int, shapes: dict,
                 tag: str) -> list:
    """The forward and backward rows of ``bn_ffn`` on ``ins`` (s, mu, inv,
    gamma, beta, W1, b1, W2, b2) at dropout ``rate`` (inner site only, as
    SAN takes it), ``n_real`` of the R rows read. The plain backward takes
    relu's derivative on the kernel's side of each kink (its kept a1 > 0):
    a unit the two computations put on different sides must lie within
    KINK_RTOL of the pre-activations' largest entry from 0; their count is
    in the rows (``relu_kink_flips``)."""
    from graphgps_torch.ops.kernels import bn_ffn

    conf = (drop_seed(torch, ins[0].device), rate, "relu", False)
    R, d = ins[0].shape
    dh = ins[5].shape[1]
    src = "graphgps_torch/csrc/bn_ffn.cu"
    tpu = "graphgps_tpu/ops/pallas/fused_combine.py"
    tol = (BN_FFN_RTOL, BN_FFN_ATOL)
    cots_for = cotangents(torch, SEED + 11, ins[0].device)
    with torch.no_grad():
        a1 = bn_ffn._launch_forward(ins, *conf, True)[1][1]
        s, mu, inv, ga, be, w1, b1 = ins[:7]
        a1_plain = ((s - mu) * inv * ga + be) @ w1 + b1
        mask = (a1 > 0).float()
        flips = (a1_plain > 0).float() != mask
        n_flips = int(flips.sum())
        far = float(a1_plain[flips].abs().max()) if n_flips else 0.0
        top = float(a1_plain.abs().max())
    print(json.dumps(dict(shape=tag, rate=rate, relu_kink_flips=n_flips,
                          largest_flipped_preactivation=far,
                          largest_preactivation=top)), flush=True)
    if far > KINK_RTOL * top:
        fail(f"bn_ffn: a relu unit {far} from 0 takes another side in the "
             "kernel than in its plain version")

    def run(cots=None):
        out, kept = bn_ffn._launch_forward(ins, *conf, True)
        cots = cots or cots_for([out])
        return cots, lambda: bn_ffn.bn_ffn_backward(*ins, cots[0], *conf,
                                                    kept=kept)

    fwd = dict(name="bn_ffn", fn=bn_ffn.fused_bn_ffn,
               plain=bn_ffn.bn_ffn_plain, args=(*ins, *conf), tol=tol,
               source=src, replaces=f"{tpu}:440", peak=PEAK_3XTF32,
               # the norm apply (4 per element) and the two products on the
               # rows that are read
               flops=4 * n_real * d * dh + 4 * n_real * d)
    bwd = dict(name="bn_ffn_bwd", run=run,
               plain=lambda c: bn_ffn.bn_ffn_backward_plain(
                   *ins, c[0], *conf, relu_mask=mask),
               inputs=ins, source=src, replaces=f"{tpu}:483",
               peak=PEAK_3XTF32,
               sites=[("FFN inner", R, dh, 1)] if rate > 0 else [], tol=tol,
               # dU = dA2 W2^T, dH = dA1 W1^T, dW1 = H^T dA1, dW2 = U^T dA2;
               # ds and the four column sums
               flops=8 * n_real * d * dh + 10 * n_real * d)
    at = dict(shapes, rate=rate)
    rows = [forward_case(torch, fwd, at), backward_case(torch, bwd, DROP_SEED,
                                                        rate, at)]
    route = "fused" if bn_ffn.takes_fused(d, dh) else "sequence"
    for r in rows:
        r.update(shape=tag, rate=rate, relu_kink_flips=n_flips, ffn_route=route)
    return rows


def check_bn_ffn(torch, cfg_path: str, opts, device):
    """Phase 3f: SAN's norm apply + FFN (``bn_ffn``), forward and backward,
    kernel against plain version, on layer 0's inputs of the recipe
    ``cfg_path`` (``opts`` on top) in training at its batch size and width:
    the attention block's residual sum s = x + O(attention(x)) and the
    attention norm's batch statistics of s, at the recipe's dropout and at
    0; then at the molpcba-SAN width on seeded inputs (every row read).
    Returns (rows, the calibrated model's state dict); every row carries
    ``shape`` and ``rate``."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders

    cfg = new_cfg()
    load_cfg(cfg, cfg_path)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    _real, batch = next(iter(create_loaders(cfg, splits, device)["train"]))
    model = calibrated_san_model(torch, cfg, splits, batch)
    layer, nm = model.layers[0], batch.node_mask
    with torch.no_grad():
        x, e = model.encoder(batch)
        s = x + layer.attn(batch, x, e) @ layer.w_o + layer.b_o
        mu, var = layer.norm1.batch_stats(s, nm)
    ins = tuple(t.detach().contiguous() for t in (
        s, mu, torch.rsqrt(var + layer.eps), layer.norm1.weight,
        layer.norm1.bias, layer.w_ffn1, layer.b_ffn1, layer.w_ffn2,
        layer.b_ffn2))
    B, N = batch.num_graphs, batch.max_nodes
    n_real = int(nm.sum())
    shapes = dict(B=B, N=N, R=B * N, d=layer.dim_h,
                  dh=layer.w_ffn1.shape[1], real_rows=n_real)
    rows = []
    for rate in (cfg.gt.dropout, 0.0):
        rows += bn_ffn_cases(torch, ins, rate, n_real, shapes,
                             "ogbg-molhiv-SAN")

    # the molpcba-SAN width: a residual stream with a per-column offset,
    # its batch statistics, the recipe's layer widths
    g = torch.Generator(device=device).manual_seed(SEED + 10)
    R, d = MOLPCBA_ROWS, MOLPCBA_DIM
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=device)  # noqa: E731
    s = rnd(R, d) * (1.0 + 0.5 * rnd(d).abs()) + 2.0 * rnd(d)
    mu, var = s.mean(0), s.var(0, unbiased=False)
    big = (s, mu, torch.rsqrt(var + 1e-5), 1.0 + 0.1 * rnd(d), 0.1 * rnd(d),
           rnd(d, 2 * d) / d ** 0.5, 0.1 * rnd(2 * d),
           rnd(2 * d, d) / (2 * d) ** 0.5, 0.1 * rnd(d))
    rows += bn_ffn_cases(torch, big, MOLPCBA_RATE, R,
                         dict(B=512, N=40, R=R, d=d, dh=2 * d, real_rows=R),
                         "ogbg-molpcba-SAN width")
    return rows, {k: v.clone() for k, v in model.state_dict().items()}


def ffn_cases(torch, ins, rate: float, act: str, n_real: int,
              shapes: dict, tag: str) -> list:
    """The forward and backward rows of ``ffn`` on ``ins`` (h, W1, b1, W2,
    b2) at dropout ``rate`` on both sites (the GPS layer's ``drop2``) and
    activation ``act``, ``n_real`` of the R rows read. At relu the plain
    version takes the kernel's side of each kink (its a1 > 0), and a unit
    the two put on different sides must lie within KINK_RTOL of the
    pre-activations' largest entry from 0 (``relu_kink_flips`` in the
    rows)."""
    from graphgps_torch.ops.kernels import ffn

    conf = (drop_seed(torch, ins[0].device), rate, act, True)
    R, d = ins[0].shape
    dh = ins[1].shape[1]
    src = "graphgps_torch/csrc/ffn.cu"
    tpu = "graphgps_tpu/ops/pallas/fused_tail.py"
    tol = (FFN_RTOL, FFN_ATOL)
    cots_for = cotangents(torch, SEED + 12, ins[0].device)
    mask, n_flips = None, 0
    if act == "relu":
        with torch.no_grad():
            a1 = ffn._launch_forward(ins, *conf, keep_a1=True)[1]
            a1_plain = ins[0] @ ins[1] + ins[2]
            mask = (a1 > 0).float()
            flips = (a1_plain > 0).float() != mask
            n_flips = int(flips.sum())
            far = float(a1_plain[flips].abs().max()) if n_flips else 0.0
            top = float(a1_plain.abs().max())
        print(json.dumps(dict(shape=tag, rate=rate, relu_kink_flips=n_flips,
                              largest_flipped_preactivation=far,
                              largest_preactivation=top)), flush=True)
        if far > KINK_RTOL * top:
            fail(f"ffn: a relu unit {far} from 0 takes another side in the "
                 "kernel than in its plain version")

    def run(cots=None):
        out = ffn._launch_forward(ins, *conf)
        cots = cots or cots_for([out])
        return cots, lambda: ffn.ffn_backward(*ins, cots[0], *conf)

    # the activation's operations per hidden unit, the bias and dropout's
    act_ops = 8 if act == "gelu" else 1
    fwd = dict(name="ffn", fn=ffn.fused_ffn,
               plain=lambda *a: ffn.ffn_plain(*a, relu_mask=mask),
               args=(*ins, *conf), tol=tol, source=src,
               replaces=f"{tpu}:387", peak=PEAK_3XTF32,
               # the two products on the rows that are read, the bias, act
               # and dropout of the hidden units, the residual
               flops=4 * n_real * d * dh + (act_ops + 2) * n_real * dh
               + 3 * n_real * d)
    bwd = dict(name="ffn_bwd", run=run,
               plain=lambda c: ffn.ffn_backward_plain(
                   *ins, c[0], *conf, relu_mask=mask),
               inputs=ins, source=src, replaces=f"{tpu}:433",
               peak=PEAK_3XTF32,
               sites=([("FFN inner", R, dh, 1), ("FFN outer", R, d, 2)]
                      if rate > 0 else []), tol=tol,
               # a1 = H W1 recomputed, dU = dA2 W2^T, dH = dA1 W1^T,
               # dW1 = H^T dA1, dW2 = Z^T dA2; act', the masks, the sums
               flops=10 * n_real * d * dh + (act_ops + 4) * n_real * dh
               + 3 * n_real * d)
    at = dict(shapes, rate=rate, act=act)
    rows = [forward_case(torch, fwd, at), backward_case(torch, bwd, DROP_SEED,
                                                        rate, at)]
    route = "fused" if ffn.takes_fused(d, dh) else "sequence"
    for r in rows:
        r.update(shape=tag, rate=rate, act=act, relu_kink_flips=n_flips,
                 ffn_route=route)
    return rows


def check_ffn(torch, cfg_path: str, opts, device):
    """Phase 3g: the GPS FFN block (``ffn``), forward and backward, kernel
    against plain version, on layer 0's inputs of the recipe ``cfg_path``
    (``opts`` on top) in training: the branch sum h of the seeded model's
    first layer (the GCN and attention branches with their drop-adds at the
    recipe's rates), at rate 0.2 and 0 with gelu and relu; then at the actor
    width on seeded inputs, and on the launch sequence at d=304. Returns
    (rows, the seeded model's state dict); every row carries ``shape``,
    ``rate``, ``act`` and ``ffn_route``."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.models.networks import build_model

    cfg = new_cfg()
    load_cfg(cfg, cfg_path)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    _real, batch = next(iter(create_loaders(cfg, splits, device)["train"]))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg, infer_dims(cfg, splits))
    model = model.to(device).train()
    layer = model.layers[0]
    gen = torch.Generator().manual_seed(DROP_SEED)
    with torch.no_grad():
        x, e = model.encoder(batch, gen)
        h, _ = layer.branch_sum(batch, x, e, [drop_seed(torch, device, i)
                                             for i in range(3)])
    ins = tuple(t.detach().contiguous() for t in (
        h, layer.w_ffn1, layer.b_ffn1, layer.w_ffn2, layer.b_ffn2))
    n_real = int(batch.node_mask.sum())
    R, d = h.shape
    shapes = dict(B=batch.num_graphs, N=batch.max_nodes, R=R, d=d,
                  dh=2 * d, real_rows=n_real)
    # the attention branch's drop-add at the recipe's rate (Q: x and the
    # chunked attention's output), printed, not returned
    with torch.no_grad():
        h_attn = layer.attention(batch, x, drop_seed(torch, device, 1))
    da = drop_add_cases(torch, x, h_attn, drop_seed(torch, device),
                        cfg.gt.dropout, cotangents(torch, SEED + 19, device))
    at = dict(shapes, path="wn-squirrel")
    forward_case(torch, da[0], at)
    backward_case(torch, da[1], DROP_SEED, cfg.gt.dropout, at)
    rows = []
    for act in ("gelu", "relu"):
        for rate in (cfg.gt.dropout, 0.0):
            rows += ffn_cases(torch, ins, rate, act, n_real, shapes,
                              "wn-squirrel")
    g = torch.Generator(device=device).manual_seed(SEED + 13)
    R, d = ACTOR_ROWS, ACTOR_DIM
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=device)  # noqa: E731
    actor = (rnd(R, d), rnd(d, 2 * d) / d ** 0.5, 0.1 * rnd(2 * d),
             rnd(2 * d, d) / (2 * d) ** 0.5, 0.1 * rnd(d))
    rows += ffn_cases(torch, actor, 0.2, "gelu", R,
                      dict(B=1, N=R, R=R, d=d, dh=2 * d, real_rows=R),
                      "actor width")
    R, d = MOLPCBA_ROWS, MOLPCBA_DIM
    wide = (rnd(R, d), rnd(d, 2 * d) / d ** 0.5, 0.1 * rnd(2 * d),
            rnd(2 * d, d) / (2 * d) ** 0.5, 0.1 * rnd(d))
    rows += ffn_cases(torch, wide, MOLPCBA_RATE, "gelu", R,
                      dict(B=1, N=R, R=R, d=d, dh=2 * d, real_rows=R),
                      "d=304")
    return rows, {k: v.clone() for k, v in model.state_dict().items()}


def library_mha_call(torch, x, counts, wqkv, bqkv, wo, bo, H: int):
    """(call(rate, *leaves), its leaves, backward(rate)): one
    ``F.multi_head_attention_forward`` that computes the QKV projection, the
    key-masked attention, dropout on the probabilities and the
    out-projection -- the yardstick of the GPS attention's rows. It takes
    (N, B, d), (out, in) weights and a mask of the padded keys (a graph
    with no real node attends over all its slots, as the kernels' does);
    its dropout bits are its own, so at a rate above 0 only its time
    compares. Timed here, used nowhere in the port."""
    import torch.nn.functional as F

    B, N, d = x.shape
    n_keys = torch.where(counts > 0, counts, N)
    padded = torch.arange(N, device=x.device)[None, :] >= n_keys[:, None]
    leaves = [t.contiguous() for t in (x.transpose(0, 1), wqkv.t(), bqkv,
                                       wo.t(), bo)]

    def call(rate, xt, w_in, b_in, w_out, b_out):
        return F.multi_head_attention_forward(
            xt, xt, xt, d, H, w_in, b_in, None, None, False, rate, w_out,
            b_out, training=True, key_padding_mask=padded,
            need_weights=False)[0]

    def backward(rate):
        ls = [t.clone().requires_grad_() for t in leaves]
        y = call(rate, *ls)
        return lambda cots: lambda: torch.autograd.grad(
            y, ls, cots[0].transpose(0, 1), retain_graph=True)

    return call, leaves, backward


def gps_attention_cases(torch, ins, H: int, rates, tag: str):
    """The fused attention rung's rows on ``ins`` (x, kmask, wqkv, bqkv, wo,
    bo) at each of ``rates``: forward and backward against the plain
    version at phase 3d's tolerances for the attention rows, with
    ``F.multi_head_attention_forward`` held against the kernel at rate 0
    and timed as ``library_ms``. Every row carries ``shape=tag`` and
    ``attn_rate``."""
    from graphgps_torch.ops.kernels import gps_attention as ga

    x, kmask = ins[:2]
    B, N, d = x.shape
    counts = kmask.sum(1).to(torch.int32)
    n_real = int(counts.sum())
    pairs = int((counts.long() ** 2).sum())   # real (query, key) pairs
    call, lib_in, lib_backward = library_mha_call(torch, x, counts, *ins[2:],
                                                  H)
    cots_for = cotangents(torch, SEED + 14, x.device)
    src = "graphgps_torch/csrc/gps_attention.cu"
    tpu = "graphgps_tpu/ops/pallas/fused_gps_attn.py"
    tol = (LONG_RTOL, LONG_ATOL)
    shapes = dict(B=B, N=N, d=d, H=H, real_nodes=n_real)
    rows = []
    for rate in rates:
        conf = (drop_seed(torch, x.device), H, rate)

        def run(cots=None, conf=conf):
            y, kept = ga._launch_forward(ins, *conf)
            cots = cots or cots_for([y])
            return cots, lambda: ga.gps_attention_backward(
                *ins, *conf, cots[0], kept=kept)

        fwd = dict(name="gps_attention", fn=ga.fused_gps_attention,
                   plain=ga.gps_attention_plain, args=(*ins, *conf), tol=tol,
                   source=src, replaces=f"{tpu}:279",
                   library=lambda rate=rate: call(rate, *lib_in),
                   # the two projections on the real rows, q k^T and P v
                   # over the real (query, key) pairs per head (3xTF32
                   # tensor cores)
                   flops=8 * n_real * d * d + 4 * pairs * d,
                   peak=PEAK_3XTF32)
        bwd = dict(name="gps_attention_bwd", run=run,
                   plain=lambda c, conf=conf: ga.gps_attention_backward_plain(
                       *ins, *conf, c[0]),
                   inputs=ins, source=src, replaces=f"{tpu}:330",
                   sites=[("attention P", B * H * N, N)] if rate > 0 else [],
                   library=lib_backward(rate),
                   # dO, dWo, dx, dWqkv on the real rows (qkv and o kept),
                   # and per head the logits again, dP, dq, dk, dv
                   flops=16 * n_real * d * d + 10 * pairs * d,
                   peak=PEAK_3XTF32)
        at = dict(shapes, attn_rate=rate)
        rows += [dict(forward_case(torch, fwd, at), attn_rate=rate),
                 dict(backward_case(torch, bwd, DROP_SEED, rate, at),
                      attn_rate=rate)]
    with torch.no_grad():
        y = ga.fused_gps_attention(*ins, DROP_SEED, H, 0.0)
        y_lib = call(0.0, *lib_in).transpose(0, 1)
        lib_err = float((y - y_lib).abs().max())
    print(json.dumps(dict(
        note="F.multi_head_attention_forward against gps_attention at rate "
             "0; not used in the port", library_vs_kernel_max_abs_err=lib_err,
        rtol=LIBRARY_RTOL, atol=f"{LIBRARY_ATOL} x max|entry|", shape=tag,
        shapes=shapes)), flush=True)
    if not grads_close(torch, [y_lib], [y], LIBRARY_RTOL, LIBRARY_ATOL,
                       0.0)[0]:
        fail("F.multi_head_attention_forward does not compute the GPS "
             f"attention's function at rate 0 on {tag} (max abs err "
             f"{lib_err})")
    for r in rows:
        r["shape"] = tag
    return rows


def check_gps_attention(torch, layer0, device):
    """Phase 3h: the GPS layer's fused attention rung (``gps_attention``),
    forward and backward, kernel against plain version, on layer 0's inputs
    of the first main path (GPS-deep: batch 256, 40 node slots, d=256, 8
    heads; the calibrated model's weights, the ``[Wq|Wk|Wv]`` columns of its
    joint front weight) at the recipe's attention dropout 0.1 and at 0; then
    at the pcqm4m-GPS width (d=304, 4 heads, its attention dropout 0.5) on
    seeded inputs with the same node masks, a shape the kernel takes and
    JAX's envelope (d % 128 == 0) keeps off the rung; then at the edge of
    that envelope (128 node slots, heads of 64) at 0.1. Returns the rows."""
    L = layer0
    d, H = L["d"], L["H"]
    front = L["front"]
    x, nmask, wnq, bnq, wo, bo = (front[i] for i in (0, 5, 9, 10, 13, 14))
    ins = (x, nmask, wnq[:, 4 * d:].contiguous(), bnq[4 * d:].contiguous(),
           wo, bo)
    rows = gps_attention_cases(torch, ins, H, (DROP_RATE, 0.0),
                               "pcqm4m-GPSdeep")
    g = torch.Generator(device=device).manual_seed(SEED + 17)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=device)  # noqa: E731
    dp = PCQM_GPS_DIM
    wide = (rnd(*x.shape[:2], dp), nmask, rnd(dp, 3 * dp) / dp ** 0.5,
            0.1 * rnd(3 * dp), rnd(dp, dp) / dp ** 0.5, 0.1 * rnd(dp))
    rows += gps_attention_cases(torch, wide, PCQM_GPS_HEADS,
                                (PCQM_GPS_ATTN_RATE,), "pcqm4m-GPS width")
    Bn, Nn, de = EDGE_GRAPHS, EDGE_SLOTS, EDGE_DIM
    counts = torch.randint(Nn // 2, Nn + 1, (Bn,), generator=g,
                           device=device)
    emask = (torch.arange(Nn, device=device)[None] < counts[:, None]).float()
    edge = (rnd(Bn, Nn, de), emask, rnd(de, 3 * de) / de ** 0.5,
            0.1 * rnd(3 * de), rnd(de, de) / de ** 0.5, 0.1 * rnd(de))
    return rows + gps_attention_cases(torch, edge, EDGE_HEADS, (DROP_RATE,),
                                      "128 slots, heads of 64")


def flash_cases(torch, q, k, v, mask, bias, tag: str):
    """The flash attention's rows on (q, k, v, mask, bias): forward and
    backward against the plain version, the forward also within
    FLASH_F64_ULPS of the plain version in f64 rounded to f32, and
    ``F.scaled_dot_product_attention`` with the same logits' mask (the
    boolean same-segment mask; with a bias, the float mask bias·scale plus
    the library's mask value across segments) held against the kernel and
    timed as ``library_ms`` (used nowhere in the port)."""
    import torch.nn.functional as F
    from graphgps_torch.ops.kernels.flash_mha import (
        MASK_VALUE, _launch_forward, f32_ulps, flash_mha, flash_mha_backward,
        flash_mha_backward_plain, flash_mha_plain)

    B, H, N, Dh = q.shape
    scale = 1.0 / float(Dh) ** 0.5
    ids = mask.to(torch.int32)
    same = (ids[:, :, None] == ids[:, None, :])[:, None]
    attn_mask = same if bias is None else (
        bias * scale + torch.where(same, 0.0, MASK_VALUE))
    # (query, key) pairs with weight: the same segment
    n = mask.sum(1).double()
    pairs = int((n ** 2 + (N - n) ** 2).sum()) * H
    src = "graphgps_torch/csrc/flash_mha.cu"
    tpu = "graphgps_tpu/ops/pallas/flash_mha.py"
    tol = (LONG_RTOL, LONG_ATOL)
    cots_for = cotangents(torch, SEED + 15, q.device)
    ins = (q, k, v, mask, bias)
    grads = lambda g: tuple(t for t in g if t is not None)  # noqa: E731

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                              scale=scale)

    def library_backward(cots):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        lm = attn_mask
        if bias is not None:
            lm = attn_mask.clone().requires_grad_()
            leaves.append(lm)
        y = F.scaled_dot_product_attention(*leaves[:3], attn_mask=lm,
                                           scale=scale)
        return lambda: torch.autograd.grad(y, leaves, cots[0],
                                           retain_graph=True)

    def run(cots=None):
        o, kept = _launch_forward(*ins)
        cots = cots or cots_for([o])
        return cots, lambda: grads(flash_mha_backward(*ins, o, cots[0],
                                                      kept=kept))

    fwd = dict(name="flash_mha", fn=flash_mha, plain=flash_mha_plain,
               args=ins, tol=tol, source=src, replaces=f"{tpu}:67",
               library=library, peak=PEAK_F64_TC,
               # q k^T and P v over the pairs with weight (f64 tensor cores)
               flops=4 * pairs * Dh)
    bwd = dict(name="flash_mha_bwd", run=run,
               plain=lambda c: grads(flash_mha_backward_plain(*ins, c[0])),
               inputs=[t for t in ins if t is not None], source=src,
               replaces=f"{tpu}:67 (the library's backward)", sites=[],
               library=lambda cots: library_backward(cots), peak=PEAK_3XTF32,
               # the logits again, dP, dv, dq, dk over the pairs
               flops=10 * pairs * Dh)
    at = dict(B=B, H=H, N=N, Dh=Dh, real_nodes=int(mask.sum()),
              bias=bias is not None)
    rows = [forward_case(torch, fwd, at),
            backward_case(torch, bwd, DROP_SEED, 0.0, at)]
    with torch.no_grad():
        y = flash_mha(*ins)
        y_lib = library()
        lib_err = float((y - y_lib).abs().max())
        y64 = flash_mha_plain(*(None if t is None else t.double()
                                for t in (q, k, v)), mask,
                              None if bias is None else bias.double())
        ulps = f32_ulps(y, y64.float())
    print(json.dumps(dict(
        note="flash_mha's forward against the plain version in f64 rounded "
             "to f32", max_ulps=int(ulps.max()),
        entries_differing=int((ulps > 0).sum()), entries=ulps.numel(),
        ulps_allowed=FLASH_F64_ULPS, shape=tag, shapes=at)), flush=True)
    if int(ulps.max()) > FLASH_F64_ULPS:
        fail(f"flash_mha on {tag}: an output entry {int(ulps.max())} f32 "
             "ulps from the plain version in f64 rounded to f32")
    print(json.dumps(dict(
        note="F.scaled_dot_product_attention against flash_mha; not used in "
             "the port", library_vs_kernel_max_abs_err=lib_err,
        rtol=LIBRARY_RTOL, atol=f"{LIBRARY_ATOL} x max|entry|", shape=tag,
        shapes=at)), flush=True)
    if not grads_close(torch, [y_lib], [y], LIBRARY_RTOL, LIBRARY_ATOL,
                       0.0)[0]:
        fail("F.scaled_dot_product_attention does not compute the flash "
             f"attention's function on {tag} (max abs err {lib_err})")
    for r in rows:
        r.update(shape=tag, bias=bias is not None)
    return rows


def check_flash(torch, cfg_path: str, opts, state, device):
    """Phase 3i: the flash attention (``flash_mha``), forward and backward,
    kernel against plain version, on layer 0's q, k, v of the recipe
    ``cfg_path`` (``opts`` on top; VOC superpixels: batch 32, 512 node slots
    with 400-500 real, 4 heads of 24; the calibrated model ``state``)
    without a bias (the GPS layer's use) and with a seeded one, then at
    wn-squirrel's one graph (5,248 slots, 5,201 real, 4 heads of 24) on
    seeded inputs. Returns the rows; every row carries ``shape`` and
    ``bias``."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders
    from graphgps_torch.ops.mha import split_heads

    cfg = new_cfg()
    load_cfg(cfg, cfg_path)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    _real, batch = next(iter(create_loaders(cfg, splits, device)["train"]))
    model = seeded_model(torch, cfg, splits, batch)
    model.load_state_dict(state)
    layer = model.layers[0]
    d, H = layer.dim_h, layer.num_heads
    with torch.no_grad():
        x, _ = model.encoder(batch)
        w, b = layer.qkv_proj()
        qkv = batch.dense_view(x) @ w + b
        q, k, v = (split_heads(qkv[..., i * d:(i + 1) * d], H).contiguous()
                   for i in range(3))
    mask = batch.dense_view(batch.node_mask)
    if bool(mask.all()):
        fail("phase 3i: the VOC batch holds no padded node slot")
    g = torch.Generator(device=device).manual_seed(SEED + 16)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=device)  # noqa: E731
    rows = flash_cases(torch, q, k, v, mask, None, "voc")
    rows += flash_cases(torch, q, k, v, mask, rnd(*q.shape[:3], q.shape[2]),
                        "voc")
    N, Dh = SQUIRREL_SLOTS, d // H
    sq_mask = torch.arange(N, device=device)[None, :] < SQUIRREL_NODES
    rows += flash_cases(torch, *(rnd(1, H, N, Dh) for _ in range(3)),
                        sq_mask, None, "wn-squirrel")
    # heads of a width no multiple of 8, and slots no multiple of the
    # 64-row tiles (with a bias), on seeded inputs with VOC's real counts
    for (Bs, Ns, Ds, bias), tag in FLASH_ODD_CASES:
        counts = torch.randint(400, 501, (Bs,), generator=g, device=device)
        mask = torch.arange(Ns, device=device)[None, :] < counts[:, None]
        qkv = [rnd(Bs, H, Ns, Ds) for _ in range(3)]
        rows += flash_cases(torch, *qkv, mask,
                            rnd(Bs, H, Ns, Ns) if bias else None, tag)
    return rows


# the CUDA kernel names of the L2 flush (``flush.fill_``), profiled once
FLUSH_NAMES = set()


def l2_flush(torch, device):
    """A tensor larger than the 50 MB L2 cache, written between L2-cold
    calls."""
    return torch.empty(L2_FLUSH_BYTES // 4, device=device)


def cold_device_ms(torch, fn, flush, iters: int = 20) -> float:
    """Device ms of one call of ``fn`` with the L2 cache flushed before it
    (``flush``, larger than the 50 MB L2, written between calls), as
    ``device_ms`` counts it; the flush's own kernels are left out by
    name (learnt from the first call's profile of the flush alone)."""
    if not FLUSH_NAMES:
        # a profile of one kernel can lose its one event: the flush, iters
        # times
        rows, _ = profiled_rows(torch, lambda: [flush.fill_(0.0)
                                                for _ in range(iters)])
        if rows is None:
            fail(f"the profiler recorded no device time of the L2 flush in "
                 f"{PROFILER_TRIES} runs")
        FLUSH_NAMES.update(r[0] for r in rows)
    fn()
    torch.cuda.synchronize()

    def body():
        for _ in range(iters):
            flush.fill_(0.0)
            fn()

    rows, _ = profiled_rows(torch, body)
    if rows is None:
        fail(f"the profiler recorded no device time of L2-cold calls in "
             f"{PROFILER_TRIES} runs")
    return sum(total / seen * -(-seen // iters) for name, total, seen in rows
               if name not in FLUSH_NAMES) / 1e3


def plan_check(torch, ks, plan, ids, S: int, tiled: bool, what: str):
    """The plan kernel's perm, ptr and chunk table equal to its plain
    version's on the same ids, and its tickets at 0."""
    for got, want in zip((plan.perm, plan.ptr, plan.chunk_seg),
                         ks.plan_plain(ids, S, tiled, plan.task_len)):
        if not ((got is None and want is None)
                or (got is not None and torch.equal(got, want))):
            fail(f"segment_plan disagrees with its plain version ({what})")
    if bool(plan.tickets.any()):
        fail(f"segment_plan: tickets not at 0 after the sums ({what})")


def segment_cases(torch, data, ids, S: int, tag: str, flush,
                  names=("segment_csr", "segment_tiled")):
    """The segment sums' rows on (data (E, d), ids (E,)): the tiled wrapper
    on ``ids`` as given, the CSR wrapper on them sorted (with the data rows
    in the same order), each on its plan built beforehand, against its plain
    version and against ``Tensor.index_add``, the one PyTorch call for the
    same function (its ``library_ms``; used nowhere in the port), with two
    runs equal in every bit. Each row also carries the plan's ms, the ms a
    call with the plan built once for SEGMENT_CALLS_PER_PLAN calls (as a
    wn-squirrel step shares it across its layers), and the kernel's and
    ``index_add``'s ms with the L2 cache flushed before each call; and the
    plan kernel is held against its plain version."""
    from graphgps_torch.ops.kernels import segment_sum as ks

    E, d = data.shape
    order = torch.argsort(ids, stable=True)
    sids, sdata = ids[order].contiguous(), data[order].contiguous()
    row_ptr = ks.row_ptr_from_sorted(sids, S)
    src = "graphgps_torch/csrc/segment_sum.cu"
    tpu = "graphgps_tpu/ops/pallas"
    zeros = torch.zeros((S, d), device=data.device)
    counts = torch.bincount(ids.long(), minlength=S)
    at = dict(E=E, S=S, d=d, largest_segment=int(counts.max()),
              empty_segments=int((counts == 0).sum()),
              split_segments=int((counts > ks.TASK_LEN).sum()),
              task_len=ks.TASK_LEN)
    plans = dict(segment_csr=ks.segment_plan(sids, S, tiled=False),
                 segment_tiled=ks.segment_plan(ids, S, tiled=True))
    cases = [
        dict(name="segment_csr", plan_ids=sids, tiled=False,
             call=lambda plan: ks.segment_sum_csr(sdata, sids, row_ptr, S,
                                                  plan=plan),
             plain=ks.segment_sum_csr_plain, args=(sdata, sids, row_ptr, S),
             source=src, replaces=f"{tpu}/segment_csr.py:155",
             library=lambda: zeros.index_add(0, sids.long(), sdata)),
        dict(name="segment_tiled", plan_ids=ids, tiled=True,
             call=lambda plan: ks.tiled_segment_sum(data, ids, S, plan=plan),
             plain=ks.tiled_segment_sum_plain, args=(data, ids, S),
             source=src, replaces=f"{tpu}/segment_tiled.py:100",
             library=lambda: zeros.index_add(0, ids.long(), data))]
    rows = []
    for c in (c for c in cases if c["name"] in names):
        plan = plans[c["name"]]
        c.update(tol=(SEGMENT_RTOL, SEGMENT_ATOL), flops=E * d,   # one add
                 fn=lambda *_a, c=c, plan=plan: c["call"](plan))
        with torch.no_grad():
            once, twice = c["fn"](), c["fn"]()
            lib = c["library"]()
        same = bool(torch.equal(once, twice))
        lib_ok, lib_err, _ = grads_close(torch, [lib], [once], SEGMENT_RTOL,
                                         SEGMENT_ATOL, 0.0)
        row = forward_case(torch, c, at)
        plan_check(torch, ks, plan, c["plan_ids"], S, c["tiled"], tag)

        def build(c=c):
            return ks.segment_plan(c["plan_ids"], S, c["tiled"])

        def amortized(c=c):
            fresh = build()
            for _ in range(SEGMENT_CALLS_PER_PLAN):
                c["call"](fresh)

        extra = dict(
            plan_ms=device_ms(torch, build)[0],
            amortized_ms=device_ms(torch, amortized)[0]
            / SEGMENT_CALLS_PER_PLAN,
            calls_per_plan=SEGMENT_CALLS_PER_PLAN,
            cold_ms=cold_device_ms(torch, c["fn"], flush),
            cold_library_ms=cold_device_ms(torch, c["library"], flush))
        row.update(shape=tag, bit_identical_reruns=same, **extra)
        print(json.dumps(dict(name=c["name"], shape=tag,
                              bit_identical_reruns=same,
                              library_vs_kernel_max_abs_err=lib_err,
                              **extra)), flush=True)
        if not same:
            fail(f"{c['name']}: two runs on the same inputs differ ({tag})")
        if not lib_ok:
            fail(f"index_add does not compute {c['name']}'s function on "
                 f"{tag} (max abs err {lib_err})")
        rows.append(row)
    return rows


def segment_plan_row(torch, ids, S: int, tag: str) -> dict:
    """The plan kernel's row on sorted ``ids`` (the CSR plan: pointers, the
    sort's check, the chunk table, the tickets zeroed) against its plain
    version, with ``torch.searchsorted`` of the segment bounds, the one
    PyTorch call for the pointers, as its ``library_ms``."""
    from graphgps_torch.ops.kernels import segment_sum as ks

    E = ids.shape[0]
    plan = ks.segment_plan(ids, S, tiled=False)
    plan_check(torch, ks, plan, ids, S, False, tag)
    bounds = torch.arange(S + 1, device=ids.device, dtype=ids.dtype)
    n_bytes = 4 * (E + (S + 1) + S + plan.chunk_seg.shape[0])
    row = dict(name="segment_plan", route="cuda",
               source="graphgps_torch/csrc/segment_sum.cu",
               replaces="graphgps_tpu/ops/pallas/segment_csr.py:172",
               max_abs_err=0, rtol=0, atol=0,
               **timings(torch, lambda: ks.segment_plan(ids, S, tiled=False),
                         lambda: ks.plan_plain(ids, S, False),
                         lambda: torch.searchsorted(ids, bounds,
                                                    out_int32=True)),
               **bound(n_bytes, 0),
               shapes=dict(E=E, S=S, task_len=ks.TASK_LEN), shape=tag)
    print(json.dumps(row), flush=True)
    return row


def check_segment(torch, cfg_path: str, opts, state, device):
    """Phase 3j: the segment sums (``segment_csr``, ``segment_tiled``), one
    CUDA kernel behind two wrappers, forward (their backward is a gather),
    kernel against plain version and ``index_add``, on layer 0's GCN
    messages of the recipe ``cfg_path`` (``opts`` on top; wn-squirrel: one
    graph of 5,248 node slots, the edge slots of its ~41,600 edges, d=96;
    the seeded model ``state``) into the receivers, and for the tiled one
    also a cotangent of the messages into the senders (the gather's
    backward); then on seeded inputs with hub segments (a power law over
    S = 5,248), with every edge in one segment, and at MalNet's size,
    uniform and with hubs; and the plan kernel (``segment_plan``) on the
    receivers. Returns the rows; every row carries ``shape``."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders

    cfg = new_cfg()
    load_cfg(cfg, cfg_path)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    _real, batch = next(iter(create_loaders(cfg, splits, device)["train"]))
    model = seeded_model(torch, cfg, splits, batch)
    model.load_state_dict(state)
    gcn = model.layers[0].local
    S = batch.num_node_slots
    s, r = batch.senders, batch.receivers
    with torch.no_grad():
        x, _ = model.encoder(batch)
        h = x @ gcn.w + gcn.b
        deg = torch.zeros(S, device=device).index_add_(
            0, r.long(), batch.edge_mask.float()) + 1.0
        dinv = torch.rsqrt(deg)
        msgs = h[s.long()] * dinv[s.long(), None] * dinv[r.long(), None]
        msgs = torch.where(batch.edge_mask[:, None], msgs, 0.0).contiguous()
    flush = l2_flush(torch, device)
    rows = segment_cases(torch, msgs, r, S, "wn-squirrel", flush)
    rows.append(segment_plan_row(torch, r, S, "wn-squirrel"))
    g = torch.Generator(device=device).manual_seed(SEED + 18)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=device)  # noqa: E731

    def power_law(n_edges: int, n_segments: int):
        p = 1.0 / torch.arange(1, n_segments + 1, device=device,
                               dtype=torch.float64)
        return torch.multinomial(p / p.sum(), n_edges, replacement=True,
                                 generator=g).to(torch.int32)

    rows += segment_cases(torch, rnd(*msgs.shape), s, S,
                          "wn-squirrel senders", flush,
                          names=("segment_tiled",))
    d = msgs.shape[1]
    rows += segment_cases(torch, rnd(SKEW_EDGES, d), power_law(SKEW_EDGES, S),
                          S, "hub-skewed", flush)
    one = torch.full((SKEW_EDGES,), S // 2, device=device, dtype=torch.int32)
    rows += segment_cases(torch, rnd(SKEW_EDGES, d), one, S, "one segment",
                          flush)
    ids = torch.randint(0, MALNET_NODES, (MALNET_EDGES,), generator=g,
                        device=device, dtype=torch.int32)
    rows += segment_cases(torch, rnd(MALNET_EDGES, MALNET_DIM), ids,
                          MALNET_NODES, "MalNet size", flush)
    rows += segment_cases(torch, rnd(MALNET_EDGES, MALNET_DIM),
                          power_law(MALNET_EDGES, MALNET_NODES), MALNET_NODES,
                          "MalNet hubs", flush)
    return rows


def bigbird_cases(torch, q, k, v, mask, seed: int, tag: str):
    """BigBird's rows on (q, k, v, mask) with the plan of ``seed``: forward
    and backward against the plain version, and
    ``F.scaled_dot_product_attention`` with the boolean mask of allowed
    pairs (the plan and the same segment) held against the kernel and timed
    as ``library_ms`` (used nowhere in the port)."""
    import torch.nn.functional as F
    from graphgps_torch.ops.kernels import bigbird as kb

    from graphgps_torch.ops.bigbird import plan_mask

    B, H, N, Dh = q.shape
    bs, rb = BIGBIRD_BLOCK, BIGBIRD_RANDOM
    ids = mask.to(torch.int32)
    allowed = plan_mask(N, bs, rb, seed, q.device)[None] & (
        ids[:, :, None] == ids[:, None, :])
    attn_mask = allowed[:, None]
    pairs = int(allowed.sum()) * H          # allowed (query, key) pairs
    scale = 1.0 / float(Dh) ** 0.5
    ins = (q, k, v, mask, bs, rb, seed)
    src = "graphgps_torch/csrc/bigbird.cu"
    tpu = "graphgps_tpu/ops/pallas/splash_bigbird.py:87"
    tol = (LONG_RTOL, LONG_ATOL)
    cots_for = cotangents(torch, SEED + 19, q.device)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                              scale=scale)

    def library_backward(cots):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        y = F.scaled_dot_product_attention(*leaves, attn_mask=attn_mask,
                                           scale=scale)
        return lambda: torch.autograd.grad(y, leaves, cots[0],
                                           retain_graph=True)

    def run(cots=None):
        o, kept = kb._launch_forward(*ins)
        cots = cots or cots_for([o])
        return cots, lambda: kb.bigbird_backward(*ins, o, cots[0], kept=kept)

    fwd = dict(name="bigbird", fn=kb.bigbird_block_sparse,
               plain=kb.bigbird_plain, args=ins, tol=tol, source=src,
               replaces=tpu, library=library,
               # q k^T and P v over the allowed pairs
               flops=4 * pairs * Dh)
    bwd = dict(name="bigbird_bwd", run=run,
               plain=lambda c: kb.bigbird_backward_plain(*ins, c[0]),
               inputs=[q, k, v, mask], source=src,
               replaces=f"{tpu} (the library's backward)", sites=[], tol=tol,
               library=library_backward,
               # the logits again, dP, dv, dq, dk over the allowed pairs
               flops=10 * pairs * Dh)
    at = dict(B=B, H=H, N=N, Dh=Dh, real_nodes=int(mask.sum()), seed=seed,
              block=bs, random_blocks=rb, allowed_pairs=pairs)
    rows = [forward_case(torch, fwd, at),
            backward_case(torch, bwd, DROP_SEED, 0.0, at)]
    with torch.no_grad():
        y = kb.bigbird_block_sparse(*ins)
        y_lib = library()
        lib_err = float((y - y_lib).abs().max())
    print(json.dumps(dict(
        note="F.scaled_dot_product_attention against bigbird; not used in "
             "the port", library_vs_kernel_max_abs_err=lib_err,
        rtol=LIBRARY_RTOL, atol=f"{LIBRARY_ATOL} x max|entry|", shape=tag,
        shapes=at)), flush=True)
    if not grads_close(torch, [y_lib], [y], LIBRARY_RTOL, LIBRARY_ATOL,
                       0.0)[0]:
        fail("F.scaled_dot_product_attention does not compute BigBird's "
             f"function on {tag} (max abs err {lib_err})")
    for r in rows:
        r.update(shape=tag, seed=seed)
    return rows


def check_bigbird(torch, device, H: int, Dh: int):
    """Phase 3k: BigBird's block-sparse attention (``bigbird``), forward and
    backward, kernel against plain version, on seeded inputs at
    wn-squirrel's one graph (5,248 slots, 5,201 real, ``H`` heads of ``Dh``,
    block 3, 3 random blocks) with the plans of the recipe's three layers,
    and at 4 graphs of 2,048 slots with 1,900-2,048 real. Returns the rows;
    every row carries ``shape`` and ``seed``."""
    g = torch.Generator(device=device).manual_seed(SEED + 20)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=device)  # noqa: E731
    N = SQUIRREL_SLOTS
    mask = torch.arange(N, device=device)[None, :] < SQUIRREL_NODES
    rows = []
    for seed in BIGBIRD_SEEDS:
        rows += bigbird_cases(torch, *(rnd(1, H, N, Dh) for _ in range(3)),
                              mask, seed, "wn-squirrel")
    B, N = BIGBIRD_GRAPHS, BIGBIRD_SLOTS
    counts = torch.randint(BIGBIRD_MIN_REAL, N + 1, (B,), generator=g,
                           device=device)
    counts[-1] = N
    mask = torch.arange(N, device=device)[None, :] < counts[:, None]
    rows += bigbird_cases(torch, *(rnd(B, H, N, Dh) for _ in range(3)),
                          mask, 0, "4 graphs of 2,048 slots")
    return rows


def check_rung_switch(torch, name: str, cfg_path: str, opts, state, device,
                      settings, tables):
    """One calibrated model's evaluation predictions on one val batch under
    each of two ``settings`` (callables that switch the model's path), with
    the launches of each: equal on every real row (graph or node) within
    MODEL_RTOL and MODEL_ATOL, and each run's launches per layer what its
    table in ``tables`` says. Each run takes its own copy of the batch, so
    per-batch state (the edge gate's orders) is built in each, as for a new
    batch."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders
    from graphgps_torch.ops import kernels
    from graphgps_torch.train.loop import loss_mask

    cfg = new_cfg()
    load_cfg(cfg, cfg_path)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    _real, batch = next(iter(create_loaders(cfg, splits, device)["val"]))
    model = seeded_model(torch, cfg, splits, batch)
    model.load_state_dict(state)
    preds = []
    for setting, table in zip(settings, tables):
        kernels.reset_launch_counts()
        with setting(model), torch.no_grad():
            preds.append(model(dataclasses.replace(batch))[0])
        counts = kernels.launch_counts()
        check_launches(f"{name} evaluation, {setting.__name__}", counts,
                       expected_launches(table, layers_of(cfg), 0, 1,
                                         counts))
    m = loss_mask(batch, preds[0])
    a, b = preds[0][m], preds[1][m]
    err = float((a - b).abs().max())
    print(json.dumps(dict(path=name, rung_switch=[s.__name__ for s in
                                                  settings],
                          max_abs_err=err, rtol=MODEL_RTOL, atol=MODEL_ATOL,
                          rows=int(m.sum()))), flush=True)
    if not (torch.isfinite(a).all() and torch.allclose(
            b, a, rtol=MODEL_RTOL, atol=MODEL_ATOL)):
        fail(f"{name}: the predictions of {settings[0].__name__} and "
             f"{settings[1].__name__} differ (max abs err {err})")


@contextlib.contextmanager
def env_set(key: str, value: str):
    """``os.environ[key] = value`` for the duration (the JAX package's
    switches are read per call)."""
    old = os.environ.get(key)
    os.environ[key] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(key)
        else:
            os.environ[key] = old


def merged_front(model):
    return contextlib.nullcontext()


def front_off(model):
    return env_set(*FRONT_OFF)


@contextlib.contextmanager
def attn_impl(model, impl: str):
    old = [layer.attn_impl for layer in model.layers]
    for layer in model.layers:
        layer.attn_impl = impl
    try:
        yield
    finally:
        for layer, o in zip(model.layers, old):
            layer.attn_impl = o


def attn_auto(model):
    return attn_impl(model, "auto")


def attn_flash(model):
    return attn_impl(model, "flash")


def segment_index_add(model):
    return contextlib.nullcontext()


def segment_tiled(model):
    return env_set(*TILED_ON)


def segment_csr(model):
    return env_set(*CSR_ON)


def bigbird_kernel(model):
    return contextlib.nullcontext()


@contextlib.contextmanager
def bigbird_dense(model):
    """BigBird's dense path on the card: the splash threshold
    (``GGPS_SPLASH_MIN_N``, read at import) raised above any graph."""
    from graphgps_torch.ops import bigbird

    old = bigbird.SPLASH_MIN_N
    bigbird.SPLASH_MIN_N = 1 << 30
    try:
        yield
    finally:
        bigbird.SPLASH_MIN_N = old


def layers_of(cfg) -> int:
    """The recipe's layer count: the Graphormer's own, or the GPS layers."""
    if cfg.model.type == "Graphormer":
        return cfg.graphormer.num_layers
    return cfg.gt.layers


def first_layers(state: dict, n: int) -> dict:
    """A GPS model's state dict cut to its first ``n`` layers (the encoder
    and head kept)."""
    return {k: v for k, v in state.items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < n}


def expected_launches(table, layers: int, steps: int, evals: int, names):
    """Launches of every kernel in ``names`` over ``steps`` training steps
    and ``evals`` evaluated batches of a model of ``layers`` layers whose
    path launches per layer what ``table`` says (per batch, whatever the
    depth, for PER_BATCH_KERNELS). The last layer's edge output does not
    reach the loss, so autograd runs the edge tail's backward in the other
    layers only."""
    out = {}
    for name in names:
        per_step, per_eval = table.get(name, (0, 0))
        n_layers = layers - (name == "pre_tail_bwd")
        if name in PER_BATCH_KERNELS:
            n_layers = 1
        out[name] = n_layers * (per_step * steps + per_eval * evals)
    return out


def check_launches(what: str, counts: dict, expect: dict, **info) -> None:
    print(json.dumps(dict(path=what, **info, launches=counts,
                          expected=expect)), flush=True)
    for name, want in expect.items():
        if counts[name] != want:
            fail(f"{what}: {name} was launched {counts[name]} times, "
                 f"expected {want}")


def check_training_run(torch, cfg, splits, run_dir, device, metric: str):
    """Phase 4b's checks on the entry point's training run: stats lines
    and the best epoch's checkpoint (first best by the val ``metric``:
    ``mae`` the smallest, any other the largest), which reloads into a fresh
    model and gives that epoch's val metric again."""
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.metrics import compute_task_metrics
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.train import checkpoint
    from graphgps_torch.train.loop import is_eval_epoch, loss_mask

    evaluated = [i for i in range(TRAIN_EPOCHS) if is_eval_epoch(cfg, i)]
    for split in ("train", "val", "test"):
        path = os.path.join(run_dir, split, "stats.json")
        rows = [json.loads(line) for line in open(path).read().splitlines()]
        want = list(range(TRAIN_EPOCHS)) if split == "train" else evaluated
        if [r["epoch"] for r in rows] != want:
            fail(f"{split}: stats.json epochs {[r['epoch'] for r in rows]}")
        if not all(math.isfinite(r["loss"]) and math.isfinite(r[metric])
                   for r in rows):
            fail(f"{split}: non-finite loss or no {metric} in {rows}")
        if split == "val":
            val = {r["epoch"]: r for r in rows}
    sign = 1.0 if metric == "mae" else -1.0
    best = min(evaluated, key=lambda i: sign * val[i][metric])
    saved = checkpoint.saved_epochs(run_dir)
    if saved != [best]:
        fail(f"checkpoints {saved}, expected the best epoch {best}")
    loader = create_loaders(cfg, splits, device)["val"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed + 7)
        model = build_model(cfg, infer_dims(cfg, splits))
    model = model.to(device).eval()
    plateau = None
    if cfg.optim.scheduler == "reduce_on_plateau":
        from graphgps_torch.optim import build_schedule

        plateau = build_schedule(cfg)
    checkpoint.load_ckpt(run_dir, model, scheduler=plateau)
    if plateau is not None:
        # saved right after the update that made the epoch the best
        print(json.dumps(dict(best_epoch_scheduler=plateau.state_dict())),
              flush=True)
        if (plateau.num_bad != 0 or plateau.lr != cfg.optim.base_lr
                or not abs(plateau.best - val[best][metric]) <= 1e-5):
            fail(f"the best checkpoint's scheduler state "
                 f"{plateau.state_dict()} is not that of epoch {best}")
    preds, trues = [], []
    with torch.no_grad():
        for _real, batch in loader:
            pred, true = model(batch)
            m = loss_mask(batch, pred)
            preds.append(pred[m].cpu().numpy())
            trues.append(true[m].cpu().numpy())
    got = compute_task_metrics(cfg.dataset.task_type, np.concatenate(preds),
                               np.concatenate(trues))[metric]
    print(json.dumps({"best_epoch": best, f"reloaded_val_{metric}": got,
                      f"logged_val_{metric}": val[best][metric]}), flush=True)
    # the stats round to 5 decimals
    if not abs(got - val[best][metric]) <= 1e-5:
        fail(f"the reloaded best checkpoint gives val {metric} {got}, the "
             f"run logged {val[best][metric]}")


def check_train_step(torch, cfg, splits, batch, device, state):
    """Phase 4c: one training step (forward, the task's loss, backward,
    clipping, adamW at the base learning rate) of the seeded model on the
    card and, from a copy, on the CPU, with dropout seeds from generators
    seeded alike, so both draw the same masks. ``state`` is loaded first: a
    calibrated state dict, whose running means are the shifts of the norms'
    single-pass batch variance. With the shifts at 0 a column whose mean is
    a hundred times its spread (LapPE's on graphs that share their spectrum)
    loses four digits of its variance to cancellation, and the two summation
    orders then part by 1e-3.

    Where a gradient lies outside that tolerance, the step also runs in
    float64 on the CPU, as the reference of the gradients' precision (only
    then: an f64 step of a deep model takes long on the CPU). A norm column
    with a variance of 3e-5 against the norm's eps of 1e-5 multiplies every
    rounding difference before it by 150, forward and backward, and two f32
    runs then part by up to 1e-2 of a gradient's scale, each as far from the
    f64 run. A gradient of the card
    passes when it is within the tolerance of the CPU's f32 gradient, or,
    unless it is one of NO_NORM_BEHIND (its way back from the loss passes no
    norm), within F64_GRAD_TOL of its scale of the f64 gradient. One f32
    run's distance from f64 is no yardstick for one tensor: the plain
    versions on the card are up to 23,061 times further from f64 than the
    CPU in a tensor of one batch, and closer in the next
    (``tools/torch_step_precision.py``).

    Updated parameters: adamW's first step moves each entry by about
    lr·sign(g), so an entry whose gradient is within the gradients' error
    of 0 may step either way. Entries with |g| above 1e-2 of their
    tensor's largest (ten times the gradient tolerance) and above 1e-6 must
    agree within 1e-6 + 1e-5·|p|; the others within 2·lr + 1e-6."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer, set_lr
    from graphgps_torch.train.loop import train_step

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg, infer_dims(cfg, splits))
    model.load_state_dict(state)
    lr = cfg.optim.base_lr
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    out = []
    for m, b in ((copy.deepcopy(model).to(device), batch),
                 (model, batch.to("cpu"))):
        m.train()
        opt = build_optimizer(cfg, m.parameters())
        set_lr(opt, lr)
        gen = torch.Generator().manual_seed(DROP_SEED)
        loss = train_step(cfg, m, opt, b, gen)[0]
        out.append((float(loss), {k: p.grad.cpu() for k, p in
                                  m.named_parameters() if p.grad is not None},
                    {k: v.detach().cpu() for k, v in m.state_dict().items()}))
    (lg, gg, sg), (lc, gc, sc) = out
    problems = []
    if set(gg) != set(gc):
        problems.append(f"gradients of {set(gg) ^ set(gc)} on one side only")
    # a tensor whose gradient is 0 in exact arithmetic (a bias before a
    # BatchNorm) holds rounding noise on both sides: its scale is floored
    # at 1e-2 of the largest gradient entry of the model
    floor = 1e-2 * max(float(g.abs().max()) for g in gc.values())
    worst, g_err, g_rel = None, 0.0, 0.0
    outside = []
    for k in gc:
        ok, e_, r_ = grads_close(torch, [gg[k]], [gc[k]], STEP_GRAD_RTOL,
                                 STEP_GRAD_ATOL, floor)
        if r_ >= g_rel:
            worst, g_err, g_rel = k, e_, r_
        if ok:
            continue
        if k.startswith(NO_NORM_BEHIND):
            problems.append(f"gradient of {k} differs: max {e_} ({r_} of "
                            "its scale)")
        else:
            outside.append((k, e_, r_))
    f64 = dict(tensors_held_to_f64=len(outside), tensors=len(gc),
               f64_grad_tol=F64_GRAD_TOL)
    if outside:
        # the f64 step on the CPU, the reference of these gradients
        m = copy.deepcopy(model).double().train()
        m.load_state_dict({k: v.double() for k, v in init.items()})
        opt = build_optimizer(cfg, m.parameters())
        set_lr(opt, lr)
        train_step(cfg, m, opt, batch.to("cpu"),
                   torch.Generator().manual_seed(DROP_SEED))
        g64 = {k: p.grad for k, p in m.named_parameters()
               if p.grad is not None}
        scale = {k: max(floor, float(g64[k].abs().max())) for k in gc}
        far = lambda g: {k: float((g[k].double() - g64[k]).abs().max())  # noqa
                         / scale[k] for k in gc}
        far_gpu, far_cpu = far(gg), far(gc)
        for k, e_, r_ in outside:
            if far_gpu[k] > F64_GRAD_TOL:
                problems.append(f"gradient of {k} differs: max {e_} ({r_} "
                                f"of its scale); {far_gpu[k]} of it from f64, "
                                f"the CPU's {far_cpu[k]}")
        f64.update(grad_gpu_from_f64_over_scale=max(far_gpu.values()),
                   grad_cpu_f32_from_f64_over_scale=max(far_cpu.values()))
    stat_err, p_err, moved, n_clean = 0.0, 0.0, 0.0, 0
    for k in sc:
        a, b = sg[k], sc[k]
        if k.endswith(("running_mean", "running_var")):
            stat_err = max(stat_err, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL):
                problems.append(f"{k} differs")
        elif k in gc:
            g = gc[k].abs()
            clean = (g > 1e-2 * float(g.max())) & (g > 1e-6)
            diff = (a - b).abs()
            tol = torch.where(clean, 1e-6 + 1e-5 * b.abs(),
                              torch.full_like(b, 2 * lr + 1e-6))
            if not bool((diff <= tol).all()):
                problems.append(f"{k}: updated parameters differ by "
                                f"{float(diff.max())}")
            if clean.any():
                p_err = max(p_err, float(diff[clean].max()))
                moved = max(moved, float((b - init[k]).abs()[clean].max()))
                n_clean += int(clean.sum())
    row = dict(loss_gpu=lg, loss_cpu=lc, grad_worst_tensor=worst,
               grad_max_abs_err=g_err, grad_err_over_scale=g_rel,
               grad_rtol=STEP_GRAD_RTOL,
               grad_atol=f"{STEP_GRAD_ATOL} x max(max|grad| of the tensor, "
                         "1e-2 x max|grad| of the model)",
               running_stats_max_abs_err=stat_err,
               clean_param_max_abs_err=p_err, clean_params=n_clean,
               largest_clean_step=moved, lr=lr, **f64)
    print(json.dumps(row), flush=True)
    if not math.isclose(lg, lc, rel_tol=STEP_RTOL, abs_tol=STEP_ATOL):
        problems.append(f"loss {lg} on the card, {lc} on the CPU")
    if moved < 0.5 * lr:
        problems.append(f"the step moved no parameter by lr/2 ({moved})")
    if problems:
        fail("training step, card vs CPU: " + "; ".join(problems))


def rate_loader(cfg, splits, loader, device, batches: int = RATE_BATCHES):
    """``batches`` full batches of the train split's graphs, repeated in
    order, at the main path's shapes (the same batch size, N and edge
    block): the stand-in's splits are small enough that partial batches,
    which do a full batch's work, would otherwise weigh on the rate. A
    transductive split's one batch is its one graph, repeated."""
    from graphgps_torch.data.loader import DeviceLoader

    bs = loader.batch_size
    n = batches * bs
    graphs = (splits.train * -(-n // len(splits.train)))[:n]
    return DeviceLoader(graphs, bs, device, max_nodes=loader.max_nodes,
                        max_edges=bs * loader.arenas.edge_cap,
                        y_graph_level=cfg.dataset.task == "graph")


def profile_pass(torch, one_pass, n: int, top: int, unit: str):
    """One pass of ``one_pass`` (``n`` batches) under ``torch.profiler``:
    prints the ``top`` CUDA kernels by device time, one JSON line each, and
    returns (device busy ms per batch, profiled wall ms per batch, CUDA
    kernel launches per batch)."""
    def body():
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    rows, prof_wall = profiled_rows(torch, body)
    if rows is None:
        fail(f"the profiler recorded no device time in {PROFILER_TRIES} "
             "passes")
    busy_us = sum(r[1] for r in rows)
    for name, us, cnt in rows[:top]:
        print(json.dumps({"device_kernel": name[:90],
                          f"ms_per_{unit}": us / n / 1e3,
                          "share": us / busy_us,
                          f"calls_per_{unit}": cnt / n}), flush=True)
    return busy_us / n / 1e3, 1e3 * prof_wall / n, sum(r[2] for r in rows) / n


def measure(torch, step, loader, unit: str, top: int) -> dict:
    """``step(batch)`` over the loader's full batches: graphs/s and real
    nodes/s on the host clock over RATE_PASSES passes after one warm-up pass, the peak device
    memory over them, then the first PROFILE_BATCHES batches under
    ``torch.profiler`` for the device time by CUDA kernel and the device's
    idle share in that window. Prints one JSON line per kernel name (the
    largest first)."""
    def one_pass(n=None):
        for i, (_real, b) in enumerate(loader):
            if n is not None and i == n:
                break
            step(b)

    one_pass()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(RATE_PASSES):
        one_pass()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n = RATE_PASSES * len(loader)
    head = min(PROFILE_BATCHES, len(loader))
    busy_ms, prof_ms, launches = profile_pass(
        torch, lambda: one_pass(head), head, top, unit)
    ms = 1e3 * wall / n
    nodes = RATE_PASSES * sum(int(b.node_mask.sum()) for _real, b in loader)
    return {"graphs_per_s": n * loader.batch_size / wall,
            "nodes_per_s": nodes / wall, "full_batches": n,
            "timed_s": wall, f"{unit}_ms": ms,
            f"profiled_{unit}_ms": prof_ms, "device_busy_ms": busy_ms,
            f"device_launches_per_{unit}": launches,
            "profiled_idle_share": 1.0 - busy_ms / prof_ms,
            # busy time of the profiled pass over the same loop's time
            # without the profiler: an estimate across two windows
            "idle_share_estimate": 1.0 - busy_ms / ms,
            "peak_memory_allocated_gb": peak / 1e9}


def drive_recipe(torch, name: str, cfg_path: str, table: dict, metric: str,
                 state: dict, device, card: str, extra=(), train_extra=(),
                 rate_batches: int = RATE_BATCHES):
    """Phase 4 for one main path: the entry point in evaluation and in
    training with the launch counts read around each run, one training step
    card vs CPU, predictions card vs CPU, and both rates over
    ``rate_batches`` full batches a pass. ``state`` is the calibrated state
    dict the evaluation runs and the training step of 4c start from;
    ``extra`` are config overrides of every run, ``train_extra`` those of
    the training run, the training step and the training rate. The training run keeps
    checkpoints (``train.enable_ckpt``, which a recipe may turn off) to
    check the best one's round trip. Returns the training run's launch
    counts."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, main as port_main
    from graphgps_torch.ops import kernels
    from graphgps_torch.optim import build_optimizer, set_lr
    from graphgps_torch.train.loop import (eval_step, is_eval_epoch,
                                           loss_mask, train_step)

    def cfg_of(opts):
        cfg = new_cfg()
        load_cfg(cfg, cfg_path)
        update_from_list(cfg, opts)
        return cfg

    t_recipe = time.perf_counter()

    def mark(sub: str) -> None:
        print(json.dumps(dict(path=name, subphases_done=sub,
                              elapsed_s=time.perf_counter() - t_recipe)),
              flush=True)

    with tempfile.TemporaryDirectory() as out_dir:
        # a. the evaluation path through the entry point
        opts = [*extra, "train.mode", "inference-only", "seed", str(SEED),
                "out_dir", out_dir]
        cfg = cfg_of(opts)
        splits = load_dataset(cfg)
        loaders = create_loaders(cfg, splits, device)
        layers = layers_of(cfg)
        held = {}

        def prepare(model):
            model.load_state_dict(state)
            held["model"] = model

        batches = sum(len(v) for v in loaders.values())
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hist = port_main(["--cfg", cfg_path, *opts], prepare_model=prepare)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        check_launches(f"{name} evaluation", counts,
                       expected_launches(table, layers, 0, batches, counts),
                       main_path_s=main_s, batches=batches)
        for split, h in hist[SEED].items():
            if metric not in h[0] or not all(
                    math.isfinite(v) for v in h[0].values()
                    if isinstance(v, float)):
                fail(f"{name} {split}: non-finite stats or no {metric}: "
                     f"{h[0]}")

        # b. the training path through the entry point
        train_opts = [*extra, *train_extra, "train.mode", "custom", "seed",
                      str(SEED),
                      "optim.max_epoch", str(TRAIN_EPOCHS),
                      "optim.num_warmup_epochs", "1", "train.ckpt_best",
                      "True", "train.enable_ckpt", "True",
                      "out_dir", os.path.join(out_dir, "train")]
        tcfg = cfg_of(train_opts)
        trained = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        port_main(["--cfg", cfg_path, *train_opts],
                  prepare_model=lambda m: trained.setdefault("model", m))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_counts = kernels.launch_counts()
        steps = TRAIN_EPOCHS * len(loaders["train"])
        evals = sum(is_eval_epoch(tcfg, i) for i in range(TRAIN_EPOCHS)) * \
            sum(len(loaders[s]) for s in ("val", "test") if s in loaders)
        check_launches(f"{name} training", train_counts,
                       expected_launches(table, layers, steps, evals,
                                         train_counts),
                       train_path_s=train_s, train_steps=steps,
                       eval_batches=evals)
        run_dir = os.path.join(out_dir, "train",
                               os.path.splitext(os.path.basename(cfg_path))[0],
                               str(SEED))
        check_training_run(torch, tcfg, splits, run_dir, device, metric)
        mark("a, b")

        # c. one training step, card vs CPU
        _real, train_batch = next(iter(loaders["train"]))
        check_train_step(torch, tcfg, splits, train_batch, device, state)
        mark("c")

        # d. the evaluation model on the CPU, and the inference rate
        model = held["model"]
        real, batch = next(iter(loaders["val"]))
        with torch.no_grad():
            pred_gpu, _ = model(batch)
            cpu_model = copy.deepcopy(model).cpu()
            pred_cpu, _ = cpu_model(batch.to("cpu"))
        m = loss_mask(batch, pred_gpu).cpu()      # real graphs, or real nodes
        pg, pc = pred_gpu.cpu()[m], pred_cpu[m]
        err = float((pg - pc).abs().max())
        print(json.dumps(dict(path=name, cpu_vs_gpu_max_abs_err=err,
                              rtol=MODEL_RTOL, atol=MODEL_ATOL,
                              rows=int(m.sum()),
                              pred_shape=list(pred_gpu.shape))), flush=True)
        if (pred_gpu.shape != pred_cpu.shape or pred_gpu.shape[0] != m.shape[0]
                or not torch.isfinite(pg).all()):
            fail(f"{name}: bad predictions: shape {tuple(pred_gpu.shape)}")
        if not torch.allclose(pg, pc, rtol=MODEL_RTOL, atol=MODEL_ATOL):
            fail(f"{name}: GPU vs CPU predictions differ (max abs err {err})")

        mark("d")
        full = rate_loader(cfg, splits, loaders["train"], device,
                           rate_batches)
        rate = measure(torch, lambda b: eval_step(cfg, model, b), full,
                       "batch", 15)
        print(json.dumps(dict(path=name, mode="evaluation", **rate,
                              card=card)), flush=True)

        # e. the training rate, profile and peak memory
        tmodel = trained["model"].train()
        opt = build_optimizer(tcfg, tmodel.parameters())
        set_lr(opt, tcfg.optim.base_lr)
        gen = torch.Generator().manual_seed(DROP_SEED + 1)
        rate = measure(torch,
                       lambda b: train_step(tcfg, tmodel, opt, b, gen), full,
                       "step", 30)
        print(json.dumps(dict(path=name, mode="training", **rate,
                              card=card)), flush=True)
        TRAIN_RATES[name] = rate
        mark("e")
    return train_counts


def snapshot(torch, model, opt):
    """Copies of a model's parameters and buffers and its optimizer's state
    tensors, for :func:`restore`."""
    with torch.no_grad():
        return ([t.detach().clone() for t in model.state_dict().values()],
                [{k: v.clone() for k, v in opt.state[p].items()}
                 for p in model.parameters()])


def restore(torch, model, opt, snap) -> None:
    """Write a :func:`snapshot` (of this model or of a copy of it) back in
    place: a captured graph keeps reading and writing the same tensors."""
    with torch.no_grad():
        for t, v in zip(model.state_dict().values(), snap[0]):
            t.copy_(v)
        for p, st in zip(model.parameters(), snap[1]):
            for k, v in st.items():
                opt.state[p][k].copy_(v)


def compare_steps(torch, what: str, got_losses, want_losses, a, b,
                  lr: float, k: int, bits_required: bool):
    """Captured steps (model and optimizer ``a``) against eager ones
    (``b``, its gradients the last step's): the losses of each step and
    every parameter, buffer and Adam state tensor after them. Bit for bit
    where the eager step is deterministic (``bits_required``: two eager
    steps from one state gave the same bits, :func:`eager_bits`); otherwise
    4c's rules over ``k`` steps:
    losses and running statistics within STEP_RTOL / STEP_ATOL; Adam's
    moments as 4c's gradients (rtol and atol STEP_GRAD_*, the atol times
    the tensor's largest entry floored at 1e-2 of the model's largest of
    that moment); the step counts equal; a parameter entry whose last
    gradient is above 1e-2 of its tensor's largest and above 1e-6 within
    k·(1e-6 + 1e-5·|p|), any other within 2·lr·k + 1e-6 (adamW moves an
    entry by about lr a step whatever its gradient). Returns the row's
    fields; fails outside both."""
    (ma, oa), (mb, ob) = a, b
    losses = [(float(x), float(y)) for x, y in zip(got_losses, want_losses)]
    sa, sb = ma.state_dict(), mb.state_dict()
    pa, pb = dict(ma.named_parameters()), dict(mb.named_parameters())
    moments = {(n, key): (oa.state[pa[n]][key], ob.state[pb[n]][key])
               for n in pb for key in ob.state[pb[n]]}
    bits = (all(x == y for x, y in losses)
            and all(torch.equal(sa[n], sb[n]) for n in sb)
            and all(torch.equal(x, y) for x, y in moments.values()))
    problems, worst, err = [], None, 0.0

    def note(name, x, y, scale):
        nonlocal worst, err
        e_ = float((x.double() - y.double()).abs().max()) / max(scale, 1e-30)
        if e_ >= err:
            worst, err = name, e_

    for x, y in losses:
        if not math.isclose(x, y, rel_tol=STEP_RTOL, abs_tol=STEP_ATOL):
            problems.append(f"losses {losses}")
    top = {}
    for (n, key), (x, y) in moments.items():
        top[key] = max(top.get(key, 0.0), float(y.abs().max()))
    for (n, key), (x, y) in moments.items():
        if key == "step":
            if not torch.equal(x, y):
                problems.append(f"step of {n}: {x} against {y}")
            continue
        scale = max(float(y.abs().max()), 1e-2 * top[key])
        note(f"{key} of {n}", x, y, scale)
        if not bits and not torch.allclose(x, y, rtol=STEP_GRAD_RTOL,
                                           atol=STEP_GRAD_ATOL * scale):
            problems.append(f"{key} of {n} differs")
    for n, y in sb.items():
        x = sa[n]
        if n not in pb:          # a buffer: the running statistics
            note(n, x, y, float(y.abs().max()))
            if not bits and not torch.allclose(x, y, rtol=STEP_RTOL,
                                               atol=STEP_ATOL):
                problems.append(f"{n} differs")
            continue
        g = pb[n].grad.abs()
        clean = (g > 1e-2 * float(g.max())) & (g > 1e-6)
        diff = (x - y).abs()
        tol = torch.where(clean, k * (1e-6 + 1e-5 * y.abs()),
                          torch.full_like(y, 2 * lr * k + 1e-6))
        note(n, x, y, float(y.abs().max()))
        if not bits and not bool((diff <= tol).all()):
            problems.append(f"{n} differs by {float(diff.max())}")
    if bits_required and not bits:
        problems.insert(0, "not bit-equal, as two eager steps are")
    if problems:
        fail(f"{what}: " + "; ".join(problems[:8]))
    return dict(rule="bits" if bits else "4c rules", losses=losses,
                tensors=len(sb) + len(moments), worst_tensor=worst,
                worst_err_over_scale=err)


def step_state(torch, model, opt, out):
    """The loss and predictions of a step (``out``) and, after it, copies of
    every parameter, buffer and Adam state tensor."""
    snap = snapshot(torch, model, opt)
    return [out[0].clone(), out[1].clone(), *snap[0],
            *(v for st in snap[1] for v in st.values())]


def eager_bits(torch, step, model, opt) -> dict:
    """Whether ``step()`` (one eager training step of ``model``) gives the
    same bits twice from one state: its loss, predictions, parameters,
    buffers and Adam state. Leaves the model and optimizer as they were.
    Returns the line's fields."""
    snap = snapshot(torch, model, opt)
    runs = []
    for _ in range(2):
        restore(torch, model, opt, snap)
        runs.append(step_state(torch, model, opt, step()))
    torch.cuda.synchronize()
    restore(torch, model, opt, snap)
    differ = [i for i, (x, y) in enumerate(zip(*runs))
              if not torch.equal(x, y)]
    return dict(eager_bit_equal=not differ, tensors=len(runs[0]),
                tensors_that_differ=len(differ),
                worst_abs_diff=max((float((runs[0][i] - runs[1][i]).abs()
                                          .max()) for i in differ),
                                   default=0.0))


def check_k_steps(torch, name: str, cfg_path: str, K: int, table: dict,
                  state: dict, device, card: str) -> None:
    """Phase 5 for one path (see the module docstring)."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.driver import main as port_main
    from graphgps_torch.models.gps_layer import StepSeeds
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.ops import kernels
    from graphgps_torch.optim import build_optimizer, set_lr
    from graphgps_torch.train.loop import (WARMUP_STEPS, KSteps, _draw_table,
                                           _step, is_eval_epoch)

    t_path = time.perf_counter()
    opts = ["seed", str(SEED), "train.steps_per_dispatch", str(K),
            "optim.max_epoch", str(KSTEP_EPOCHS)]
    cfg = new_cfg()
    load_cfg(cfg, cfg_path)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    loaders = create_loaders(cfg, splits, device)
    n_batches = len(loaders["train"])
    if not (n_batches > K and n_batches % K):
        fail(f"{name}: {n_batches} train batches give K = {K} no full and "
             "partial group")
    layers = layers_of(cfg)

    # a. the entry point, K steps per dispatch
    with tempfile.TemporaryDirectory() as out_dir:
        train_opts = [*opts, "train.mode", "custom",
                      "optim.num_warmup_epochs", "1", "train.enable_ckpt",
                      "False", "out_dir", out_dir]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hist = port_main(["--cfg", cfg_path, *train_opts],
                         prepare_model=lambda m: m.load_state_dict(state))
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
    counts, replays = kernels.launch_counts(), kernels.graph_replays()
    steps = KSTEP_EPOCHS * n_batches
    evals = sum(is_eval_epoch(cfg, i) for i in range(KSTEP_EPOCHS)) * sum(
        len(loaders[s]) for s in ("val", "test") if s in loaders)
    # the warm-up steps and the capture call every wrapper; a replay none
    check_launches(f"{name} K={K}", counts,
                   expected_launches(table, layers, WARMUP_STEPS + 1, evals,
                                     counts),
                   k=K, train_path_s=main_s, train_steps=steps,
                   graph_replays=replays, eval_batches=evals,
                   launches_run=expected_launches(
                       table, layers, WARMUP_STEPS + replays, evals, counts))
    if replays != steps - WARMUP_STEPS:
        fail(f"{name}: {replays} graph replays for {steps} steps")
    for split, rows in hist[SEED].items():
        want = KSTEP_EPOCHS if split == "train" else sum(
            is_eval_epoch(cfg, i) for i in range(KSTEP_EPOCHS))
        if len(rows) != want or not all(
                math.isfinite(v) for r in rows for v in r.values()
                if isinstance(v, float)):
            fail(f"{name} K={K} {split}: stats {rows}")

    # b-d. captured steps (model a) against eager ones (model b)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg, infer_dims(cfg, splits))
    model.load_state_dict(state)
    a = model.to(device).train()
    b = copy.deepcopy(a)
    opt_a = build_optimizer(cfg, a.parameters(), capturable=True)
    opt_b = build_optimizer(cfg, b.parameters(), capturable=True)
    for opt in (opt_a, opt_b):
        set_lr(opt, cfg.optim.base_lr)
    loader = loaders["train"]
    B = loader.batch_size
    n = loader.arenas.num_graphs_total
    first = np.arange(K * B) % n
    other = np.random.default_rng(SEED + 5).permutation(n)[:K * B]
    gen_a = torch.Generator().manual_seed(DROP_SEED + 5)
    gen_b = torch.Generator().manual_seed(DROP_SEED + 5)
    k_steps = KSteps(cfg, a, opt_a, loader, gen_a)

    def eager_b(row, seeds):
        batch = loader.arenas.assemble(torch.as_tensor(row, device=device),
                                       loader.max_nodes)
        opt_b.zero_grad(set_to_none=True)
        return _step(cfg, b, opt_b, batch, seeds)

    for i in range(WARMUP_STEPS):
        row = first[i * B:(i + 1) * B]
        k_steps._warmup(row)
        eager_b(row, StepSeeds(gen_b, device))
    k_steps.capture()
    n_seeds = k_steps.n_seeds

    # is the eager step deterministic? two from one state, same batch and
    # seeds: where they are bit-equal, b-d require bits
    probe_row = first[:B]
    probe_seeds = _draw_table(torch.Generator().manual_seed(DROP_SEED + 7),
                              1, n_seeds)[0].to(device, torch.int32)
    det = eager_bits(torch, lambda: eager_b(
        probe_row, StepSeeds(table=probe_seeds)), b, opt_b)
    print(json.dumps(dict(path=name, phase="5-eager-bits", **det)),
          flush=True)
    bits_required = det["eager_bit_equal"]

    def group(rows_of, tag):
        seeds = _draw_table(gen_a, K, n_seeds)
        if not torch.equal(seeds, _draw_table(gen_b, K, n_seeds)):
            fail("the two generators part")
        got, want = [], []
        for i in range(K):
            row = rows_of[i * B:(i + 1) * B]
            dev_row = torch.cat([torch.as_tensor(row), seeds[i]]).to(device)
            got.append(k_steps.replay(dev_row)[0])
            table_b = seeds[i].to(device, torch.int32)
            want.append(eager_b(row, StepSeeds(table=table_b))[0])
        torch.cuda.synchronize()
        return compare_steps(torch, f"{name} {tag}", got, want, (a, opt_a),
                             (b, opt_b), cfg.optim.base_lr, K, bits_required)

    row_b = group(first, "b")
    print(json.dumps(dict(path=name, phase="5b", k=K, n_seeds=n_seeds,
                          **row_b)), flush=True)
    row_d = group(other, "d")
    print(json.dumps(dict(path=name, phase="5d", k=K, **row_d)), flush=True)

    # c. one batch, two seed rows, from one state on both sides: each
    # replay against the eager step with its seeds (loss, predictions, and
    # every parameter, buffer and Adam state tensor after it)
    snap = snapshot(torch, a, opt_a)
    row = other[:B]
    seeds = _draw_table(torch.Generator().manual_seed(DROP_SEED + 9), 2,
                        n_seeds)
    got, want, states = [], [], []
    for j, s_row in enumerate(seeds):
        restore(torch, a, opt_a, snap)
        out = k_steps.replay(torch.cat([torch.as_tensor(row), s_row]).to(
            device))
        restore(torch, b, opt_b, snap)
        ref = eager_b(row, StepSeeds(table=s_row.to(device, torch.int32)))
        torch.cuda.synchronize()
        if not torch.allclose(out[1], ref[1], rtol=STEP_RTOL,
                              atol=STEP_ATOL):
            fail(f"{name} 5c: seed row {j}: the replay's predictions differ "
                 "from the eager step's")
        states.append(compare_steps(
            torch, f"{name} 5c seed row {j}", [out[0]], [ref[0]], (a, opt_a),
            (b, opt_b), cfg.optim.base_lr, 1, bits_required))
        got.append(out)
        want.append(ref)
    same = [all(torch.equal(x, y) for x, y in zip(g[:2], w[:2]))
            for g, w in zip(got, want)]
    moved = not torch.equal(got[0][1], got[1][1])
    print(json.dumps(dict(path=name, phase="5c", seed_rows=seeds.tolist(),
                          losses=[float(g[0]) for g in got],
                          eager_losses=[float(w[0]) for w in want],
                          outputs_equal_bits=same,
                          rules=[st["rule"] for st in states],
                          worst_err_over_scale=[st["worst_err_over_scale"]
                                                for st in states],
                          predictions_differ=moved)), flush=True)
    if not moved:
        fail(f"{name} 5c: two seed rows gave the same predictions")
    restore(torch, b, opt_b, snap)
    restore(torch, a, opt_a, snap)

    # e. captured against eager, host and device time a step
    rows = [torch.cat([torch.as_tensor(first[(i % K) * B:(i % K + 1) * B]),
                       s]).to(device)
            for i, s in enumerate(_draw_table(gen_a, KSTEP_TIMED, n_seeds))]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ev[0].record()
    for r in rows:
        k_steps.replay(r)
    ev[1].record()
    torch.cuda.synchronize()
    cap_s = time.perf_counter() - t0
    cap_peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    cap_launches = sum(kernels.launch_counts().values())
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    ev[2].record()
    for i in range(KSTEP_TIMED):
        eager_b(first[(i % K) * B:(i % K + 1) * B], StepSeeds(gen_b, device))
    ev[3].record()
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager_peak = torch.cuda.max_memory_allocated()
    eager_launches = sum(kernels.launch_counts().values())
    rate = TRAIN_RATES.get(name, {})
    print(json.dumps(dict(
        path=name, phase="5e", k=K, steps_timed=KSTEP_TIMED,
        captured_host_ms=1e3 * cap_s / KSTEP_TIMED,
        captured_device_ms=ev[0].elapsed_time(ev[1]) / KSTEP_TIMED,
        eager_host_ms=1e3 * eager_s / KSTEP_TIMED,
        eager_stream_ms=ev[2].elapsed_time(ev[3]) / KSTEP_TIMED,
        eager_busy_ms_4e=rate.get("device_busy_ms"),
        eager_host_ms_4e=rate.get("step_ms"),
        eager_cuda_launches_4e=rate.get("device_launches_per_step"),
        wrapper_launches_per_captured_step=cap_launches / KSTEP_TIMED,
        wrapper_launches_per_eager_step=eager_launches / KSTEP_TIMED,
        captured_peak_gb=cap_peak / 1e9, eager_peak_gb=eager_peak / 1e9,
        # the graph's private pool holds the captured step's activations and
        # is reserved, not allocated, between replays
        reserved_gb_after_replays=reserved / 1e9,
        path_s=time.perf_counter() - t_path, card=card)), flush=True)
    if cap_launches != 0:
        fail(f"{name}: replays called {cap_launches} kernel wrappers")
    del k_steps


def main() -> None:
    if len(sys.argv) > 1:
        fail("takes no arguments")
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from graphgps_torch.config import load_cfg, new_cfg, update_from_list
        from graphgps_torch.data.datasets import load_dataset
        from graphgps_torch.ops.kernels import build
    except ImportError as e:
        fail(f"graphgps_torch is not importable ({e}): run from the "
             "repository root")
    for path in (CFG, MOLHIV_CFG, PCQM_GPS_CFG, VOC_CFG, ZINC_CFG, SAN_CFG,
                 SQUIRREL_CFG):
        if not os.path.exists(path):
            fail(f"{path} not found: run from the repository root")
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(json.dumps(dict(phase_done=name,
                              elapsed_s=time.perf_counter() - t_start)),
              flush=True)

    # 1. the card
    card = smi()
    print(card, flush=True)

    # 2. build
    t0 = time.perf_counter()
    per_source = build.build_all()
    print(json.dumps(dict(build_s=time.perf_counter() - t0,
                          per_source_s=per_source)), flush=True)
    for name in build.SOURCES:
        log = build.log_path(name)
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"ptxas {name}: {line.strip()}", flush=True)
    check_tensor_cores(build)

    # 3, 3b. the merged path's kernels at GPS-deep's shapes
    cfg = new_cfg()
    load_cfg(cfg, CFG)
    update_from_list(cfg, ["seed", str(SEED)])
    floor_ms = launch_floor(torch, device)
    flush = l2_flush(torch, device)
    rows, state, layer0 = check_kernels(torch, cfg, load_dataset(cfg), device,
                                        flush)
    rows += check_backward(torch, layer0)
    phase("3, 3b")

    # 3c. the unmerged path's kernels at ogbg-molhiv's shapes and at the
    # pcqm4m-GPS+RWSE width (layer 0 is all that shape needs)
    _, _, mol_rows, mol_state = check_unmerged(
        torch, "ogbg-molhiv", MOLHIV_CFG, ["seed", str(SEED)], device, flush)
    check_unmerged(torch, "pcqm4m-GPS", PCQM_GPS_CFG,
                   ["seed", str(SEED), "gt.layers", "1"], device)
    new = ("gatedgcn", "gatedgcn_bwd", "drop_add", "drop_add_bwd")
    rows += [r for r in mol_rows if r["name"] in new]
    phase("3c")

    # 3d. the long-graph rung's kernels at VOC's shapes; the kernels line
    # takes the rows at the recipe's attention dropout
    voc_opts = [*VOC_OPTS, "seed", str(SEED)]
    voc_cfg, _, voc_rows, voc_state = check_long_graphs(torch, VOC_CFG,
                                                        voc_opts, device)
    rows += [r for r in voc_rows if r["shape"] == "voc"
             and r.get("attn_rate", voc_cfg.gt.attn_dropout)
             == voc_cfg.gt.attn_dropout]
    phase("3d")

    # 3e. the Graphormer MLP block's kernel at zinc-Graphormer's shapes; the
    # kernels line takes the rows at the recipe's training rates
    zinc_rows, zinc_state = check_ln_ffn(torch, ZINC_CFG,
                                         ["seed", str(SEED)], device)
    rows += [r for r in zinc_rows if r["rates"] == list(LN_FFN_RATES[1])]
    phase("3e")

    # 3f. SAN's norm apply + FFN at ogbg-molhiv SAN's shapes and at the
    # molpcba-SAN width; the kernels line takes the rows at the recipe's rate
    san_rows, san_state = check_bn_ffn(torch, SAN_CFG, ["seed", str(SEED)],
                                       device)
    rows += [r for r in san_rows
             if r["shape"] == "ogbg-molhiv-SAN" and r["rate"] > 0]
    phase("3f")

    # 3g. the GPS FFN block at wn-squirrel's shapes and at the actor width;
    # the kernels line takes the rows at the recipe's rate and activation
    sq_opts = [*SQUIRREL_OPTS, "seed", str(SEED)]
    sq_rows, sq_state = check_ffn(torch, SQUIRREL_CFG, sq_opts, device)
    rows += [r for r in sq_rows if r["shape"] == "wn-squirrel"
             and r["rate"] > 0 and r["act"] == "gelu"]
    phase("3g")

    # 3h. the fused attention rung at GPS-deep's shapes; the kernels line
    # takes the rows at the recipe's attention dropout
    ga_rows = check_gps_attention(torch, layer0, device)
    rows += [r for r in ga_rows if r["shape"] == "pcqm4m-GPSdeep"
             and r["attn_rate"] == cfg.gt.attn_dropout]
    del layer0
    phase("3h")

    # 3i. the flash attention at VOC's shapes, with and without a bias, and
    # at wn-squirrel's; the kernels line takes VOC's rows without a bias
    fl_rows = check_flash(torch, VOC_CFG, voc_opts, voc_state, device)
    rows += [r for r in fl_rows if r["shape"] == "voc" and not r["bias"]]
    phase("3i")

    # 3j. the segment sums and their plan at wn-squirrel's aggregation, with
    # hubs, in one segment and at MalNet's size; the kernels line takes the
    # aggregation's rows
    seg_rows = check_segment(torch, SQUIRREL_CFG, sq_opts, sq_state, device)
    rows += [r for r in seg_rows if r["shape"] == "wn-squirrel"]
    phase("3j")

    # 3k. BigBird at wn-squirrel's graph with the three layers' plans and at
    # 4 graphs of 2,048 slots; the kernels line takes layer 0's
    sq_cfg = new_cfg()
    load_cfg(sq_cfg, SQUIRREL_CFG)
    heads = sq_cfg.gt.n_heads
    bb_rows = check_bigbird(torch, device, heads,
                            sq_cfg.gt.dim_hidden // heads)
    rows += [r for r in bb_rows if r["shape"] == "wn-squirrel"
             and r["seed"] == 0]
    phase("3k")

    # 4. the six main paths
    deep_counts = drive_recipe(torch, "pcqm4m-GPSdeep", CFG, GPSDEEP_LAUNCHES,
                               "mae", state, device, card)
    phase("4 pcqm4m-GPSdeep")
    mol_counts = drive_recipe(torch, "ogbg-molhiv", MOLHIV_CFG,
                              MOLHIV_LAUNCHES, "auc", mol_state, device, card)
    phase("4 ogbg-molhiv")
    voc_counts = drive_recipe(torch, "vocsuperpixels", VOC_CFG, VOC_LAUNCHES,
                              "f1", voc_state, device, card, extra=VOC_OPTS)
    phase("4 vocsuperpixels")
    zinc_counts = drive_recipe(torch, "zinc-Graphormer", ZINC_CFG,
                               ZINC_LAUNCHES, "mae", zinc_state, device, card)
    phase("4 zinc-Graphormer")
    san_counts = drive_recipe(torch, "ogbg-molhiv-SAN", SAN_CFG,
                              SAN_LAUNCHES, "auc", san_state, device, card)
    phase("4 ogbg-molhiv-SAN")
    sq_counts = drive_recipe(torch, "wn-squirrel", SQUIRREL_CFG,
                             SQUIRREL_LAUNCHES, "accuracy", sq_state, device,
                             card, extra=SQUIRREL_OPTS,
                             rate_batches=SQUIRREL_RATE_BATCHES)
    phase("4 wn-squirrel")
    # the GPS layer's other attention rungs: GPS-deep with the JAX package's
    # merged-front switch off, VOC under gt.attn_impl flash; each against
    # the default path's predictions from one calibrated model
    with env_set(*FRONT_OFF):
        off_counts = drive_recipe(
            torch, "pcqm4m-GPSdeep front-off", CFG, GPSDEEP_UNMERGED_LAUNCHES,
            "mae", first_layers(state, FRONT_OFF_LAYERS), device, card,
            extra=("gt.layers", str(FRONT_OFF_LAYERS)))
    check_rung_switch(torch, "pcqm4m-GPSdeep", CFG, ["seed", str(SEED)],
                      state, device, (merged_front, front_off),
                      (GPSDEEP_LAUNCHES, GPSDEEP_UNMERGED_LAUNCHES))
    phase("4 pcqm4m-GPSdeep front-off")
    flash_counts = drive_recipe(torch, "vocsuperpixels flash", VOC_CFG,
                                VOC_FLASH_LAUNCHES, "f1", voc_state, device,
                                card, extra=VOC_OPTS + VOC_FLASH_OPTS,
                                train_extra=VOC_FLASH_TRAIN_OPTS)
    check_rung_switch(torch, "vocsuperpixels", VOC_CFG, voc_opts, voc_state,
                      device, (attn_auto, attn_flash),
                      (VOC_LAUNCHES, VOC_FLASH_LAUNCHES))
    phase("4 vocsuperpixels flash")
    # the last three TPU kernels: wn-squirrel under the JAX package's
    # segment switches and as GCN+BigBird; each against the default path's
    # predictions from one model
    with env_set(*TILED_ON):
        tiled_counts = drive_recipe(torch, "wn-squirrel tiled", SQUIRREL_CFG,
                                    SQUIRREL_TILED_LAUNCHES, "accuracy",
                                    sq_state, device, card,
                                    extra=SQUIRREL_OPTS,
                                    rate_batches=SWITCH_RATE_BATCHES)
    check_rung_switch(torch, "wn-squirrel", SQUIRREL_CFG, sq_opts, sq_state,
                      device, (segment_index_add, segment_tiled),
                      (SQUIRREL_LAUNCHES, SQUIRREL_TILED_LAUNCHES))
    phase("4 wn-squirrel tiled")
    with env_set(*CSR_ON):
        csr_counts = drive_recipe(torch, "wn-squirrel csr", SQUIRREL_CFG,
                                  SQUIRREL_CSR_LAUNCHES, "accuracy", sq_state,
                                  device, card, extra=SQUIRREL_OPTS,
                                  rate_batches=SWITCH_RATE_BATCHES)
    check_rung_switch(torch, "wn-squirrel", SQUIRREL_CFG, sq_opts, sq_state,
                      device, (segment_index_add, segment_csr),
                      (SQUIRREL_LAUNCHES, SQUIRREL_CSR_LAUNCHES))
    phase("4 wn-squirrel csr")
    bb_counts = drive_recipe(torch, "wn-squirrel bigbird", SQUIRREL_CFG,
                             SQUIRREL_BIGBIRD_LAUNCHES, "accuracy", sq_state,
                             device, card, extra=SQUIRREL_OPTS + BIGBIRD_OPTS,
                             train_extra=BIGBIRD_TRAIN_OPTS,
                             rate_batches=SWITCH_RATE_BATCHES)
    check_rung_switch(torch, "wn-squirrel bigbird", SQUIRREL_CFG,
                      sq_opts + BIGBIRD_OPTS, sq_state, device,
                      (bigbird_kernel, bigbird_dense),
                      (SQUIRREL_BIGBIRD_LAUNCHES, SQUIRREL_LAUNCHES))
    phase("4 wn-squirrel bigbird")

    # 5. K training steps per dispatch as replays of one captured step
    t5 = time.perf_counter()
    for name, cfg_path, k, table in KSTEP_PATHS:
        check_k_steps(torch, name, cfg_path, k, table,
                      state if cfg_path == CFG else mol_state, device, card)
    print(json.dumps(dict(phase_done="5", elapsed_s=time.perf_counter()
                          - t_start, phase_s=time.perf_counter() - t5,
                          budget_s=KSTEP_BUDGET_S)), flush=True)
    for r in rows:
        path, counts = "pcqm4m-GPSdeep", deep_counts
        if r["name"] in new:
            path, counts = "ogbg-molhiv", mol_counts
        elif r["name"] in ("segment_csr", "segment_plan"):
            # the plan kernel also builds the edge gate's orders on VOC
            path, counts = "wn-squirrel csr", csr_counts
        elif r["name"] in VOC_LAUNCHES:
            path, counts = "vocsuperpixels", voc_counts
        elif r["name"] in ZINC_LAUNCHES:
            path, counts = "zinc-Graphormer", zinc_counts
        elif r["name"] in SAN_LAUNCHES:
            path, counts = "ogbg-molhiv-SAN", san_counts
        elif r["name"] in ("ffn", "ffn_bwd"):
            path, counts = "wn-squirrel", sq_counts
        elif r["name"] in ("gps_attention", "gps_attention_bwd"):
            path, counts = "pcqm4m-GPSdeep front-off", off_counts
        elif r["name"] in ("flash_mha", "flash_mha_bwd"):
            path, counts = "vocsuperpixels flash", flash_counts
        elif r["name"] == "segment_tiled":
            path, counts = "wn-squirrel tiled", tiled_counts
        elif r["name"] in ("bigbird", "bigbird_bwd"):
            path, counts = "wn-squirrel bigbird", bb_counts
        r["launches"] = counts[r["name"]]
        r["main_path"] = path
        r["launches_ogbg_molhiv"] = mol_counts[r["name"]]
        r["launches_vocsuperpixels"] = voc_counts[r["name"]]
        r["launches_zinc_graphormer"] = zinc_counts[r["name"]]
        r["launches_ogbg_molhiv_san"] = san_counts[r["name"]]
        r["launches_wn_squirrel"] = sq_counts[r["name"]]
        r["launches_gpsdeep_front_off"] = off_counts[r["name"]]
        r["launches_voc_flash"] = flash_counts[r["name"]]
        r["launches_wn_squirrel_tiled"] = tiled_counts[r["name"]]
        r["launches_wn_squirrel_csr"] = csr_counts[r["name"]]
        r["launches_wn_squirrel_bigbird"] = bb_counts[r["name"]]
        r["launch_floor_ms"] = floor_ms

    print(card, flush=True)   # name, power limit, as nvidia-smi gives them
    print(json.dumps(dict(kernels=[
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "bound_rate", "library_ms",
                           "launch_floor_ms", "profile_whole",
                           "main_path",
                           "launches_ogbg_molhiv",
                           "launches_vocsuperpixels",
                           "launches_zinc_graphormer",
                           "launches_ogbg_molhiv_san",
                           "launches_wn_squirrel",
                           "launches_gpsdeep_front_off",
                           "launches_voc_flash",
                           "launches_wn_squirrel_tiled",
                           "launches_wn_squirrel_csr",
                           "launches_wn_squirrel_bigbird")} for r in rows])),
          flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))), flush=True)


if __name__ == "__main__":
    main()
