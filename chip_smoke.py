#!/usr/bin/env python3
"""Smoke test of graphgps_torch on one NVIDIA GPU (H100, sm_90a).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and fails (non-zero exit, no result line) without
one. Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from ``graphgps_torch/csrc`` (one
   ``nvcc`` per source, all at once);
3. hold each forward kernel against its plain PyTorch version on the card,
   on the inputs layer 0 of the main path gives it (PCQM4Mv2 GPS-deep: batch
   256, d=256, 8 heads, seeded weights, non-trivial BatchNorm statistics),
   and time both with CUDA events;
3b. with dropout 0.1 on every site, run each of the three functions forward
   and backward through the kernels and through autograd of the plain
   versions on the same inputs; hold each backward kernel against the plain
   gradients, check that two runs give the same bits and that every site
   keeps 230/256 of its units, and time both;
4. run the port's entry point ``graphgps_torch.driver.main`` (``train.mode
   inference-only`` on ``configs/GPS/pcqm4m-GPSdeep+RWSE.yaml``, 16 layers)
   with every launch count set to 0 just before, and check that each forward
   kernel ran 16 times per batch;
4b. train through the entry point (``train.mode custom``, 16 layers, 3
   epochs, warm-up 1) with the counts set to 0 just before: one stats line
   per epoch and split with finite losses, each kernel once per layer and
   training step (the forward ones also per evaluated batch; the edge
   tail's backward in the 15 layers whose edge output reaches the loss),
   and the best epoch's checkpoint reloads into a fresh model with the same
   predictions;
4c. one training step on the card and on the CPU (the plain path) from the
   same weights, batch and dropout seeds: loss, every gradient, the updated
   running statistics and the updated parameters;
5. check one batch's predictions against the same model on the CPU (the
   plain path); measure the inference rate in graphs/s over full batches,
   then profile the same loop once more for the device time by CUDA kernel
   and the device's idle share;
5b. the same for training steps (forward, backward, clipping, adamW): the
   rate in graphs/s over full batches, the profile, and the peak device
   memory.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

CFG = "configs/GPS/pcqm4m-GPSdeep+RWSE.yaml"
SEED = 0
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s
# outside the tensor cores (the kernels run f32 on CUDA cores)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# kernel vs plain version, both f32 on the card: the sums run in another
# order (tiled GEMM vs cuBLAS, per-column loops vs index_add_)
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
# the 16-layer model on the card vs on the CPU, f32 on both: with calibrated
# BatchNorm statistics the plain path's f32 and f64 predictions (~0.08)
# differ by ~7e-8 on the CPU, so this leaves two orders of magnitude for
# another summation order through 16 layers
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
# the front's moment sums run over ~6e3 rows: error relative to the sum of
# the terms' magnitudes (f32 sequential sums stay well inside n*eps ≈ 6e-4)
MOMENT_RTOL = 1e-5
# the inference rate: full batches per timed pass, and timed passes
# (~1 s per pass at ~23 ms per batch)
RATE_BATCHES = 40
RATE_PASSES = 3
# phase 3b: dropout on every site, and the seed of the layer-0 calls
DROP_RATE = 0.1
DROP_SEED = 20260
KEEP_FRACTION = 230 / 256
KEEP_REL_TOL = 0.005
# a backward kernel vs autograd of its plain version: another summation
# order, and a gradient entry is a sum over rows (or 7d products) that
# cancel, so its f32 rounding follows the tensor's largest entries
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4
# phase 4b: epochs of the training run through the entry point
TRAIN_EPOCHS = 3
# phase 4c: one training step, card vs CPU. Gradients: 16 layers of f32
# forward and backward in two summation orders (tiled GEMM and fixed-order
# column sums on the card, MKL on the CPU); the atol is relative to each
# tensor's own largest entry (gradients are small, so no floor of 1; see
# check_train_step for tensors of pure rounding noise). Measured on an H100:
# 4.3e-7 of the worst tensor's scale (PERF.md). Running statistics and loss
# as the model's predictions. Updated parameters: see check_train_step.
STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-4, 1e-4
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5


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


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the CUDA kernels it launches,
    summed by ``torch.profiler`` over ``iters`` calls after ``warmup``, so
    the host's launch gaps between them do not count."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(r[1] for r in device_rows(torch, prof))
    if us <= 0:
        fail("the profiler recorded no device time")
    return us / iters / 1e3


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


def calibrated_model(torch, cfg, splits, batch):
    """The entry point's seeded model (same seed, same weights) with seeded
    BatchNorm scale/bias, and running statistics set, layer by layer, to the
    masked statistics of each norm's input on ``batch`` -- the state
    training leaves them in. An untrained 16-layer stack with arbitrary
    running statistics grows its activations to ~1e4 and is chaotic: f32 and
    f64 runs of the plain path differ by ~5% there."""
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.common import MaskedBatchNorm
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.ops.kernels import fused_gps_front

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
    model = model.to(batch.device).eval()
    nm, em = batch.node_mask, batch.edge_mask

    def fit(bn, v, mask):
        v = v.reshape(mask.shape[0], -1)[mask]
        bn.running_mean.copy_(v.mean(0))
        bn.running_var.copy_(v.var(0, unbiased=False))

    with torch.no_grad():
        fit(model.encoder.rwse.raw_norm, batch.pe["pestat_RWSE"], nm)
        x, e = model.encoder(batch)
        for layer in model.layers:
            xo, gate, sa = fused_gps_front(*front_args(layer, batch, x, e))[:3]
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


def check_kernels(torch, cfg, splits, device):
    """Phase 3: each kernel vs its plain version on layer 0's inputs.
    Returns the rows and the calibrated model's state dict."""
    from graphgps_torch.driver import create_loaders
    from graphgps_torch.ops.kernels.combine_ffn import (combine_ffn_plain,
                                                         fused_combine_ffn)
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
             inputs=[a for a in front_in if torch.is_tensor(a)],
             moment_scales=[moment_scale(torch, v, m, sh) for v, m, sh in (
                 (xo, batch.node_mask, gg.norm_x.running_mean),
                 (gate, batch.edge_mask, gg.norm_e.running_mean),
                 (sa, batch.node_mask, layer.norm_attn.running_mean))],
             # products on the real rows: joint projection, edge projection,
             # QK^T and PV per head, out-projection
             flops=2 * n_real * d * 7 * d + 2 * e_real * d * d
             + 4 * attn_pairs * d + 2 * n_real * d * d),
        dict(name="pre_tail", fn=fused_pre_tail, plain=pre_tail_plain,
             args=tail_args, source="graphgps_torch/csrc/pre_tail.cu",
             replaces="graphgps_tpu/ops/pallas/fused_tail.py:189",
             inputs=[a for a in tail_args if torch.is_tensor(a)],
             # sub, 2 mul, add, gelu (~8), residual add per real element
             flops=13 * e_real * d),
        dict(name="combine_ffn", fn=fused_combine_ffn, plain=combine_ffn_plain,
             args=comb_args, source="graphgps_torch/csrc/combine_ffn.cu",
             replaces="graphgps_tpu/ops/pallas/fused_combine.py:183",
             inputs=[a for a in comb_args if torch.is_tensor(a)],
             flops=4 * n_real * d * dh),
    ]
    results = []
    with torch.no_grad():
        for c in cases:
            got = c["fn"](*c["args"])
            ref = c["plain"](*c["args"])
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for g_ in got:
                if not torch.isfinite(g_).all():
                    fail(f"{c['name']}: non-finite output")
            # tensors: elementwise; the front's (1, 2d) moment sums: against
            # the sum of their terms' magnitudes, since Σm(v−c) cancels to
            # ~0 when c is the mean
            n_t = min(3, len(got))
            err = max(float((g_ - r_).abs().max())
                      for g_, r_ in zip(got[:n_t], ref[:n_t]))
            ok = all(torch.allclose(g_, r_, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
                     for g_, r_ in zip(got[:n_t], ref[:n_t]))
            extra = {}
            if len(got) > n_t:
                rel = max(float(((g_ - r_).abs() / scale).max())
                          for g_, r_, scale in zip(got[n_t:], ref[n_t:],
                                                   c["moment_scales"]))
                ok &= rel <= MOMENT_RTOL
                extra = dict(moments_max_rel_err=rel, moments_rtol=MOMENT_RTOL)
            out_bytes = nbytes(*got)
            byte_s = (nbytes(*c["inputs"]) + out_bytes) / PEAK_BYTES
            flop_s = c["flops"] / PEAK_F32
            row = dict(name=c["name"], route="cuda", source=c["source"],
                       replaces=c["replaces"], max_abs_err=err,
                       rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                       ms=device_ms(torch, lambda: c["fn"](*c["args"])),
                       plain_ms=device_ms(torch,
                                          lambda: c["plain"](*c["args"])),
                       wall_ms=time_ms(torch, lambda: c["fn"](*c["args"])),
                       plain_wall_ms=time_ms(
                           torch, lambda: c["plain"](*c["args"])),
                       bound_ms=max(byte_s, flop_s) * 1e3,
                       bound_by="bytes" if byte_s >= flop_s else "operations",
                       library_ms=None,
                       shapes=dict(B=B, N=N, E=E, d=d, H=H,
                                   real_nodes=n_real, real_edges=e_real),
                       **extra)
            print(json.dumps(row), flush=True)
            if not ok:
                fail(f"{c['name']}: kernel disagrees with its plain version "
                     f"(max abs err {err}, rtol {KERNEL_RTOL}, atol "
                     f"{KERNEL_ATOL})")
            results.append(row)
    layer0 = dict(front=front_in, tail=tail_args, comb=comb_args,
                  n_real=n_real, e_real=e_real, attn_pairs=attn_pairs,
                  B=B, N=N, E=E, d=d, H=H, dh=dh)
    return results, {k: v.clone() for k, v in model.state_dict().items()}, \
        layer0


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


def check_backward(torch, layer0):
    """Phase 3b: the three functions with dropout DROP_RATE on every site,
    forward and backward, through the kernels (autograd Functions) and
    through autograd of their plain versions, on layer 0's inputs at the
    main path's shapes. One JSON line per backward kernel; fails on a
    gradient outside tolerance, a kept fraction outside 230/256 ± 0.5%, or
    two runs of a backward kernel that differ in any bit."""
    from graphgps_torch.ops.kernels import combine_ffn, gps_front, pre_tail
    from graphgps_torch.ops.kernels.common import dropout_mask

    L = layer0
    B, N, E, d, H, dh = (L[k] for k in ("B", "N", "E", "d", "H", "dh"))
    n, e_, pairs = L["n_real"], L["e_real"], L["attn_pairs"]
    R = B * N
    rate, seed = DROP_RATE, DROP_SEED
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)

    def cots_for(outs):
        return [torch.randn(o.shape, generator=g, device=o.device)
                for o in outs]

    fin = tuple(L["front"][:15])
    fconf = (seed, H, L["front"][17], rate, rate)
    tin = tuple(L["tail"][:6])
    tconf = (seed, rate, L["tail"][8])
    cin = tuple(L["comb"][:15])
    cconf = (seed, rate, L["comb"][17])

    def run_front(cots=None):
        outs, (proj, attn) = gps_front._launch_forward(fin, *fconf)
        cots = cots or cots_for(outs)
        kept = (*outs[:3], proj, attn)
        return cots, lambda: gps_front.gps_front_backward(
            *fin, *fconf, *cots, kept=kept)

    def run_tail(cots=None):
        out = pre_tail._launch_forward(*tin, *tconf)
        cots = cots or cots_for([out])
        return cots, lambda: pre_tail.pre_tail_backward(
            *tin[1:], cots[0], *tconf)

    def run_comb(cots=None):
        out, h, z, a1 = combine_ffn._launch_forward(cin, *cconf, True)
        cots = cots or cots_for([out])
        return cots, lambda: combine_ffn.combine_ffn_backward(
            *cin, cots[0], *cconf, kept=(h, a1, z))

    cases = [
        dict(name="gps_front_bwd", run=run_front,
             plain=lambda c: gps_front.gps_front_backward_plain(
                 *fin, *fconf, *c),
             source="graphgps_torch/csrc/gps_front.cu",
             replaces="graphgps_tpu/ops/pallas/fused_layer.py:352",
             sites=[("attention P", B * H * N, N), ("out-projection", R, d)],
             # dx, dWnq (7d wide), de, dWc, dO, dWo, and per head dv, dP,
             # dq, dk over the real pairs
             flops=4 * n * 7 * d * d + 4 * e_ * d * d + 4 * n * d * d
             + 8 * pairs * d),
        dict(name="pre_tail_bwd", run=run_tail,
             plain=lambda c: pre_tail.pre_tail_backward_plain(
                 *tin[1:], c[0], *tconf),
             source="graphgps_torch/csrc/pre_tail.cu",
             replaces="graphgps_tpu/ops/pallas/fused_tail.py:220",
             sites=[("edge tail", B * E, d)],
             # act' (~10), mask, four products and four sums per element
             flops=20 * e_ * d),
        dict(name="combine_ffn_bwd", run=run_comb,
             plain=lambda c: combine_ffn.combine_ffn_backward_plain(
                 *cin, c[0], *cconf),
             source="graphgps_torch/csrc/combine_ffn.cu",
             replaces="graphgps_tpu/ops/pallas/fused_combine.py:235",
             sites=[("local tail", R, d), ("FFN inner", R, dh),
                    ("FFN outer", R, d)],
             # dU = dA2 W2^T, dH = dA1 W1^T, dW1 = H^T dA1, dW2 = Z^T dA2
             flops=8 * n * d * dh),
    ]

    # the pre_tail forward kernel's own mask, read back: x_in = 0 and
    # act(bn(v)) = 1 leave exactly the site-0 multiplier
    zeros = torch.zeros((B * E, d), device="cuda")
    one, zero = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    drawn = pre_tail._launch_forward(zeros, zeros, zero, one, zero, one, seed,
                                     rate, "identity")
    if not torch.equal(drawn, dropout_mask(seed, 0, B * E, d, rate, "cuda")):
        fail("pre_tail: the kernel's mask differs from the port's hash")

    rows = []
    for c in cases:
        cots, bwd = c["run"]()
        got = bwd()
        _, bwd2 = c["run"](cots)
        again = bwd2()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        want = c["plain"](cots)
        ok, err, rel = grads_close(torch, got, want, GRAD_RTOL, GRAD_ATOL)
        kept = {name: float((dropout_mask(seed, i, r_, c_, rate, "cuda") > 0)
                            .float().mean())
                for i, (name, r_, c_) in enumerate(c["sites"])}
        inputs = [t for t in (fin if c["name"] == "gps_front_bwd" else
                              tin[1:] if c["name"] == "pre_tail_bwd" else cin)]
        byte_s = (nbytes(*inputs, *cots) + nbytes(*got)) / PEAK_BYTES
        flop_s = c["flops"] / PEAK_F32
        row = dict(name=c["name"], route="cuda", source=c["source"],
                   replaces=c["replaces"], max_abs_err=err,
                   max_err_over_tensor_max=rel, rtol=GRAD_RTOL,
                   atol=f"{GRAD_ATOL} x max(1, max|grad|)",
                   bit_identical_reruns=same,
                   ms=device_ms(torch, bwd),
                   plain_ms=device_ms(torch, lambda: c["plain"](cots)),
                   wall_ms=time_ms(torch, bwd),
                   plain_wall_ms=time_ms(torch, lambda: c["plain"](cots)),
                   bound_ms=max(byte_s, flop_s) * 1e3,
                   bound_by="bytes" if byte_s >= flop_s else "operations",
                   library_ms=None, rate=rate, kept_fraction=kept)
        print(json.dumps(row), flush=True)
        if not same:
            fail(f"{c['name']}: two runs on the same inputs differ")
        if not ok:
            fail(f"{c['name']}: disagrees with autograd of its plain version "
                 f"(max abs err {err}, {rel} of the tensor's largest entry)")
        for name, frac in kept.items():
            if abs(frac - KEEP_FRACTION) > KEEP_REL_TOL * KEEP_FRACTION:
                fail(f"{c['name']}: site {name!r} keeps {frac}, expected "
                     f"{KEEP_FRACTION}")
        rows.append(row)
    return rows


def rate_loader(cfg, splits, loader, device):
    """RATE_BATCHES full batches of the train split's graphs, repeated in
    order, at the main path's shapes (the same N and edge block): the
    stand-in's splits are small enough that partial batches, which do a
    full batch's work, would otherwise weigh on the rate."""
    from graphgps_torch.data.loader import DeviceLoader

    bs = cfg.train.batch_size
    n = RATE_BATCHES * bs
    graphs = (splits.train * -(-n // len(splits.train)))[:n]
    return DeviceLoader(graphs, bs, device, max_nodes=loader.max_nodes,
                        max_edges=bs * loader.arenas.edge_cap)


def measure_rate(torch, cfg, model, loader) -> dict:
    """The entry point's evaluation step over full batches: graphs/s on the
    host clock over RATE_PASSES passes after one warm-up pass; then one more
    pass under ``torch.profiler`` for the device time by CUDA kernel and the
    device's idle share in that pass's own window. Prints one JSON line per
    kernel name (the largest first)."""
    from graphgps_torch.train.loop import eval_step

    def one_pass():
        for _real, b in loader:
            eval_step(cfg, model, b)

    one_pass()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(RATE_PASSES):
        one_pass()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_batches = RATE_PASSES * len(loader)

    rows, busy_ms, prof_ms = profile_pass(torch, one_pass, len(loader), 15,
                                          "batch")
    batch_ms = 1e3 * wall / n_batches
    return dict(inference_graphs_per_s=n_batches * loader.batch_size / wall,
                full_batches=n_batches, timed_s=wall, batch_ms=batch_ms,
                profiled_batch_ms=prof_ms, device_busy_ms=busy_ms,
                profiled_idle_share=1.0 - busy_ms / prof_ms,
                # busy time of the profiled pass over the same loop's time
                # without the profiler: an estimate across two windows
                idle_share_estimate=1.0 - busy_ms / batch_ms)


def profile_pass(torch, one_pass, n: int, top: int, unit: str):
    """One pass of ``one_pass`` (``n`` batches) under ``torch.profiler``:
    prints the ``top`` CUDA kernels by device time, one JSON line each, and
    returns (rows, device busy ms per batch, profiled wall ms per batch)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows = device_rows(torch, prof)
    busy_us = sum(r[1] for r in rows)
    if busy_us <= 0:
        fail("the profiler recorded no device time")
    for name, us, cnt in rows[:top]:
        print(json.dumps({"device_kernel": name[:90],
                          f"ms_per_{unit}": us / n / 1e3,
                          "share": us / busy_us,
                          f"calls_per_{unit}": cnt / n}), flush=True)
    return rows, busy_us / n / 1e3, 1e3 * prof_wall / n


def check_training_run(torch, cfg, splits, run_dir, device, counts):
    """Phase 4b's checks on the entry point's training run: stats lines,
    launch counts, the best epoch's checkpoint."""
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.train import checkpoint

    bs = cfg.train.batch_size
    steps = TRAIN_EPOCHS * math.ceil(len(splits.train) / bs)
    evals = TRAIN_EPOCHS * sum(math.ceil(len(s) / bs)
                               for s in (splits.val, splits.test))
    # per layer and step, and per layer and evaluated batch for the forward
    # ones; the last layer's edge output does not reach the loss, so autograd
    # runs the edge tail's backward in the other layers only
    expect = {}
    for name in counts:
        per = steps + (0 if name.endswith("_bwd") else evals)
        layers = cfg.gt.layers - (name == "pre_tail_bwd")
        expect[name] = layers * per
    print(json.dumps(dict(train_steps=steps, eval_batches=evals,
                          launches=counts, expected=expect)), flush=True)
    for name, want in expect.items():
        if counts[name] != want:
            fail(f"{name}: {counts[name]} launches in training, expected "
                 f"{want}")
    for split in ("train", "val", "test"):
        path = os.path.join(run_dir, split, "stats.json")
        rows = [json.loads(line) for line in open(path).read().splitlines()]
        if [r["epoch"] for r in rows] != list(range(TRAIN_EPOCHS)):
            fail(f"{split}: stats.json epochs {[r['epoch'] for r in rows]}")
        if not all(math.isfinite(r["loss"]) for r in rows):
            fail(f"{split}: non-finite loss in {rows}")
        if split == "val":
            val = rows
    best = min(range(TRAIN_EPOCHS), key=lambda i: val[i]["mae"])
    saved = checkpoint.saved_epochs(run_dir)
    if saved != [best]:
        fail(f"checkpoints {saved}, expected the best epoch {best}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed + 7)
        model = build_model(cfg, infer_dims(cfg, splits))
    model = model.to(device).eval()
    checkpoint.load_ckpt(run_dir, model)
    preds = []
    with torch.no_grad():
        for _real, batch in create_loaders(cfg, splits, device)["val"]:
            pred, _ = model(batch)
            preds.append(pred[batch.graph_mask].reshape(-1).cpu())
    pred = torch.cat(preds)
    true = torch.tensor([float(g.y.reshape(-1)[0]) for g in splits.val])
    mae = float((pred - true).abs().mean())
    print(json.dumps(dict(best_epoch=best, reloaded_val_mae=mae,
                          logged_val_mae=val[best]["mae"])), flush=True)
    # the stats round to 5 decimals
    if not abs(mae - val[best]["mae"]) <= 1e-5:
        fail(f"the reloaded best checkpoint gives val MAE {mae}, the run "
             f"logged {val[best]['mae']}")


def check_train_step(torch, cfg, splits, batch, device):
    """Phase 4c: one training step (forward, L1 loss, backward, clipping,
    adamW at the base learning rate) of the seeded model on the card and,
    from a copy, on the CPU, with dropout seeds from generators seeded
    alike, so both draw the same masks.

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
    for k in gc:
        ok, e_, r_ = grads_close(torch, [gg[k]], [gc[k]], STEP_GRAD_RTOL,
                                 STEP_GRAD_ATOL, floor)
        if r_ >= g_rel:
            worst, g_err, g_rel = k, e_, r_
        if not ok:
            problems.append(f"gradient of {k} differs: max {e_} ({r_} of "
                            "its scale)")
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
               largest_clean_step=moved, lr=lr)
    print(json.dumps(row), flush=True)
    if not math.isclose(lg, lc, rel_tol=STEP_RTOL, abs_tol=STEP_ATOL):
        problems.append(f"loss {lg} on the card, {lc} on the CPU")
    if moved < 0.5 * lr:
        problems.append(f"the step moved no parameter by lr/2 ({moved})")
    if problems:
        fail("training step, card vs CPU: " + "; ".join(problems))


def measure_train_rate(torch, cfg, model, loader) -> dict:
    """Training steps (``train.loop.train_step``: forward, loss, backward,
    clipping, adamW) over full batches: graphs/s on the host clock over
    RATE_PASSES passes after one warm-up pass, the peak device memory over
    them, then one more pass under ``torch.profiler`` for the device time by
    CUDA kernel and the idle share. Prints one JSON line per kernel name."""
    from graphgps_torch.optim import build_optimizer, set_lr
    from graphgps_torch.train.loop import train_step

    model.train()
    opt = build_optimizer(cfg, model.parameters())
    set_lr(opt, cfg.optim.base_lr)
    gen = torch.Generator().manual_seed(DROP_SEED + 1)

    def one_pass():
        for _real, b in loader:
            train_step(cfg, model, opt, b, gen)

    one_pass()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(RATE_PASSES):
        one_pass()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_steps = RATE_PASSES * len(loader)
    rows, busy_ms, prof_ms = profile_pass(torch, one_pass, len(loader), 30,
                                          "step")
    step_ms = 1e3 * wall / n_steps
    return dict(train_graphs_per_s=n_steps * loader.batch_size / wall,
                full_batches=n_steps, timed_s=wall, step_ms=step_ms,
                profiled_step_ms=prof_ms, device_busy_ms=busy_ms,
                profiled_idle_share=1.0 - busy_ms / prof_ms,
                idle_share_estimate=1.0 - busy_ms / step_ms,
                peak_memory_allocated_gb=peak / 1e9)


def main() -> None:
    if len(sys.argv) > 1:
        fail("takes no arguments")
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    try:
        from graphgps_torch.config import load_cfg, new_cfg, update_from_list
        from graphgps_torch.data.datasets import load_dataset
        from graphgps_torch.driver import create_loaders, main as port_main
        from graphgps_torch.ops import kernels
        from graphgps_torch.ops.kernels import build
    except ImportError as e:
        fail(f"graphgps_torch is not importable ({e}): run from the "
             "repository root")
    if not os.path.exists(CFG):
        fail(f"{CFG} not found: run from the repository root")
    device = torch.device("cuda", 0)

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

    # 3. kernels vs plain versions at the main path's shapes
    with tempfile.TemporaryDirectory() as out_dir:
        opts = ["train.mode", "inference-only", "seed", str(SEED),
                "out_dir", out_dir]
        cfg = new_cfg()
        load_cfg(cfg, CFG)
        update_from_list(cfg, opts)
        splits = load_dataset(cfg)
        rows, state, layer0 = check_kernels(torch, cfg, splits, device)

        # 3b. backward kernels with dropout on
        rows += check_backward(torch, layer0)

        # 4. the evaluation path through the entry point
        held = {}

        def prepare(model):
            model.load_state_dict(state)
            held["model"] = model

        batches = sum(math.ceil(len(s) / cfg.train.batch_size)
                      for s in (splits.train, splits.val, splits.test) if s)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hist = port_main(["--cfg", CFG, *opts], prepare_model=prepare)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        counts = kernels.launch_counts()
        expect = {n: 0 if n.endswith("_bwd") else cfg.gt.layers * batches
                  for n in counts}
        print(json.dumps(dict(main_path_s=main_s, batches=batches,
                              launches=counts, expected=expect)), flush=True)
        for name, n in counts.items():
            if n != expect[name]:
                fail(f"{name}: {n} launches on the evaluation path, expected "
                     f"{expect[name]} ({cfg.gt.layers} per batch)")
        for split, h in hist[SEED].items():
            if not all(math.isfinite(v) for v in h[0].values()
                       if isinstance(v, float)):
                fail(f"{split}: non-finite stats {h[0]}")

        # 4b. the training path through the entry point
        train_opts = ["train.mode", "custom", "seed", str(SEED),
                      "optim.max_epoch", str(TRAIN_EPOCHS),
                      "optim.num_warmup_epochs", "1",
                      "out_dir", os.path.join(out_dir, "train")]
        tcfg = new_cfg()
        load_cfg(tcfg, CFG)
        update_from_list(tcfg, train_opts)
        trained = {}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        port_main(["--cfg", CFG, *train_opts],
                  prepare_model=lambda m: trained.setdefault("model", m))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_counts = kernels.launch_counts()
        print(json.dumps(dict(train_path_s=train_s)), flush=True)
        run_dir = os.path.join(out_dir, "train",
                               os.path.splitext(os.path.basename(CFG))[0],
                               str(SEED))
        check_training_run(torch, tcfg, splits, run_dir, device,
                           train_counts)
        for r in rows:
            r["launches"] = train_counts[r["name"]]

        # 4c. one training step, card vs CPU
        loaders = create_loaders(cfg, splits, device)
        _real, train_batch = next(iter(loaders["train"]))
        check_train_step(torch, tcfg, splits, train_batch, device)

        # 5. the evaluation model on the CPU, and the inference rate
        model = held["model"]
        real, batch = next(iter(loaders["val"]))
        with torch.no_grad():
            pred_gpu, _ = model(batch)
            cpu_model = copy.deepcopy(model).cpu()
            pred_cpu, _ = cpu_model(batch.to("cpu"))
        m = batch.graph_mask.cpu()
        pg, pc = pred_gpu.cpu()[m], pred_cpu[m]
        err = float((pg - pc).abs().max())
        print(json.dumps(dict(cpu_vs_gpu_max_abs_err=err, rtol=MODEL_RTOL,
                              atol=MODEL_ATOL, graphs=int(m.sum()),
                              pred_shape=list(pred_gpu.shape))), flush=True)
        if pred_gpu.shape != (batch.num_graphs, 1) or not torch.isfinite(pg).all():
            fail(f"bad predictions: shape {tuple(pred_gpu.shape)}")
        if not torch.allclose(pg, pc, rtol=MODEL_RTOL, atol=MODEL_ATOL):
            fail(f"GPU vs CPU predictions differ (max abs err {err})")

        full = rate_loader(cfg, splits, loaders["train"], device)
        rate = measure_rate(torch, cfg, model, full)
        print(json.dumps(dict(**rate, card=card)), flush=True)

        # 5b. the training rate, profile and peak memory
        train_rate = measure_train_rate(torch, tcfg, trained["model"], full)
        print(json.dumps(dict(**train_rate, card=card)), flush=True)

    print(card, flush=True)   # name, power limit, as nvidia-smi gives them
    print(json.dumps(dict(kernels=[
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")} for r in rows])),
          flush=True)
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count()))), flush=True)


if __name__ == "__main__":
    main()
