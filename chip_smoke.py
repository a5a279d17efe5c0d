#!/usr/bin/env python3
"""Smoke test of graphgps_torch on one NVIDIA GPU (H100, sm_90a).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and fails (non-zero exit, no result line) without
one. Phases, each fatal on failure:

1. the card's name and power limit (nvidia-smi);
2. build the hand-written CUDA kernels from ``graphgps_torch/csrc`` (one
   ``nvcc`` per source, all at once);
3. hold each kernel against its plain PyTorch version on the card, on the
   inputs layer 0 of the main path gives it (PCQM4Mv2 GPS-deep: batch 256,
   d=256, 8 heads, seeded weights, non-trivial BatchNorm statistics), and
   time both with CUDA events;
4. run the port's entry point ``graphgps_torch.driver.main`` (``train.mode
   inference-only`` on ``configs/GPS/pcqm4m-GPSdeep+RWSE.yaml``, 16 layers)
   with every launch count set to 0 just before, and check that each kernel
   ran 16 times per batch;
5. check one batch's predictions against the same model on the CPU (the
   plain path); measure the inference rate in graphs/s over full batches,
   then profile the same loop once more for the device time by CUDA kernel
   and the device's idle share.

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
                       ms=time_ms(torch, lambda: c["fn"](*c["args"])),
                       plain_ms=time_ms(torch, lambda: c["plain"](*c["args"])),
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
    return results, {k: v.clone() for k, v in model.state_dict().items()}


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

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    rows = sorted(((e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if busy_us <= 0:
        fail("the profiler recorded no device time")
    nb = len(loader)
    for name, us, n in rows[:15]:
        print(json.dumps(dict(device_kernel=name[:80],
                              ms_per_batch=us / nb / 1e3,
                              share=us / busy_us, calls_per_batch=n / nb)),
              flush=True)
    busy_ms = busy_us / nb / 1e3
    prof_ms = 1e3 * prof_wall / nb
    batch_ms = 1e3 * wall / n_batches
    return dict(inference_graphs_per_s=n_batches * loader.batch_size / wall,
                full_batches=n_batches, timed_s=wall, batch_ms=batch_ms,
                profiled_batch_ms=prof_ms, device_busy_ms=busy_ms,
                profiled_idle_share=1.0 - busy_ms / prof_ms,
                # busy time of the profiled pass over the same loop's time
                # without the profiler: an estimate across two windows
                idle_share_estimate=1.0 - busy_ms / batch_ms)


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
        rows, state = check_kernels(torch, cfg, splits, device)

        # 4. the main path through the entry point
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
        expect = cfg.gt.layers * batches
        print(json.dumps(dict(main_path_s=main_s, batches=batches,
                              launches=counts, expected_each=expect)),
              flush=True)
        for name, n in counts.items():
            if n != expect:
                fail(f"{name}: {n} launches on the main path, expected "
                     f"{expect} ({cfg.gt.layers} per batch)")
        for split, h in hist[SEED].items():
            if not all(math.isfinite(v) for v in h[0].values()
                       if isinstance(v, float)):
                fail(f"{split}: non-finite stats {h[0]}")
        for r in rows:
            r["launches"] = counts[r["name"]]

        # 5. the same model on the CPU, and the inference rate
        model = held["model"]
        loaders = create_loaders(cfg, splits, device)
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

        rate = measure_rate(torch, cfg, model,
                            rate_loader(cfg, splits, loaders["train"], device))
        print(json.dumps(dict(**rate, card=card)), flush=True)

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
