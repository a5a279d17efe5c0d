#!/usr/bin/env python3
"""How far one graphgps_torch training step in f32 lies from the same step
in float64, on the card through the kernels, on the card through the
kernels' plain versions and on the CPU: the conditioning of a recipe's
gradients, apart from any kernel.

Run from the repository root (``chip_smoke.py`` and the package are imported
from the working directory):

    python tools/torch_step_precision.py \\
        --cfg configs/GPS/vocsuperpixels-GPS.yaml \\
        dataset.synth_min_nodes 400 dataset.synth_max_nodes 500 \\
        dataset.synth_num_tasks 21 dataset.synth_num_graphs 160 \\
        --seeds 0 1 --batches 0 2

For each seed and each of the train split's batches named, it builds the
seeded model with BatchNorm statistics calibrated on that batch (as
``chip_smoke.py`` phase 4c starts), takes the gradients of one training step
(forward, loss, backward, clipping) in float64 on the CPU as the reference,
and prints one JSON line with, per run, the largest distance of any
tensor's gradient from the reference over that tensor's scale (its largest
reference entry, floored at 1e-2 of the model's largest):

- ``cpu_f32``: the plain path on the CPU;
- ``card_f64_plain``: float64 on the card (how well the reference itself is
  determined);
- ``card_f32_kernels``: the port as it runs on the card;
- ``card_f32_plain``: the card with ``fused_edge_gate`` and
  ``fused_wide_attention`` replaced by their plain versions;

and, for the two f32 runs on the card, the largest ratio of a tensor's
distance to the CPU's f32 distance of the same tensor, among tensors more
than 1e-4 from the reference. It fails without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[0])
    ap.add_argument("opts", nargs="*", help="config overrides, key value ...")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_step_precision: no CUDA device")
    import chip_smoke
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.models import gps_layer, local_gnn
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.ops.kernels import build, edge_gate, wide_attention
    from graphgps_torch.optim import build_optimizer, set_lr
    from graphgps_torch.train.loop import train_step

    card = torch.device("cuda", 0)
    build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    kernels = (local_gnn.fused_edge_gate, gps_layer.fused_wide_attention)
    plain = (edge_gate.edge_gate_plain, wide_attention.wide_attention_plain)

    def gradients(cfg, splits, batch, state, device, double, long_graph_fns):
        local_gnn.fused_edge_gate, gps_layer.fused_wide_attention = \
            long_graph_fns
        try:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(cfg.seed)
                model = build_model(cfg, infer_dims(cfg, splits))
            model.load_state_dict(state)
            model = (model.double() if double else model).to(device).train()
            opt = build_optimizer(cfg, model.parameters())
            set_lr(opt, cfg.optim.base_lr)
            train_step(cfg, model, opt, batch.to(device),
                       torch.Generator().manual_seed(chip_smoke.DROP_SEED))
        finally:
            local_gnn.fused_edge_gate, gps_layer.fused_wide_attention = \
                kernels
        return {k: p.grad.detach().cpu().double()
                for k, p in model.named_parameters() if p.grad is not None}

    runs = dict(cpu_f32=("cpu", False, plain),
                card_f64_plain=(card, True, plain),
                card_f32_kernels=(card, False, kernels),
                card_f32_plain=(card, False, plain))
    for seed in args.seeds:
        cfg = new_cfg()
        load_cfg(cfg, args.cfg)
        update_from_list(cfg, [*args.opts, "seed", str(seed)])
        splits = load_dataset(cfg)
        infer_dims(cfg, splits)
        batches = [b for _real, b in create_loaders(cfg, splits, card)["train"]]
        for i in args.batches:
            batch = batches[i]
            state = {k: v.clone().cpu() for k, v in chip_smoke.calibrated_model(
                torch, cfg, splits, batch).state_dict().items()}
            ref = gradients(cfg, splits, batch, state, "cpu", True, plain)
            floor = 1e-2 * max(float(g.abs().max()) for g in ref.values())
            scale = {k: max(floor, float(g.abs().max()))
                     for k, g in ref.items()}
            far = {}
            for name, (device, double, fns) in runs.items():
                g = gradients(cfg, splits, batch, state, device, double, fns)
                far[name] = {k: float((g[k] - ref[k]).abs().max()) / scale[k]
                             for k in ref}
            row = dict(cfg=args.cfg, seed=seed, batch=i, tensors=len(ref),
                       card=smi)
            for name, f in far.items():
                row[name] = max(f.values())
            for name in ("card_f32_kernels", "card_f32_plain"):
                ratios = {k: far[name][k] / max(far["cpu_f32"][k], 1e-300)
                          for k in ref if far[name][k] > 1e-4}
                worst = max(ratios, key=ratios.get, default=None)
                row[name + "_over_cpu_f32_worst_tensor"] = worst
                row[name + "_over_cpu_f32_worst_ratio"] = ratios.get(worst)
                row[name + "_tensors_beyond_1e-4"] = len(ratios)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
