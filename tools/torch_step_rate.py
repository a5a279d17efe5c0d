#!/usr/bin/env python3
"""Host-clock rate of graphgps_torch training and evaluation steps on one
CUDA device, for comparing two trees of the port in one run.

Run from the root of a tree that holds ``graphgps_torch`` (the package is
imported from the working directory, so the same script times any checkout):

    python tools/torch_step_rate.py --cfg configs/GPS/pcqm4m-GPSdeep+RWSE.yaml

It builds the seeded model of the recipe, takes the train split's full
batches, and times ``--passes`` passes of ``--steps`` training steps
(forward, loss, backward, clipping, adamW) and of as many evaluation steps
after one warm-up pass each, synchronizing before each reading. It prints
one JSON line: ms per step and graphs/s for both, with the card's name and
power limit. It fails without a CUDA device.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch_step_rate: no CUDA device")
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.optim import build_optimizer, set_lr
    from graphgps_torch.train.loop import eval_step, train_step

    device = torch.device("cuda", 0)
    cfg = new_cfg()
    load_cfg(cfg, args.cfg)
    update_from_list(cfg, ["train.mode", "custom"])
    splits = load_dataset(cfg)
    dim_out = infer_dims(cfg, splits)
    loader = create_loaders(cfg, splits, device)["train"]
    bs = cfg.train.batch_size
    full = [b for real, b in loader if real == bs]
    batches = (full * -(-args.steps // len(full)))[:args.steps]
    torch.manual_seed(cfg.seed)
    model = build_model(cfg, dim_out).to(device)
    opt = build_optimizer(cfg, model.parameters())
    set_lr(opt, cfg.optim.base_lr)
    gen = torch.Generator().manual_seed(cfg.seed)

    def timed(step) -> float:
        for b in batches:
            step(b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.passes):
            for b in batches:
                step(b)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (args.passes * len(batches))

    model.train()
    train_ms = timed(lambda b: train_step(cfg, model, opt, b, gen))
    model.eval()
    eval_ms = timed(lambda b: eval_step(cfg, model, b))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(tag=args.tag, cfg=args.cfg, batch=bs,
                          steps=args.passes * len(batches),
                          train_step_ms=train_ms,
                          train_graphs_per_s=1e3 * bs / train_ms,
                          eval_batch_ms=eval_ms,
                          eval_graphs_per_s=1e3 * bs / eval_ms, card=card)))


if __name__ == "__main__":
    main()
