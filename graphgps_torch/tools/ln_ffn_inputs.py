"""The inputs of ``ln_ffn`` at layer 0 of a Graphormer recipe, as
``chip_smoke.py`` phase 3e and ``kernel_ab.py`` take them: the seeded
model on the recipe's first train batch, the rows after the layer's
attention half (graph tokens included), and the layer's LayerNorm and FFN
parameters.

It names the port's modules by their absolute names only, so that
``kernel_ab.py`` can load this file by its path into a process that runs
another checkout's ``graphgps_torch``.
"""
from __future__ import annotations

import torch

from graphgps_torch.config import load_cfg, new_cfg, update_from_list
from graphgps_torch.data.datasets import load_dataset
from graphgps_torch.driver import create_loaders, infer_dims
from graphgps_torch.models.networks import build_model


def ln_ffn_inputs(cfg_path: str, opts, device):
    """(The first train batch, the model seeded by the recipe's seed in
    evaluation on ``device``, ``ln_ffn``'s inputs (h0 (R, d), gamma, beta,
    W1, b1, W2, b2)) of recipe ``cfg_path`` with ``opts`` on top; R is the
    batch's graphs times its slots, the graph token's included."""
    cfg = new_cfg()
    load_cfg(cfg, cfg_path)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    _real, batch = next(iter(create_loaders(cfg, splits, device)["train"]))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = build_model(cfg, infer_dims(cfg, splits))
    model = model.to(device).eval()
    layer, gb = model.layers[0], model.encoder.graphormer
    with torch.no_grad():
        x, _ = model.encoder(batch)
        seq = layer.attention_block(batch, x, gb.token_state(batch.num_graphs),
                                    gb.attn_bias(batch), [0, 0, 0])
    ins = tuple(t.detach().contiguous() for t in (
        seq.reshape(-1, seq.shape[-1]), layer.ln_ffn.weight, layer.ln_ffn.bias,
        layer.w_ffn1, layer.b_ffn1, layer.w_ffn2, layer.b_ffn2))
    return batch, model, ins
