"""The port's entry point and its import hygiene.

- ``python -m graphgps_torch.main --device cpu`` on the GPS-deep recipe cut
  to test size evaluates every split and writes ``stats.json``; with
  ``train.mode custom`` it trains, writes one stats line per epoch and
  split, and keeps the best epoch's checkpoint, which reloads;
- without ``--device`` the entry point runs on the GPU, so a machine with
  no CUDA device raises instead of carrying on on the CPU;
- training refuses gradient accumulation and runs K steps per dispatch;
- ``graphgps_torch`` and ``chip_smoke.py`` import nothing of JAX, flax or
  ``graphgps_tpu``.
"""
import ast
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_data import CFG, SMALL

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "graphgps_tpu")


def test_main_cli_cpu_writes_stats(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "graphgps_torch.main", "--device", "cpu",
         "--cfg", CFG, *SMALL, "out_dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = tmp_path / "pcqm4m-GPSdeep+RWSE" / "0"
    for split in ("train", "val", "test"):
        stats = [json.loads(line) for line in
                 (run / split / "stats.json").read_text().splitlines()]
        assert len(stats) == 1 and stats[0]["epoch"] == 0
        assert 0.0 < stats[0]["mae"] < 10.0
        assert stats[0]["loss"] == pytest.approx(stats[0]["mae"], rel=1e-4)


def test_pcqm4mv2_inference_mode(tmp_path):
    """The OGB-LSC mode reports MAE on labelled splits (the synthetic
    stand-in labels every split), agreeing with inference-only's stats."""
    from graphgps_torch.driver import main

    base = ["--device", "cpu", "--cfg", CFG, *SMALL]
    lsc = main(base + ["train.mode", "PCQM4Mv2-inference",
                       "out_dir", str(tmp_path / "a")])[0]
    ref = main(base + ["out_dir", str(tmp_path / "b")])[0]
    assert set(lsc) == {"train", "val", "test"}
    for split, rows in lsc.items():
        assert rows[0]["n"] > 0
        assert rows[0]["mae"] == pytest.approx(ref[split][0]["mae"], abs=1e-5)


def test_main_without_cuda_raises(tmp_path):
    from graphgps_torch.driver import main

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--cfg", CFG, *SMALL, "out_dir", str(tmp_path)])


def test_main_cli_cpu_trains(tmp_path):
    """Three epochs of the recipe's custom mode (dropout 0.1, adamW,
    linear warm-up over 1 epoch, clipping): a finite stats line per epoch in
    every split, lr 0 in epoch 0, and the best val epoch's checkpoint alone
    left, which loads into a fresh model and gives the same predictions."""
    from graphgps_torch.config import load_cfg, new_cfg, update_from_list
    from graphgps_torch.data.datasets import load_dataset
    from graphgps_torch.driver import create_loaders, infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.train import checkpoint

    opts = [*SMALL, "train.mode", "custom", "optim.max_epoch", "3",
            "optim.num_warmup_epochs", "1", "out_dir", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "graphgps_torch.main", "--device", "cpu",
         "--cfg", CFG, *opts], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    run = tmp_path / "pcqm4m-GPSdeep+RWSE" / "0"
    stats = {split: [json.loads(line) for line in
                     (run / split / "stats.json").read_text().splitlines()]
             for split in ("train", "val", "test")}
    for split, rows in stats.items():
        assert [r["epoch"] for r in rows] == [0, 1, 2], split
        assert all(0.0 < r["loss"] < 10.0 for r in rows), split
    assert [r["lr"] for r in stats["train"]] == pytest.approx(
        [0.0, 2e-4, 1e-4])
    best = min(range(3), key=lambda i: stats["val"][i]["mae"])
    assert checkpoint.saved_epochs(str(run)) == [best]

    cfg = new_cfg()
    load_cfg(cfg, CFG)
    update_from_list(cfg, opts)
    splits = load_dataset(cfg)
    torch.manual_seed(123)
    model = build_model(cfg, infer_dims(cfg, splits))
    assert checkpoint.load_ckpt(str(run), model) == best + 1
    model.eval()
    preds = []
    with torch.no_grad():
        for _real, batch in create_loaders(cfg, splits, "cpu")["val"]:
            pred, _ = model(batch)
            preds.append(pred[batch.graph_mask].reshape(-1))
    pred = torch.cat(preds).numpy()
    true = np.concatenate([g.y for g in splits.val]).reshape(-1)
    mae = float(np.abs(pred - true).mean())
    assert mae == pytest.approx(stats["val"][best]["mae"], abs=1e-5)


def test_training_resumes_from_checkpoint(tmp_path):
    """``train.auto_resume``: a run of 2 epochs checkpoints its last epoch
    (``ckpt_best`` off), and a second run of 3 restores model, optimizer and
    dropout generator from it and trains epoch 2 only."""
    from graphgps_torch.driver import main
    from graphgps_torch.train import checkpoint

    base = ["--device", "cpu", "--cfg", CFG, *SMALL, "train.mode", "custom",
            "train.ckpt_best", "False", "optim.num_warmup_epochs", "0",
            "out_dir", str(tmp_path)]
    first = main(base + ["optim.max_epoch", "2"])[0]
    run = tmp_path / "pcqm4m-GPSdeep+RWSE" / "0"
    assert checkpoint.saved_epochs(str(run)) == [1]
    second = main(base + ["optim.max_epoch", "3", "train.auto_resume",
                          "True"])[0]
    assert [r["epoch"] for r in first["train"]] == [0, 1]
    assert [r["epoch"] for r in second["train"]] == [2]
    rows = (run / "train" / "stats.json").read_text().splitlines()
    assert [json.loads(r)["epoch"] for r in rows] == [0, 1, 2]
    assert checkpoint.saved_epochs(str(run)) == [1, 2]


@pytest.mark.parametrize("key", ["optim.batch_accumulation",
                                 "train.steps_per_dispatch"])
def test_training_mode_raises(tmp_path, key):
    """What training still refuses: gradient accumulation, naming its
    ROADMAP item. K = 2 steps per dispatch, which it refused before, runs:
    one train stats line per epoch."""
    from graphgps_torch.driver import main

    argv = ["--device", "cpu", "--cfg", CFG, *SMALL, "train.mode", "custom",
            key, "2", "optim.max_epoch", "2", "out_dir", str(tmp_path)]
    if key == "optim.batch_accumulation":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            main(argv)
        return
    hist = main(argv)[0]
    assert [r["epoch"] for r in hist["train"]] == [0, 1]
    rows = (tmp_path / "pcqm4m-GPSdeep+RWSE" / "0" / "train" /
            "stats.json").read_text().splitlines()
    assert [json.loads(r)["epoch"] for r in rows] == [0, 1]


def _sources():
    files = sorted((ROOT / "graphgps_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_package_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        f"for m in {FORBIDDEN!r}: sys.modules[m] = None\n"
        "import graphgps_torch\n"
        "for mod in pkgutil.walk_packages(graphgps_torch.__path__,"
        " 'graphgps_torch.'):\n"
        "    importlib.import_module(mod.name)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
