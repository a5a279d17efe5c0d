"""The whole GPSModel (Atom+RWSE and Bond encoders, 2 GPS layers at d=128
with 4 heads, san_graph head) of the port against the JAX model, after
``graphgps_torch.weights`` carries the JAX init across with random
BatchNorm statistics put into ``batch_stats``; the JAX layer stack scanned
and unrolled, the JAX front merged. f32; tolerance rtol = atol = 1e-4."""
import jax
import numpy as np
import pytest
import torch

from tests.test_torch_data import both_loaders
from tests.test_torch_layer import randomize_norms

torch.set_num_threads(2)

RTOL = ATOL = 1e-4


@pytest.mark.parametrize("scan", ["true", "false"])
def test_gps_model_matches_jax(monkeypatch, scan):
    from graphgps_tpu.models.networks import build_model as jbuild
    from graphgps_torch.driver import infer_dims
    from graphgps_torch.models.networks import build_model
    from graphgps_torch.weights import load_flax

    monkeypatch.setenv("GGPS_FUSED_FRONT", "1")
    jcfg, jsplits, jloaders, tcfg, tsplits, tloaders = both_loaders(
        "parallel.scan_layers", scan)
    dim_out = infer_dims(tcfg, tsplits)
    jmodel = jbuild(jcfg, dim_out)
    _, jb = next(iter(jloaders["val"]))      # a partial batch: 4 of 8 real
    key = jax.random.PRNGKey(0)
    var = jmodel.init({"params": key, "dropout": key, "signflip": key}, jb,
                      False)
    params, stats = randomize_norms(var["params"], var["batch_stats"], seed=9)

    model = build_model(tcfg, dim_out).eval()
    load_flax(model, params, stats)
    for split in ("val", "train"):
        _, jb = next(iter(jloaders[split]))
        _, tb = next(iter(tloaders[split]))
        want, jtrue = jmodel.apply({"params": params, "batch_stats": stats},
                                   jb, False)
        with torch.no_grad():
            got, true = model(tb)
        assert got.shape == (8, 1)
        np.testing.assert_array_equal(true.numpy(), np.asarray(jtrue))
        m = tb.graph_mask.numpy()
        np.testing.assert_allclose(got.numpy()[m], np.asarray(want)[m],
                                   rtol=RTOL, atol=ATOL, err_msg=split)


def test_unsupported_configs_raise():
    from graphgps_torch.models.networks import build_model
    from tests.test_torch_data import small_cfgs

    for key, val in (("gt.layer_type", "GIN+Transformer"),
                     ("gt.layer_norm", "true"),
                     ("gnn.head", "ogb_code_graph"),
                     ("gt.dim_hidden", "32")):
        _, cfg = small_cfgs(key, val)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(cfg, 1)
