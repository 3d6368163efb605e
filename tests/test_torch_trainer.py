"""The port's trainers against the JAX package's: ``train_progressive`` on
both packages from one warm-start tree, and the port's own guarantees (one
seed gives bit-equal parameters without the global RNG, the device cache,
runs without validation, ``train_one_gnn``).  On the CPU, at a small width
(hidden 32, 2 layers, top-k 4, n in {16, 24}); each test states its
tolerance.
"""

import json

import jax
import numpy as np
import pytest
import torch

from lapgnn_tpu.train import progressive as jprog
from lapgnn_tpu_torch.train import checkpoint as tckpt
from lapgnn_tpu_torch.train import progressive as tprog
from lapgnn_tpu_torch.train import trainer as ttrainer

from test_torch_train import HIDDEN, LAYERS, TOPK, _assert_tree_close, _flax_params


def _records(fam, n, count, seed):
    from lapgnn_tpu_torch.data.synthetic import generate_synthetic_instance, instance_record

    rng = np.random.default_rng(seed)
    return [instance_record(generate_synthetic_instance(fam, n, rng)) for _ in range(count)]


def _config(tmp, epochs=2, dropout=0.0, **training):
    return {
        "model": {"hidden": HIDDEN, "layers": LAYERS, "dropout": dropout, "topk": TOPK,
                  "use_cost_refinement": True},
        "loss": {"normalize_gap": True, "normalize_costs": True},
        "optimizer": {"lr": 3e-3, "weight_decay": 1e-4, "grad_clip": 1.0,
                      "warmup_frac": 0.2, "min_lr": 1e-5},
        "sampling": {"batches_per_size": 2},
        "training": {"epochs": epochs, "min_epochs": 1, "patience": 4, "seed": 19, **training},
        "checkpointing": {"output_dir": str(tmp)},
    }


@pytest.fixture(scope="module")
def curriculum():
    return {
        "a": (_records("uniform", 16, 6, 0), _records("uniform", 16, 3, 1)),
        "b": (_records("noisy_linear", 24, 4, 2), None),
    }


def _specs(mod, data):
    return [mod.DatasetSpec("a", 16, data["a"][0], val_instances=data["a"][1]),
            mod.DatasetSpec("b", 24, data["b"][0], curriculum_start_epoch=1)]


def test_train_progressive_matches_jax(tmp_path, curriculum):
    """2 epochs over 2 sizes (the second joins at epoch 1), a val split, warm
    init from one tree, dropout 0, on both packages: 6 steps.  History within
    1e-4 relative.  Final params within 2e-5 absolute: gradients agree to
    float32 rounding and Adam's steps follow them (the largest difference
    found was 6.4e-6).  The head's last bias is held to lr * steps only: the
    gauge centring cancels its exact gradient, so both packages feed Adam
    rounding noise there, which Adam's normalisation turns into steps of up
    to lr; it shifts every u alike and the centring removes it."""
    _, init = _flax_params(16, refine=True, seed=3)
    jbest, jhist = jprog.train_progressive(_config(tmp_path / "j"), _specs(jprog, curriculum),
                                           init_params=init, log_fn=lambda s: None)
    logs = []
    tbest, thist = tprog.train_progressive(_config(tmp_path / "t"), _specs(tprog, curriculum),
                                           init_params=init, log_fn=logs.append, device="cpu")
    assert logs[0] == "warm init: 28/28 leaves restored"
    assert set(thist) == set(jhist)
    for k in jhist:
        np.testing.assert_allclose(thist[k], jhist[k], rtol=1e-4, err_msg=k)
    jbest = jax.tree_util.tree_map(np.asarray, jbest)
    lr_steps = 3e-3 * 6
    np.testing.assert_allclose(tbest["params"]["head_fc2"].pop("bias"),
                               jbest["params"]["head_fc2"].pop("bias"), rtol=0, atol=lr_steps)
    _assert_tree_close(tbest, jbest, 0, 2e-5)
    for d in ("best", "last"):
        tm = json.loads((tmp_path / "t" / d / "meta.json").read_text())
        jm = json.loads((tmp_path / "j" / d / "meta.json").read_text())
        assert tm.keys() == jm.keys() and tm["epoch"] == jm["epoch"]
        assert tm["config"]["checkpointing"]["output_dir"].endswith("t")
        assert {**tm["config"], "checkpointing": 0} == {**jm["config"], "checkpointing": 0}
    assert (tmp_path / "t" / "last" / "opt_state.pt").exists()
    assert not (tmp_path / "t" / "best" / "opt_state.pt").exists()


@pytest.mark.parametrize("cache", ["off", "bf16", "f32"])
def test_train_progressive_is_deterministic_and_leaves_the_global_rng(tmp_path, curriculum, cache, monkeypatch):
    """One seed, dropout on: two CPU runs end with bit-equal params, without
    touching the global torch RNG; the device cache (its gate lowered to
    these sizes) caches and trains."""
    monkeypatch.setattr(tprog, "DEVICE_CACHE_MIN_N", 16)
    state = torch.get_rng_state()
    runs = []
    for k in range(2):
        logs = []
        cfg = _config(tmp_path / str(k), epochs=1, dropout=0.2, device_cache=cache)
        runs.append(tprog.train_progressive(cfg, _specs(tprog, curriculum), log_fn=logs.append,
                                            device="cpu"))
        assert any(s.startswith("device-cached a") for s in logs) == (cache != "off")
    assert torch.equal(state, torch.get_rng_state())
    _assert_tree_close(runs[0][0], runs[1][0], 0, 0)
    assert runs[0][1] == runs[1][1] and np.isfinite(runs[0][1]["train_loss"]).all()


def test_train_progressive_without_validation_keeps_latest(tmp_path, curriculum):
    specs = [tprog.DatasetSpec("a", 16, curriculum["a"][0])]
    best, hist = tprog.train_progressive(_config(tmp_path, epochs=1), specs, log_fn=lambda s: None,
                                         device="cpu")
    params, _, _ = tckpt.load_checkpoint(tmp_path / "last")
    _assert_tree_close(best, params, 0, 0)
    assert hist["val_gap_median_avg"] == [float("inf")]
    assert not (tmp_path / "best").exists()
    with pytest.raises(ValueError):
        tprog.train_progressive(_config(tmp_path), [], device="cpu")
    with pytest.raises(ValueError, match="device_cache"):
        tprog.train_progressive(_config(tmp_path, device_cache="x"), specs, device="cpu")


def test_train_one_gnn_runs_on_the_cpu(curriculum):
    cfg = ttrainer.TrainConfig(hidden=HIDDEN, layers=1, topk=TOPK, epochs=2, batch_size=4,
                               min_epochs=1, patience=1, use_cost_refinement=True, dropout=0.1)
    logs = []
    best, hist = ttrainer.train_one_gnn(curriculum["a"][0], curriculum["a"][1], cfg,
                                        log_fn=logs.append, device="cpu")
    assert len(hist["train_loss"]) == len(logs) >= 1 and np.isfinite(hist["train_loss"]).all()
    assert set(best["params"]) == set(_flax_params(16)[1]["params"]) - {"block_1"}
