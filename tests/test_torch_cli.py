"""The port's data and training CLIs against the JAX package's, in process,
on the CPU (``--device cpu``).

The data CLIs (``generate_dataset``, ``regenerate_assignments``) are numpy
and SciPy on both sides: their HDF5 files must be equal, dataset for
dataset.  Each training CLI is held twice: with the trainer replaced by a
recorder on both sides, the two CLIs must hand their trainers the same
configuration and data and write the same ``meta.json``; and the port's CLI
then trains for real on a tiny split into a checkpoint that the JAX
package's ``load_checkpoint`` reads.  ``train_dual_gnn`` also runs for real
on both sides, warm-started from one checkpoint at dropout 0, on a crafted
validation split whose gap is 0 every epoch (n = 1: the only assignment is
optimal and the dual bound is tight), so that both stop early at the same
epoch; the histories agree within 1e-4 relative.
"""

import dataclasses
import json
from pathlib import Path

import h5py
import jax
import numpy as np
import pytest

from lapgnn_tpu.cli import generate_dataset as j_generate
from lapgnn_tpu.cli import regenerate_assignments as j_regenerate
from lapgnn_tpu.cli import train_dual_gnn as j_train_dual
from lapgnn_tpu.cli import train_one_gnn as j_train_one
from lapgnn_tpu.cli import train_progressive as j_train_prog
from lapgnn_tpu.train import checkpoint as jckpt
from lapgnn_tpu_torch.cli import generate_dataset, regenerate_assignments
from lapgnn_tpu_torch.cli import train_dual_gnn, train_one_gnn, train_progressive

from test_torch_dual_train import jax_init_by_shape  # noqa: F401  (a fixture)

ARTIFACTS = Path(__file__).resolve().parent.parent / "artifacts"
GEN = ["--sizes", "8", "12", "--families", "uniform", "sparse", "tie", "--instances", "5",
       "--split", "0.6", "0.2", "0.2", "--dual-noise-prob", "0.5", "--seed", "4"]


def _h5_equal(a, b):
    with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
        assert set(fa) == set(fb)
        for key in fa:
            x, y = fa[key][:], fb[key][:]
            assert x.dtype == y.dtype and x.shape == y.shape, key
            for i, (p, q) in enumerate(zip(x, y)):
                np.testing.assert_array_equal(p, q, err_msg=f"{key}[{i}]")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Both CLIs' files from one set of arguments, and a tiny training set:
    n = 16 train / val, and a validation split of n = 1 instances."""
    root = tmp_path_factory.mktemp("cli")
    j_generate.main(["--output", str(root / "j")] + GEN)
    generate_dataset.main(["--output", str(root / "t")] + GEN)
    generate_dataset.main(["--output", str(root / "tiny"), "--sizes", "16", "--families", "uniform",
                           "noisy_linear", "--instances", "6", "--split", "0.67", "0.33", "0.0",
                           "--seed", "3"])
    generate_dataset.main(["--output", str(root / "one"), "--sizes", "1", "--families", "uniform",
                           "--instances", "3", "--split", "0.0", "1.0", "0.0", "--seed", "5"])
    return root


@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_generate_dataset_writes_what_jax_writes(datasets, split):
    """Every dataset of every split file is equal (tags, families, noise,
    labels and costs): one Generator, consumed in the same order."""
    _h5_equal(datasets / "t" / f"{split}.h5", datasets / "j" / f"{split}.h5")


@pytest.mark.parametrize("refresh", [False, True])
def test_regenerate_assignments_writes_what_jax_writes(datasets, tmp_path, refresh):
    args = ["--input", str(datasets / "j" / "train.h5")] + (["--refresh-duals"] if refresh else [])
    j_regenerate.main(args + ["--output", str(tmp_path / "j.h5")])
    regenerate_assignments.main(args + ["--output", str(tmp_path / "t.h5")])
    _h5_equal(tmp_path / "t.h5", tmp_path / "j.h5")


# ---------------------------------------------------------------- the training CLIs, recorded


def _recorder(calls):
    """A trainer that records what it is handed and returns a fixed tree."""
    def train(*args, **kwargs):
        calls.append((args, kwargs))
        return ({"params": {"w": np.arange(3, dtype=np.float32)}},
                {"train_loss": [1.5], "val_gap_median": [2.5]})

    return train


def _config(args):
    cfg = next(a for a in args if dataclasses.is_dataclass(a))
    return dataclasses.asdict(cfg)


def _records_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=k)


@pytest.mark.parametrize("extra", [[], ["--context", "--use-cost-refinement", "--topk", "4",
                                        "--hidden", "16", "--weight-decay", "0.01"]])
def test_train_one_gnn_cli_hands_its_trainer_what_jax_does(datasets, tmp_path, monkeypatch, extra):
    import lapgnn_tpu.train.trainer as jt
    import lapgnn_tpu_torch.train.trainer as tt

    jcalls, tcalls = [], []
    monkeypatch.setattr(jt, "train_one_gnn", _recorder(jcalls))
    monkeypatch.setattr(tt, "train_one_gnn", _recorder(tcalls))
    args = ["--train", str(datasets / "tiny" / "train.h5"), "--val", str(datasets / "tiny" / "val.h5"),
            "--epochs", "3"] + extra
    j_train_one.main(args + ["--output", str(tmp_path / "j")])
    train_one_gnn.main(args + ["--output", str(tmp_path / "t"), "--device", "cpu"])
    (jargs, _), (targs, tkw) = jcalls[0], tcalls[0]
    assert _config(targs) == _config(jargs) and tkw == {"device": "cpu"}
    _records_equal(targs[0], jargs[0])
    _records_equal(targs[1], jargs[1])
    assert json.loads((tmp_path / "t" / "meta.json").read_text()) == \
        json.loads((tmp_path / "j" / "meta.json").read_text())


@pytest.mark.parametrize("extra", [[], ["--raw-reference-loss", "--heads", "2", "--seed", "7"]])
def test_train_dual_gnn_cli_hands_its_trainer_what_jax_does(datasets, tmp_path, monkeypatch, extra):
    """Also ``--init-checkpoint`` (the tree loaded on both sides) and
    ``--raw-reference-loss`` (clipping, normalisation and supervision off)."""
    import lapgnn_tpu.train.dual_trainer as jdt
    import lapgnn_tpu_torch.train.dual_trainer as tdt

    jcalls, tcalls = [], []
    monkeypatch.setattr(jdt, "train_dual_gnn", _recorder(jcalls))
    monkeypatch.setattr(tdt, "train_dual_gnn", _recorder(tcalls))
    args = ["--train", str(datasets / "tiny" / "train.h5"), "--val", str(datasets / "tiny" / "val.h5"),
            "--init-checkpoint", str(ARTIFACTS / "dual_gnn_r3")] + extra
    j_train_dual.main(args + ["--output", str(tmp_path / "j")])
    train_dual_gnn.main(args + ["--output", str(tmp_path / "t"), "--device", "cpu"])
    (jargs, jkw), (targs, tkw) = jcalls[0], tcalls[0]
    cfg = _config(targs)
    assert cfg == _config(jargs)
    assert cfg["clip_sentinels"] == cfg["normalize_gap"] == cfg["supervise_duals"] == (not extra)
    assert tkw["device"] == "cpu" and jkw["mesh"] is None
    want = jax.tree_util.tree_leaves(jkw["init_params"])
    got = jax.tree_util.tree_leaves(tkw["init_params"])
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    _records_equal(targs[0], jargs[0])
    assert json.loads((tmp_path / "t" / "meta.json").read_text()) == \
        json.loads((tmp_path / "j" / "meta.json").read_text())


class _Mesh:
    shape = {"row": 2, "col": 2}


@pytest.mark.parametrize("spec", ["2x2", "auto", "4x1"])
def test_train_dual_gnn_cli_builds_the_mesh_jax_does(datasets, tmp_path, monkeypatch, spec):
    """``--mesh-2d``: both CLIs ask ``dual_mesh`` for the same factorisation
    and hand what it returns to their trainers as ``mesh``; the port's joins
    the job's process group first (stood in for here: the pytest process
    joins none)."""
    import lapgnn_tpu.parallel.dual as jdual
    import lapgnn_tpu.train.dual_trainer as jdt
    import lapgnn_tpu_torch.parallel as tpar
    import lapgnn_tpu_torch.train.dual_trainer as tdt

    jcalls, tcalls, jmesh, tmesh, joined = [], [], [], [], []
    monkeypatch.setattr(jdt, "train_dual_gnn", _recorder(jcalls))
    monkeypatch.setattr(tdt, "train_dual_gnn", _recorder(tcalls))
    monkeypatch.setattr(jdual, "dual_mesh", lambda **kw: jmesh.append(kw) or _Mesh())
    monkeypatch.setattr(tpar, "dual_mesh", lambda **kw: tmesh.append(kw) or _Mesh())
    monkeypatch.setattr(tpar, "initialize_distributed", lambda **kw: joined.append(kw) or True)
    args = ["--train", str(datasets / "tiny" / "train.h5"), "--mesh-2d", spec, "--epochs", "1"]
    j_train_dual.main(args + ["--output", str(tmp_path / "j")])
    train_dual_gnn.main(args + ["--output", str(tmp_path / "t"), "--device", "cpu"])
    device = tmesh[0].pop("device")
    assert tmesh == jmesh and device == "cpu" and joined == [{"device": "cpu"}]
    assert jmesh[0] == ({} if spec == "auto" else dict(zip(("row", "col"), map(int, spec.split("x")))))
    assert isinstance(jcalls[0][1]["mesh"], _Mesh) and isinstance(tcalls[0][1]["mesh"], _Mesh)
    assert _config(tcalls[0][0]) == _config(jcalls[0][0])
    assert (tmp_path / "t" / "meta.json").exists()


def _progressive_yaml(tmp_path, datasets, out_dir):
    """The YAML of the JAX package's ``test_train_progressive_cli``."""
    cfg = tmp_path / "prog.yaml"
    cfg.write_text(f"""
datasets:
  - name: tiny16
    path: {datasets / 'tiny' / 'train.h5'}
    val_path: {datasets / 'tiny' / 'val.h5'}
    size: 16
model:
  hidden: 16
  layers: 1
  topk: 4
  use_cost_refinement: true
optimizer:
  lr: 1.0e-3
sampling:
  batches_per_size: 1
training:
  epochs: 1
  min_epochs: 1
checkpointing:
  output_dir: {out_dir}
""")
    return cfg


def test_train_progressive_cli_hands_its_trainer_what_jax_does(datasets, tmp_path, monkeypatch):
    import lapgnn_tpu.train.progressive as jp
    import lapgnn_tpu_torch.train.progressive as tp

    jcalls, tcalls = [], []
    monkeypatch.setattr(jp, "train_progressive",
                        lambda *a, **k: (jcalls.append((a, k)), (None, {"val_gap_median_avg": []}))[1])
    monkeypatch.setattr(tp, "train_progressive",
                        lambda *a, **k: (tcalls.append((a, k)), (None, {"val_gap_median_avg": []}))[1])
    cfg = _progressive_yaml(tmp_path, datasets, tmp_path / "out")
    args = ["--config", str(cfg), "--init-checkpoint", str(ARTIFACTS / "one_gnn_default")]
    j_train_prog.main(args)
    train_progressive.main(args + ["--device", "cpu"])
    (jargs, jkw), (targs, tkw) = jcalls[0], tcalls[0]
    assert targs[0] == jargs[0]
    for ts, js in zip(targs[1], jargs[1], strict=True):
        assert (ts.name, ts.size, ts.weight, ts.curriculum_start_epoch) == \
            (js.name, js.size, js.weight, js.curriculum_start_epoch)
        _records_equal(ts.instances, js.instances)
        _records_equal(ts.val_instances, js.val_instances)
    assert tkw["device"] == "cpu"
    assert [np.asarray(a).tobytes() for a in jax.tree_util.tree_leaves(tkw["init_params"])] == \
        [np.asarray(a).tobytes() for a in jax.tree_util.tree_leaves(jkw["init_params"])]


# ---------------------------------------------------------------- the training CLIs, for real


def _jax_reads(path, arch):
    params, meta, _ = jckpt.load_checkpoint(path)
    assert meta["architecture"] == arch
    assert all(np.isfinite(np.asarray(a)).all() for a in jax.tree_util.tree_leaves(params))
    return params, meta


def test_train_one_gnn_and_progressive_clis_train_on_the_cpu(datasets, tmp_path):
    """``train_one_gnn --context`` and ``train_progressive`` (the JAX test's
    YAML) on the CPU: checkpoints that the JAX package reads, a context
    model's ``ctx_*`` leaves among them, and ``cli.eval`` serves the first."""
    from lapgnn_tpu_torch.cli import eval as eval_cli

    tiny = datasets / "tiny"
    train_one_gnn.main(["--train", str(tiny / "train.h5"), "--val", str(tiny / "val.h5"),
                        "--epochs", "2", "--min-epochs", "1", "--batch-size", "4", "--hidden", "16",
                        "--layers", "1", "--topk", "4", "--context", "--use-cost-refinement",
                        "--output", str(tmp_path / "one"), "--device", "cpu"])
    params, meta = _jax_reads(tmp_path / "one", "one_gnn")
    assert meta["context"] is True and "ctx_fc1" in params["params"]
    assert len(meta["history"]["train_loss"]) == 2
    eval_cli.main(["--checkpoint", str(tmp_path / "one"), "--split", str(tiny / "val.h5"),
                   "--limit", "2", "--no-timing", "--device", "cpu"])
    out = tmp_path / "prog"
    train_progressive.main(["--config", str(_progressive_yaml(tmp_path, datasets, out)),
                            "--device", "cpu"])
    for d in ("best", "last"):
        _, meta = _jax_reads(out / d, "one_gnn")
        assert meta["epoch"] == 0 and meta["config"]["model"]["hidden"] == 16


def test_train_dual_gnn_cli_stops_where_jax_stops(datasets, tmp_path, jax_init_by_shape):  # noqa: F811
    """Both CLIs, warm-started from one checkpoint (the port's
    ``build_dual_gnn`` tree at hidden 16, 1 layer, 2 heads), dropout 0, 4
    epochs at most, ``--min-epochs 2 --patience 2`` on the n = 1 validation
    split: the gap is 0 in epoch 0 and never better, so both stop after
    epoch 2.  The histories are equal in length and within 1e-4 relative,
    the metas equal but the history, the best params (epoch 0's) within
    2e-5; JAX reads the port's checkpoint, and ``cli.eval`` serves it."""
    from lapgnn_tpu_torch.cli import eval as eval_cli
    from lapgnn_tpu_torch.train import build_dual_gnn, params_to_flax, save_checkpoint

    init = tmp_path / "init"
    save_checkpoint(init, params_to_flax(build_dual_gnn(16, 1, 2, 0.0, seed=2, device="cpu").state_dict()),
                    {"architecture": "dual_gnn", "hidden": 16, "layers": 1, "heads": 2})
    args = ["--train", str(datasets / "tiny" / "train.h5"), "--val", str(datasets / "one" / "val.h5"),
            "--epochs", "4", "--min-epochs", "2", "--patience", "2", "--batch-size", "2",
            "--hidden", "16", "--layers", "1", "--heads", "2", "--dropout", "0",
            "--init-checkpoint", str(init)]
    j_train_dual.main(args + ["--output", str(tmp_path / "j")])
    train_dual_gnn.main(args + ["--output", str(tmp_path / "t"), "--device", "cpu"])
    jparams, jmeta = _jax_reads(tmp_path / "j", "dual_gnn")
    tparams, tmeta = _jax_reads(tmp_path / "t", "dual_gnn")
    jh, th = jmeta.pop("history"), tmeta.pop("history")
    assert tmeta == jmeta
    assert th["val_gap_median"] == jh["val_gap_median"] == [0.0, 0.0, 0.0]
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"], rtol=1e-4)
    assert len(th["train_loss"]) == 3
    for a, b in zip(jax.tree_util.tree_leaves(tparams), jax.tree_util.tree_leaves(jparams), strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)
    eval_cli.main(["--checkpoint", str(tmp_path / "t"), "--split", str(datasets / "tiny" / "val.h5"),
                   "--limit", "2", "--no-timing", "--device", "cpu"])


def test_cli_parsers_default_to_the_gpu():
    for mod, req in ((train_one_gnn, ["--train", "x", "--output", "y"]),
                     (train_dual_gnn, ["--train", "x", "--output", "y"]),
                     (train_progressive, ["--config", "x"])):
        assert mod.build_parser().parse_args(req).device == "cuda"
