"""The port's data slice against the JAX package's: host dual oracle,
generators, labelled synthetic instances, the trainers' batch samplers,
HDF5 datasets, split planning and the real-instance parsers.  Everything here is numpy and SciPy on both sides, so each
result must be equal, array for array.
"""

from pathlib import Path

import numpy as np
import pytest

from lapgnn_tpu.data import generators as jgen
from lapgnn_tpu.data import h5io as jh5
from lapgnn_tpu.data import synthetic as jsyn
from lapgnn_tpu.ops import host_dual as jhd
from lapgnn_tpu.train import progressive as jprog
from lapgnn_tpu.train import trainer as jtrainer
from lapgnn_tpu_torch.data import generators as tgen
from lapgnn_tpu_torch.data import h5io as th5
from lapgnn_tpu_torch.data import synthetic as tsyn
from lapgnn_tpu_torch.ops import host_dual as thd
from lapgnn_tpu_torch.train import progressive as tprog
from lapgnn_tpu_torch.train import trainer as ttrainer

SEEDED = [
    "generate_uniform_costs",
    "generate_near_diagonal_costs",
    "generate_sparse_costs",
    "generate_metric_costs",
    "generate_clustered_costs",
    "generate_noisy_linear_costs",
    "generate_hard_random_costs",
]


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.asarray(b).dtype
    else:
        assert a == b


@pytest.mark.parametrize("name", SEEDED)
def test_seeded_generators_equal_jax(name):
    for n, seed in ((1, 0), (17, 3), (64, 11)):
        _equal(getattr(tgen, name)(n, seed=seed), getattr(jgen, name)(n, seed=seed))


def test_unseeded_and_planted_generators_equal_jax():
    for n in (1, 9, 40):
        _equal(tgen.generate_worst_case_costs(n), jgen.generate_worst_case_costs(n))
        _equal(tgen.generate_identity_like_costs(n, 0.5, 2.0),
               jgen.generate_identity_like_costs(n, 0.5, 2.0))
        for dtype in (np.float64, np.float32):
            _equal(tgen.generate_planted_optimum_instance(n, seed=n, dtype=dtype),
                   jgen.generate_planted_optimum_instance(n, seed=n, dtype=dtype))
    assert (tgen.SPARSE_FORBIDDEN, tgen.DATASET_SPARSE_FORBIDDEN) == (
        jgen.SPARSE_FORBIDDEN, jgen.DATASET_SPARSE_FORBIDDEN)


@pytest.mark.parametrize("fam", sorted(jgen.FAMILIES))
def test_families_equal_jax(fam):
    assert set(tgen.FAMILIES) == set(jgen.FAMILIES)
    for n, seed in ((1, 0), (23, 5)):
        _equal(tgen.FAMILIES[fam](n, np.random.default_rng(seed)),
               jgen.FAMILIES[fam](n, np.random.default_rng(seed)))


@pytest.mark.parametrize("fam", ["uniform", "tie", "sparse", "metric"])
def test_host_dual_equals_jax(fam):
    C = jgen.FAMILIES[fam](30, np.random.default_rng(7))
    import scipy.optimize

    rows, cols = scipy.optimize.linear_sum_assignment(C)
    _equal(thd.duals_from_matching_np(C, rows, cols), jhd.duals_from_matching_np(C, rows, cols))
    u, v, _ = jhd.duals_from_matching_np(C, rows, cols)
    noisy = (u + 0.3, v + 0.2)
    _equal(thd.project_feasible_np(C, *noisy, max_rounds=3), jhd.project_feasible_np(C, *noisy, max_rounds=3))
    _equal(thd.oracle_duals_np(C, 0.05, 3), jhd.oracle_duals_np(C, 0.05, 3))
    _equal(thd.make_feasible_duals_np(C, noise_std=0.1, rng=np.random.default_rng(2)),
           jhd.make_feasible_duals_np(C, noise_std=0.1, rng=np.random.default_rng(2)))
    _equal(thd.reduce_costs_np(C, u, v), jhd.reduce_costs_np(C, u, v))
    _equal(thd.reduce_costs_np(C, u + 1, v, False), jhd.reduce_costs_np(C, u + 1, v, False))
    _equal(thd.normalize01_np(C), jhd.normalize01_np(C))
    assert thd.check_dual_feasible_np(C, u, v) and thd.check_dual_and_match_np(C, u, v, rows, cols)
    for check in (lambda m: m.check_dual_feasible_np(C, u + 1, v),
                  lambda m: m.check_dual_and_match_np(C, u - 1, v, rows, cols)):
        for mod in (thd, jhd):
            with pytest.raises(AssertionError):
                check(mod)


@pytest.mark.parametrize("fam", sorted(jgen.FAMILIES))
def test_synthetic_instances_equal_jax(fam):
    for kw in ({}, {"dual_noise_prob": 1.0, "noise_std": 0.1}):
        t = tsyn.generate_synthetic_instance(fam, 20, np.random.default_rng(4), **kw)
        j = jsyn.generate_synthetic_instance(fam, 20, np.random.default_rng(4), **kw)
        for field in ("cost", "rows", "cols", "u", "v", "family", "size", "noise_std", "tag"):
            _equal(getattr(t, field), getattr(j, field))
    with pytest.raises(KeyError):
        tsyn.generate_synthetic_instance("nope", 4)


def test_h5_roundtrip_both_ways(tmp_path):
    """JAX writes, the port reads; the port writes, JAX reads; the record of
    an instance equals ``instance_record``."""
    rng = np.random.default_rng(8)
    insts = [jsyn.generate_synthetic_instance(f, n, rng) for f, n in
             (("uniform", 12), ("tie", 7), ("sparse", 20))]
    insts[1].tag = "t1"
    with jh5.H5Writer(tmp_path / "j.h5") as w:
        for inst in insts:
            w.append(inst)
    with th5.H5Writer(tmp_path / "t.h5") as w:
        for inst in insts:
            w.append(inst)
    for writer, reader in (("j", th5.H5Reader), ("t", jh5.H5Reader)):
        with reader(tmp_path / f"{writer}.h5") as r:
            assert len(r) == 3
            np.testing.assert_array_equal(r.sizes(), [12, 7, 20])
            for inst, rec in zip(insts, r.iter()):
                want = tsyn.instance_record(inst)
                assert set(rec) == set(want)
                for k in want:
                    _equal(rec[k], want[k])
    with th5.H5Reader(tmp_path / "j.h5") as a, jh5.H5Reader(tmp_path / "t.h5") as b:
        for i in range(3):
            assert a._f["tag"][i] == b._f["tag"][i] and a._f["noise_std"][i] == b._f["noise_std"][i]


def _records(n_by_size, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n, count in n_by_size:
        for _ in range(count):
            out.append({"cost": rng.uniform(size=(n, n)), "u": rng.normal(size=n),
                        "v": rng.normal(size=n), "n": n})
    return out


def test_bucket_batcher_sequence_equals_jax():
    """Three epochs of the same batcher: equal batches in equal order."""
    insts = _records([(5, 7), (8, 3), (3, 10)])
    tb, jb = ttrainer.BucketBatcher(insts, 4, seed=3), jtrainer.BucketBatcher(insts, 4, seed=3)
    assert tb.num_batches() == jb.num_batches()
    for _ in range(3):
        got, want = list(tb), list(jb)
        assert len(got) == len(want) == jb.num_batches()
        for g, w in zip(got, want):
            _equal(g, w)


def test_round_robin_sampler_sequence_equals_jax():
    """Three epochs of the curriculum sampler (weights, a late dataset, a
    wrapped tail, reshuffle on exhaust): equal (spec, indices) sequences."""
    data = {"a": _records([(4, 40)], 1), "b": _records([(6, 9)], 2), "c": _records([(1100, 1)], 3)}

    def specs(mod):
        return [mod.DatasetSpec("a", 4, data["a"]),
                mod.DatasetSpec("b", 6, data["b"], weight=0.5, curriculum_start_epoch=1),
                mod.DatasetSpec("c", 1100, data["c"], curriculum_start_epoch=2)]

    ts, js = specs(tprog), specs(jprog)
    tsam = tprog.RoundRobinSampler(ts, batches_per_size=3, seed=5)
    jsam = jprog.RoundRobinSampler(js, batches_per_size=3, seed=5)
    for epoch in range(3):
        tsam.set_epoch(epoch)
        jsam.set_epoch(epoch)
        got = [(s.name, idx.tolist()) for s, idx in tsam.iter_indices()]
        want = [(s.name, idx.tolist()) for s, idx in jsam.iter_indices()]
        assert got == want and len(got) > 0
    assert [tprog.default_batch_size(n) for n in (1, 1024, 1025, 2048, 4096, 4097)] == [
        jprog.default_batch_size(n) for n in (1, 1024, 1025, 2048, 4096, 4097)]
    spec = ts[1]
    _equal(tprog.RoundRobinSampler.materialize(spec, np.array([2, 0])),
           jprog.RoundRobinSampler.materialize(js[1], np.array([2, 0])))


# ---------------------------------------------------------------- splits and real instances

REAL = sorted((Path(__file__).resolve().parent.parent / "data" / "real").iterdir())


@pytest.mark.parametrize("count,ratios", [
    (0, (0.8, 0.1, 0.1)), (1, (0.8, 0.1, 0.1)), (10, (0.8, 0.1, 0.1)), (7, (0.6, 0.4, 0.0)),
    (33, (1.0, 2.0, 3.0)), (5, (0.0, 0.0, 1.0)),
])
def test_plan_bucket_equals_jax(count, ratios):
    """The labels and what is left of the numpy Generator are equal."""
    from lapgnn_tpu.data.splits import plan_bucket as jplan
    from lapgnn_tpu_torch.data.splits import plan_bucket as tplan

    r = dict(zip(("train", "val", "test"), ratios))
    jr, tr = np.random.default_rng(count), np.random.default_rng(count)
    assert tplan(count, r, tr) == jplan(count, r, jr)
    assert tr.random() == jr.random()


def test_plan_bucket_rejects_zero_ratios_and_bucket_assignments_equal_jax():
    from lapgnn_tpu.data.splits import iter_bucket_assignments as jiter
    from lapgnn_tpu_torch.data.splits import iter_bucket_assignments, plan_bucket

    with pytest.raises(ValueError):
        plan_bucket(3, {"train": 0.0}, np.random.default_rng(0))
    counts = [("uniform_64", 9), ("tie_128", 4), ("sparse_64", 0)]
    ratios = {"train": 0.7, "val": 0.2, "test": 0.1}
    assert list(iter_bucket_assignments(counts, ratios, seed=3)) == list(jiter(counts, ratios, seed=3))


@pytest.mark.parametrize("path", REAL, ids=lambda p: p.name)
def test_real_parsers_equal_jax(path):
    """Each file of ``data/real`` through the parser its name selects, on
    both packages: name, source and cost matrix equal (float64); then
    ``normalize_cost_matrix`` of it, and the STRING parser's node cap."""
    from lapgnn_tpu.data import processors as jp
    from lapgnn_tpu_torch.data import processors as tp

    (want,) = list(jp.iter_real_instances([path]))
    (got,) = list(tp.iter_real_instances([path]))
    assert isinstance(got, tp.RealInstance)
    assert (got.name, got.source) == (want.name, want.source)
    _equal(got.cost, want.cost)
    _equal(tp.normalize_cost_matrix(got.cost), jp.normalize_cost_matrix(want.cost))
    if got.source == "string":
        _equal(tp.string_links_to_cost(path, max_nodes=7).cost,
               jp.string_links_to_cost(path, max_nodes=7).cost)


def test_real_parsers_reject_bad_files_and_fetch_is_gated(tmp_path, monkeypatch):
    """Truncated, empty and non-integer ``.assign`` files raise ValueError as
    JAX's do; an unknown file is skipped with a warning; a constant matrix
    normalises to zeros; ``fetch_suitesparse`` raises without the opt-in."""
    from lapgnn_tpu_torch.data import processors as tp

    for text in ("3\n1 2 3\n", "", "x 1 2", "-1"):
        f = tmp_path / "bad.assign"
        f.write_text(text)
        with pytest.raises(ValueError):
            tp.parse_orlib_assign(f)
    other = tmp_path / "notes.txt"
    other.write_text("hello")
    with pytest.warns(UserWarning):
        assert list(tp.iter_real_instances([other])) == []
    assert not tp.normalize_cost_matrix(np.full((3, 3), 2.0)).any()
    monkeypatch.delenv("LAPGNN_ALLOW_FETCH", raising=False)
    with pytest.raises(RuntimeError, match="LAPGNN_ALLOW_FETCH"):
        tp.fetch_suitesparse("bcsstk01")
