"""The port's device sketch, metric partials and per-rank split loading
(``xgboost_tpu_torch/parallel/sketch_device.py``, ``metrics.py``,
``parallel/sharded.py``) against the JAX package, on the CPU.

Rank processes (gloo, spawned by the port's launcher) run this file as a
script (``worker``), which imports the port and numpy only; one job per
world size, W = 1, 2 and 4, runs at once.  The JAX references run in the
pytest process on the conftest's 8-device CPU mesh.

Tolerances: none.  With unit weights every rank of the sketch is an
exact f32 integer, so the cuts are byte-equal to the JAX package's
``sketch_cuts_mesh`` at the same W (and equal on every rank); the metric
partials and the exact AUC are host numpy in f64, bitwise the JAX
functions; a split-loaded model is byte-equal to a replicated-load one
over the same world (both sketch on the device).
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_BIN = 32
SPLIT = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.5,
         "max_bin": MAX_BIN, "hist_precision": "fixed", "dsplit": "row",
         "silent": 1}


def sketch_data():
    rng = np.random.RandomState(0)
    X = rng.randn(1003, 5).astype(np.float32)
    X[rng.rand(1003, 5) < 0.1] = np.nan
    X[:, 3] = np.round(X[:, 3] * 3)       # few distinct values: dense cuts
    return X


def svm_data():
    rng = np.random.RandomState(4)
    X = np.round(rng.randn(611, 6), 3).astype(np.float32)
    X[rng.rand(611, 6) < 0.2] = 0.0       # left out of the text: missing
    y = (X[:, 0] - X[:, 2] > 0).astype(np.float32)
    return X, y


def write_svm(path, X, y):
    with open(path, "w") as f:
        for row, lab in zip(X, y):
            feats = " ".join(f"{j}:{v:g}" for j, v in enumerate(row) if v)
            f.write(f"{lab:g} {feats}\n")


# ------------------------------------------------------------ rank worker

def worker_main(out_dir: str, svm: str) -> None:
    import torch
    torch.set_num_threads(1)
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.parallel.launch import init_worker
    from xgboost_tpu_torch.parallel.mesh import data_parallel_mesh
    from xgboost_tpu_torch.parallel.sharded import ShardedDMatrix
    from xgboost_tpu_torch.parallel.sketch_device import sketch_cuts_mesh
    init_worker("cpu")
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    arrs, texts = {}, {}
    X = sketch_data()
    cuts = sketch_cuts_mesh(data_parallel_mesh(), X, None, MAX_BIN)
    arrs["sketch_values"], arrs["sketch_n"] = cuts.cut_values, cuts.n_cuts
    # the learner's choice: dsplit=row and device_sketch=1
    bst = xt.train({**SPLIT, "device_sketch": 1},
                   xt.DMatrix(np.nan_to_num(X[:, :4], nan=0.0),
                              label=(X[:, 0] > 0).astype(np.float32)), 1,
                   device="cpu")
    arrs["learner_cuts"] = bst.gbtree.cuts.cut_values
    # split loading against a replicated load of the same text
    ds = ShardedDMatrix(svm)
    arrs["shard_rows"] = np.asarray([ds.row_start, ds.row_end,
                                     ds.num_row, ds.num_col])
    arrs["shard_label"] = ds.get_label()
    for name, d in (("split", ds), ("replicated", xt.DMatrix(svm))):
        res = {}
        b = xt.train({**SPLIT, "device_sketch": 1,
                      "eval_metric": ["error", "logloss", "auc"]}, d, 3,
                     evals=[(d, "train")], evals_result=res,
                     verbose_eval=False, device="cpu")
        arrs[name] = np.frombuffer(b.save_raw(), np.uint8)
        texts[name] = res
        arrs[name + "_pred"] = b.predict(d)
    res = {}
    xt.train({**SPLIT, "device_sketch": 1, "eval_metric": ["auc"],
              "dist_auc": "approx"}, ds, 1, evals=[(ds, "train")],
             evals_result=res, verbose_eval=False, device="cpu")
    texts["auc_approx"] = res["train-auc"]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrs)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(texts, f)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.path.insert(0, REPO)
    worker_main(sys.argv[2], sys.argv[3])
    sys.exit(0)


# ------------------------------------------------------------------ tests

import pytest  # noqa: E402

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

from xgboost_tpu import metrics as jm  # noqa: E402
from xgboost_tpu.parallel.mesh import data_parallel_mesh  # noqa: E402
from xgboost_tpu.parallel.sketch_device import sketch_cuts_mesh  # noqa: E402
from xgboost_tpu_torch import metrics as tm  # noqa: E402

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("sketch")
    svm = str(root / "train.svm")
    write_svm(svm, *svm_data())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    jobs = {}
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"s{world}"))
        jobs[world] = (d, subprocess.Popen(
            [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch",
             "-n", str(world), "--timeout-sec", "240", sys.executable,
             os.path.abspath(__file__), "worker", d, svm],
            env=env, cwd=d))
    out = {}
    for world, (d, proc) in jobs.items():
        rc = proc.wait(timeout=300)
        assert rc == 0, f"world {world}: launcher rc {rc}"
        out[world] = []
        for r in range(world):
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                arrs = {k: z[k] for k in z.files}
            with open(os.path.join(d, f"rank{r}.json")) as f:
                out[world].append((arrs, json.load(f)))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_device_sketch_cuts_match_jax_mesh(worlds, world):
    want = sketch_cuts_mesh(data_parallel_mesh(world), sketch_data(), None,
                            MAX_BIN)
    for arrs, _ in worlds[world]:
        np.testing.assert_array_equal(arrs["sketch_values"], want.cut_values)
        np.testing.assert_array_equal(arrs["sketch_n"], want.n_cuts)


@pytest.mark.parametrize("world", WORLDS)
def test_learner_cuts_equal_on_every_rank(worlds, world):
    """``device_sketch=1`` in the learner: every rank's model holds the
    same cuts as rank 0's."""
    ranks = worlds[world]
    for arrs, _ in ranks[1:]:
        np.testing.assert_array_equal(arrs["learner_cuts"],
                                      ranks[0][0]["learner_cuts"])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_dmatrix_blocks(worlds, world):
    """Each rank parses its block of the padded rows, the JAX mesh's
    block of device r; the blocks tile the file and the feature count is
    the ranks' maximum."""
    X, y = svm_data()
    n = len(y)
    m = -(-n // world)
    got = []
    for r, (arrs, _) in enumerate(worlds[world]):
        start, end, num_row, num_col = arrs["shard_rows"]
        assert (start, end) == (min(r * m, n), min((r + 1) * m, n))
        assert (num_row, num_col) == (n, 6)
        got.append(arrs["shard_label"])
    np.testing.assert_array_equal(np.concatenate(got), y)


@pytest.mark.parametrize("world", WORLDS)
def test_split_loaded_model_equals_replicated_load(worlds, world):
    """A split-loaded model is byte-equal to a replicated-load one over
    the same world; its eval (metric partials summed over the ranks, the
    exact AUC from every rank's value runs) prints the same values."""
    for arrs, texts in worlds[world]:
        assert arrs["split"].tobytes() == arrs["replicated"].tobytes()
        assert texts["split"] == texts["replicated"]
    # every rank returns its own rows' predictions, which tile the rows
    preds = np.concatenate([a["split_pred"] for a, _ in worlds[world]])
    np.testing.assert_array_equal(preds, worlds[world][0][0][
        "replicated_pred"])
    # the models of every world size agree on the whole data's eval
    assert worlds[world][0][1]["split"]["train-auc"][-1] == pytest.approx(
        worlds[1][0][1]["split"]["train-auc"][-1], abs=0.05)


def test_approx_auc_is_the_mean_of_the_ranks(worlds):
    """``dist_auc=approx``: the mean of the ranks' AUCs (the reference's
    approximation), the exact one in a world of one."""
    one = worlds[1][0][1]
    assert one["auc_approx"] == one["split"]["train-auc"][:1]
    assert all(t["auc_approx"] == worlds[2][0][1]["auc_approx"]
               for _, t in worlds[2])


def _metric_inputs(K=1, seed=0, n=333):
    rng = np.random.RandomState(seed)
    if K > 1:
        p = rng.dirichlet(np.ones(K), n).astype(np.float32)
        y = rng.randint(0, K, n).astype(np.float32)
    else:
        p = rng.rand(n).astype(np.float32)
        p[::7] = p[3]                      # ties
        y = (rng.rand(n) < 0.4).astype(np.float32)
    return p, y, rng.rand(n).astype(np.float32) + 0.5


@pytest.mark.parametrize("name", ["rmse", "logloss", "error", "merror",
                                  "mlogloss", "auc"])
def test_metric_partials_match_jax(name):
    K = 3 if name.startswith("m") and name != "rmse" else 1
    p, y, w = _metric_inputs(K)
    mt, mj = tm.create_metric(name), jm.create_metric(name)
    for lo, hi in ((0, 150), (150, 333)):
        a = mt.partial_fn(p[lo:hi], y[lo:hi], w[lo:hi], None)
        b = mj.partial_fn(p[lo:hi], y[lo:hi], w[lo:hi], None)
        np.testing.assert_array_equal(a, b)
    s = (mt.partial_fn(p[:150], y[:150], w[:150], None)
         + mt.partial_fn(p[150:], y[150:], w[150:], None))
    assert mt.finalize_fn(s) == mj.finalize_fn(s)


def test_exact_auc_from_runs_matches_jax():
    p, y, w = _metric_inputs()
    parts = [(0, 100), (100, 260), (260, 333)]
    rt = np.concatenate([tm.auc_compress(p[a:b], y[a:b], w[a:b])
                         for a, b in parts])
    rj = np.concatenate([jm.auc_compress(p[a:b], y[a:b], w[a:b])
                         for a, b in parts])
    np.testing.assert_array_equal(rt, rj)
    assert tm.auc_exact_from_runs(rt) == jm.auc_exact_from_runs(rj)
    assert tm.auc_exact_from_runs(rt) == pytest.approx(tm.auc(p, y, w),
                                                       abs=1e-12)
    assert set(tm._DIST_METRICS) == set(jm._DIST_METRICS)


def test_world_of_one_sketch_in_process():
    """Without a process group the device sketch is a world of one: the
    cuts of the JAX mesh of one device, bitwise."""
    from xgboost_tpu_torch.parallel.mesh import DataMesh
    from xgboost_tpu_torch.parallel import sketch_device as tsd
    X = sketch_data()
    got = tsd.sketch_cuts_mesh(DataMesh(0, 1, "cpu"), X, None, MAX_BIN)
    want = sketch_cuts_mesh(data_parallel_mesh(1), X, None, MAX_BIN)
    np.testing.assert_array_equal(got.cut_values, want.cut_values)


def test_summary_fold_is_rank_ordered_and_matches_merge():
    """Folding four summaries pairwise equals ((0+1) + (2+3)) merged by
    hand, and local summaries of the same rows equal the JAX ones."""
    import jax.numpy as jnp
    import torch
    from xgboost_tpu.parallel import sketch_device as jsd
    from xgboost_tpu_torch.parallel import sketch_device as tsd
    X = np.nan_to_num(sketch_data(), nan=np.inf)
    K = tsd.sketch_size(MAX_BIN, 0.03, 2.0)
    w = np.ones(250, np.float32)
    parts = [tsd.local_summary(torch.from_numpy(
        np.ascontiguousarray(X[i * 250:(i + 1) * 250].T)),
        torch.from_numpy(w), K) for i in range(4)]
    jparts = [jax.vmap(lambda c: jsd.local_summary(c, jnp.asarray(w), K),
                       in_axes=1)(jnp.asarray(X[i * 250:(i + 1) * 250]))
              for i in range(4)]
    for a, b in zip(parts, jparts):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    fold = tsd.fold_summaries(parts, K)
    by_hand = tsd.merge_summaries_dev(
        tsd.merge_summaries_dev(parts[0], parts[1], K),
        tsd.merge_summaries_dev(parts[2], parts[3], K), K)
    for x, y in zip(fold, by_hand):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
