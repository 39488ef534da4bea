"""Column-split distributed training of the port (``dsplit=col``,
``xgboost_tpu_torch/parallel/colsplit.py``) against the JAX package's
column mesh, on the CPU.

Rank processes are spawned by the port's launcher (``python -m
xgboost_tpu_torch.parallel.launch``) and talk over gloo; they run this
file as a script (``worker``), which imports the port and numpy only.
One job per world size (W = 1, 2, 4) runs every scenario, the three at
once, while the JAX references run in the pytest process on the
conftest's 8-device CPU mesh (``set_mesh(feature_parallel_mesh(W))``).

Every rank holds all rows and its block of the features.  Tolerances:
none.  At ``hist_precision=fixed`` (and in exact mode) model bytes and
eval lines are byte-equal to the JAX package's column mesh of W devices
and the same on every rank: the histogram of a feature is the same
wherever it is built, the node totals are rank 0's (every feature's bin
sums agree exactly in "fixed"), and the merged argmax breaks ties to the
lowest feature.  Across W, predictions, leaves, eval lines, dumps and
every tree field are byte-equal, except what a leaf records of its
rejected best candidate (``cut_index`` and ``threshold`` where
``feature < 0``): an invalid split competes at -1e30 in the merge, so a
node with no valid split keeps rank 0's candidate, as on the JAX column
mesh (its own test, ``tests/test_distributed.py:193``, compares
``cut_index`` at split nodes only and allows rtol 2e-4 against one
device; its column mesh and the port agree to the byte).
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXED = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.5,
         "hist_precision": "fixed", "dsplit": "col", "silent": 1}
EXACT = {"objective": "binary:logistic", "max_depth": 4, "eta": 0.5,
         "updater": "grow_colmaker,prune", "dsplit": "col", "silent": 1}
# scenario -> (params over FIXED, data seed, rows, features, rounds)
SCENARIOS = {
    "pad13": ({"max_depth": 3}, 3, 1024, 13, 3),
    "gamma": ({"gamma": 0.3}, 4, 1024, 10, 2),
    "colsample": ({"colsample_bytree": 0.6, "colsample_bylevel": 0.8},
                  0, 2048, 10, 3),
    "distcol": ({"updater": "distcol"}, 0, 2048, 10, 2),
    "multiclass": ({"objective": "multi:softmax", "num_class": 3,
                    "max_depth": 3}, 5, 1024, 10, 2),
    "refresh": ({"max_depth": 3}, 6, 1024, 10, 2),
}
EXACT_N = 50_000


def make_data(n=2048, f=10, seed=0):
    """The JAX column-split tests' data (``tests/test_distributed.py``)."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, f).astype(np.float32)
    y = ((X[:, 0] > 0.5) ^ (X[:, 1] > 0.3) |
         (X[:, 2] > 0.9)).astype(np.float32)
    return X, y


def scenario_data(name):
    params, seed, n, f, rounds = SCENARIOS[name]
    X, y = make_data(n, f, seed)
    if name == "multiclass":
        y = (X[:, 0] * 3).astype(np.int32).astype(np.float32)
    return {**FIXED, **params}, X, y, rounds


def exact_data(nan_frac):
    """``tests/test_distributed.py:424-465``'s exact column-split data."""
    rng = np.random.RandomState(5)
    X = rng.randn(EXACT_N, 5).astype(np.float32)
    if nan_frac:
        X[rng.rand(EXACT_N, 5) < nan_frac] = np.nan
    y = ((np.nan_to_num(X[:, 0]) > 0.3)
         ^ (np.nan_to_num(X[:, 1]) < -0.2)).astype(np.float32)
    return X, y


# ------------------------------------------------------------ rank worker

def worker_scenarios(xt):
    """Every scenario a rank runs: ``{name: array}`` and ``{name: text}``."""
    arrs, texts = {}, {}
    X, y = make_data()
    Xe, ye = make_data(500, seed=7)
    d, de = xt.DMatrix(X, label=y), xt.DMatrix(Xe, label=ye)
    bst = xt.Booster(FIXED, cache=[d, de], device="cpu")
    lines = []
    bst.update_many(d, 0, 4, evals=[(d, "train"), (de, "eval")],
                    eval_callback=lambda i, m: lines.append(m))
    arrs["fixed"] = np.frombuffer(bst.save_raw(), np.uint8)
    texts["fixed"] = lines
    arrs["fixed_pred"] = bst.predict(de)
    arrs["fixed_margin"] = bst.predict(d, output_margin=True)
    arrs["fixed_leaf"] = bst.predict(d, pred_leaf=True)
    arrs["fixed_limit"] = bst.predict(de, ntree_limit=2)
    arrs["fixed_oneoff"] = bst.predict(Xe)
    col = bst._col
    arrs["blocks"] = np.array([bst._entry(d).binned.shape[1], col.f_local,
                               col.lo, col.f_pad])
    from xgboost_tpu_torch.obs import comm
    tot = comm.totals()
    arrs["comm"] = np.asarray([[tot[op][k] for k in ("count", "bytes")]
                               for op in comm.OPS])
    for name in SCENARIOS:
        params, X, y, rounds = scenario_data(name)
        d = xt.DMatrix(X, label=y)
        lines = []
        if name == "refresh":
            bst = xt.train(params, d, rounds, device="cpu")
            bst.set_param({"updater": "refresh"})
            d2 = xt.DMatrix(X, label=(X[:, 3] > 0.4).astype(np.float32))
            bst.update(d2, rounds)
            lines.append(bst.eval_set([(d2, "train")], rounds))
        else:
            bst = xt.Booster(params, cache=[d], device="cpu")
            bst.update_many(d, 0, rounds, evals=[(d, "train")],
                            eval_callback=lambda i, m: lines.append(m))
        arrs[name] = np.frombuffer(bst.save_raw(), np.uint8)
        texts[name] = lines
    for tag, frac in (("exact_dense", 0.0), ("exact_nan", 0.08)):
        X, y = exact_data(frac)
        d = xt.DMatrix(X, label=y)
        bst = xt.train(EXACT, d, 2, device="cpu")
        assert bst.gbtree.exact_raw
        texts[tag] = bst.get_dump()
        arrs[tag] = bst.predict(d)
        arrs[tag + "_X"] = np.array(bst._entry(d).binned.shape)
    return arrs, texts


def worker_main(out_dir: str) -> None:
    import torch
    torch.set_num_threads(1)
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.parallel.launch import init_worker
    init_worker("cpu")
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    arrs, texts = worker_scenarios(xt)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrs)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(texts, f)
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.path.insert(0, REPO)
    worker_main(sys.argv[2])
    sys.exit(0)


# ------------------------------------------------------------------ tests

import pytest  # noqa: E402

jax = pytest.importorskip("jax")
pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu.parallel.colsplit import feature_parallel_mesh  # noqa: E402
from xgboost_tpu.parallel.mesh import set_mesh  # noqa: E402

WORLDS = (1, 2, 4)
# scenario -> the column mesh its JAX reference runs on
JAX_WORLD = {"pad13": 4, "gamma": 2, "colsample": 4, "distcol": 2,
             "multiclass": 2, "refresh": 2}


def jax_run(world, fn):
    set_mesh(feature_parallel_mesh(world))
    try:
        return fn()
    finally:
        set_mesh(None)


def jax_fixed():
    X, y = make_data()
    Xe, ye = make_data(500, seed=7)
    d, de = xj.DMatrix(X, label=y), xj.DMatrix(Xe, label=ye)
    bst = xj.Booster(FIXED, cache=[d, de])
    lines = []
    bst.update_many(d, 0, 4, evals=[(d, "train"), (de, "eval")],
                    eval_callback=lambda i, m: lines.append(m))
    return {"raw": bytes(bst.save_raw()), "lines": lines,
            "pred": np.asarray(bst.predict(de)),
            "margin": np.asarray(bst.predict(d, output_margin=True))}


def jax_scenario(name):
    params, X, y, rounds = scenario_data(name)
    d = xj.DMatrix(X, label=y)
    lines = []
    if name == "refresh":
        bst = xj.train(params, d, rounds, verbose_eval=False)
        bst.set_param({"updater": "refresh"})
        d2 = xj.DMatrix(X, label=(X[:, 3] > 0.4).astype(np.float32))
        bst.update(d2, rounds)
        lines.append(bst.eval_set([(d2, "train")], rounds))
    else:
        bst = xj.Booster(params, cache=[d])
        bst.update_many(d, 0, rounds, evals=[(d, "train")],
                        eval_callback=lambda i, m: lines.append(m))
    return {"raw": bytes(bst.save_raw()), "lines": lines}


def jax_exact(frac):
    X, y = exact_data(frac)
    d = xj.DMatrix(X, label=y)
    bst = xj.train(EXACT, d, 2, verbose_eval=False)
    return {"dump": bst.get_dump(), "pred": np.asarray(bst.predict(d))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(port: {W: [per-rank (arrays, texts)]}, jax: {key: result}): the
    three worlds run while the JAX references are computed."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    jobs = {}
    for world in WORLDS:
        d = str(tmp_path_factory.mktemp(f"col{world}"))
        jobs[world] = (d, subprocess.Popen(
            [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch", "-n",
             str(world), "--timeout-sec", "300", sys.executable,
             os.path.abspath(__file__), "worker", d], env=env, cwd=d))
    ref = {("fixed", w): jax_run(w, jax_fixed) for w in WORLDS}
    for name, w in JAX_WORLD.items():
        ref[(name, w)] = jax_run(w, lambda: jax_scenario(name))
    for tag, frac in (("exact_dense", 0.0), ("exact_nan", 0.08)):
        ref[(tag, 2)] = jax_run(2, lambda: jax_exact(frac))
    port = {}
    for world, (d, proc) in jobs.items():
        rc = proc.wait(timeout=360)
        assert rc == 0, f"world {world}: launcher rc {rc}"
        port[world] = []
        for r in range(world):
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                arrs = {k: z[k] for k in z.files}
            with open(os.path.join(d, f"rank{r}.json")) as f:
                port[world].append((arrs, json.load(f)))
    return port, ref


@pytest.mark.parametrize("world", WORLDS)
def test_fixed_matches_the_jax_column_mesh(run, world):
    """2,048 x 10 at W = 1, 2, 4: model bytes and eval lines byte-equal
    to the JAX column mesh of W devices, predictions (a cached eval
    matrix, through the ranks' routing) equal to its."""
    port, ref = run
    arrs, texts = port[world][0]
    want = ref[("fixed", world)]
    assert arrs["fixed"].tobytes() == want["raw"]
    assert texts["fixed"] == want["lines"]
    np.testing.assert_array_equal(arrs["fixed_pred"], want["pred"])
    np.testing.assert_array_equal(arrs["fixed_margin"], want["margin"])


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_holds_the_same_model(run, world):
    """Every rank saves, predicts and prints the same bytes."""
    port, _ = run
    first = port[world][0]
    for arrs, texts in port[world][1:]:
        for k, v in first[0].items():
            if k not in ("blocks", "comm"):
                np.testing.assert_array_equal(arrs[k], v, err_msg=k)
        assert texts == first[1]


def _assert_same_trees(raw, want):
    """Every tree field bitwise, a leaf's rejected candidate aside."""
    a, b = xt.Booster(device="cpu"), xt.Booster(device="cpu")
    a.load_raw(raw)
    b.load_raw(want)
    sa, sb = a.gbtree.get_state(), b.gbtree.get_state()
    split = sb["tree_feature"] >= 0
    for k, v in sb.items():
        if k in ("tree_cut_index", "tree_threshold"):
            np.testing.assert_array_equal(sa[k][split], v[split], err_msg=k)
        else:
            np.testing.assert_array_equal(sa[k], v, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_every_scenario_equals_world_one(run, world):
    """Trees, eval lines, predictions, leaves and exact dumps at W ranks
    byte-equal to the world of one's."""
    port, _ = run
    one_a, one_t = port[1][0]
    arrs, texts = port[world][0]
    for k, v in one_a.items():
        if k in ["fixed", *SCENARIOS]:
            _assert_same_trees(arrs[k].tobytes(), v.tobytes())
        elif k not in ("blocks", "comm") and not k.endswith("_X"):
            np.testing.assert_array_equal(arrs[k], v, err_msg=k)
    assert texts == one_t


@pytest.mark.parametrize("name", list(JAX_WORLD))
def test_scenario_matches_the_jax_column_mesh(run, name):
    """F = 13 at W = 4 (padding features), ``gamma`` with prune,
    ``colsample_bytree`` 0.6 and ``colsample_bylevel`` 0.8, ``updater=
    distcol``, a 3-class softmax (one tree at a time) and ``refresh`` on
    new labels: model bytes and eval lines byte-equal."""
    port, ref = run
    w = JAX_WORLD[name]
    arrs, texts = port[w][0]
    assert arrs[name].tobytes() == ref[(name, w)]["raw"]
    assert texts[name] == ref[(name, w)]["lines"]


@pytest.mark.parametrize("tag", ["exact_dense", "exact_nan"])
def test_exact_column_split_matches_jax(run, tag):
    """Exact ``grow_colmaker,prune`` on 50,000 x 5 (8% missing or none)
    at W = 2: each rank scans its own raw columns; dumps and predictions
    equal to the JAX column mesh's (``tests/test_distributed.py:424``)."""
    port, ref = run
    arrs, texts = port[2][0]
    assert texts[tag] == ref[(tag, 2)]["dump"]
    np.testing.assert_array_equal(arrs[tag], ref[(tag, 2)]["pred"])


def test_each_rank_uploads_its_own_columns(run):
    """A rank's cached matrix holds its block of the padded features:
    10 features at W = 4 pad to 12, three a rank; exact mode's 5 pad to
    8, two a rank."""
    port, _ = run
    for world in WORLDS:
        for r, (arrs, _) in enumerate(port[world]):
            f_pad = 10 + (-10) % world
            assert arrs["blocks"].tolist() == [
                f_pad // world, f_pad // world, r * f_pad // world, f_pad]
            assert arrs["exact_dense_X"].tolist() == [
                EXACT_N, (5 + (-5) % world) // world]


def test_collectives_are_counted(run):
    """A world of one makes no collective call.  At W > 1 every level
    gathers the ranks' best splits (allgather), takes rank 0's node
    totals (broadcast) and sums the packed go-left bits, a byte per
    eight rows (allreduce)."""
    port, _ = run
    assert not port[1][0][0]["comm"][:, 0].any()
    for world in (2, 4):
        (ar_n, ar_b), (ag_n, ag_b), (bc_n, bc_b) = port[world][0][0]["comm"]
        # 4 rounds of 4 levels with splits (the eval sets' margins route
        # through the ranks too)
        assert ag_n >= 16 and bc_n >= 16 and ar_n >= 16
        # the packed bits: at most 2,048 / 8 bytes a training level
        assert ar_b / ar_n <= 2048 / 8


def _cpu_col(params=None):
    return {**FIXED, **(params or {})}


def test_skmaker_under_column_split_raises():
    X, y = make_data(256)
    with pytest.raises(NotImplementedError, match="grow_skmaker"):
        xt.train(_cpu_col({"updater": "grow_skmaker"}),
                 xt.DMatrix(X, label=y), 1, device="cpu")


def test_root_index_under_column_split_raises():
    X, y = make_data(256)
    d = xt.DMatrix(X, label=y)
    d.set_uint_info("root_index", np.arange(256) % 2)
    with pytest.raises(NotImplementedError, match="dsplit != col"):
        xt.train(_cpu_col({"num_roots": 2}), d, 1, device="cpu")


def test_external_matrix_under_column_split_raises(tmp_path):
    from xgboost_tpu_torch.external import ExtMemDMatrix
    X, y = make_data(256)
    d = ExtMemDMatrix(iter([(X, y)]), page_rows=128,
                      cache=str(tmp_path / "m"))
    with pytest.raises(NotImplementedError, match="dsplit=col"):
        xt.train(_cpu_col(), d, 1, device="cpu")


def test_split_loaded_matrix_under_column_split_raises(tmp_path):
    from xgboost_tpu_torch.parallel.sharded import ShardedDMatrix
    X, y = make_data(64, 4)
    path = tmp_path / "t.svm"
    path.write_text("".join(
        f"{int(y[i])} " + " ".join(f"{j}:{X[i, j]:.6f}" for j in range(4))
        + "\n" for i in range(64)))
    with pytest.raises(NotImplementedError, match="dsplit=col"):
        xt.train(_cpu_col(), ShardedDMatrix(str(path)), 1, device="cpu")
