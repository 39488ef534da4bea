"""Row-split distributed training of the port (``dsplit=row`` over a
``torch.distributed`` world, ``xgboost_tpu_torch/parallel/``) against
the JAX package's data-parallel mesh, on the CPU.

Rank processes are spawned by the port's own launcher
(``python -m xgboost_tpu_torch.parallel.launch``) and talk over gloo;
they run this file as a script (``worker``), which imports the port and
numpy only.  One job per world size runs every scenario and writes its
results, so the spawns stay few.  The JAX references run in the pytest
process on the conftest's 8-device CPU mesh (``set_mesh``).

Tolerances and why:

- ``hist_precision=fixed``: model bytes, eval lines, predictions and
  leaves byte-equal across W = 1, 2, 3 (no padding at 501 rows) and 4,
  and byte-equal to the JAX package's ``update_many`` on a mesh of W
  (integer sums are associative; every rank takes its split decisions
  on the same reduced tensor);
- fp32: the tree structure equal to the JAX mesh run's, leaf values
  within rtol 1e-5 (float partial sums added in another order);
- int8 (the plain version on the CPU): byte-equal at W = 2 to W = 1 (one
  int8 scale over all ranks' rows);
- subtraction with the full-build fallback, paged growth, ``boost``:
  W = 2 byte-equal to W = 1 in "fixed"; ``refresh`` (float K2 sums)
  keeps the structure bitwise and its statistics within rtol 1e-5
  (gains 1e-4); gblinear weights within rtol 1e-5 of W = 1 and of the
  JAX mesh (float row sums in another order);
- every rank of a world saves the same bytes.
"""

import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F = 501, 6
FIXED = {"objective": "binary:logistic", "max_depth": 3, "eta": 0.4,
         "max_bin": 16, "hist_precision": "fixed", "dsplit": "row",
         "silent": 1, "device_sketch": 0}


def make_data(n=N, f=F, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return X, y


def multiclass_data():
    rng = np.random.RandomState(1)
    X = rng.randn(N, F).astype(np.float32)
    y = np.argmax(X[:, :3] + 0.2 * rng.randn(N, 3), axis=1).astype(
        np.float32)
    return X, y


def base_margin():
    return np.random.RandomState(5).randn(N).astype(np.float32) * 0.3


def logistic_obj(preds, dmat):
    """A custom objective: binary:logistic's gradient in numpy."""
    y = dmat.get_label()
    return (preds - y).astype(np.float32), \
        (preds * (1.0 - preds)).astype(np.float32)


RANK_GROUPS = [50] * 10 + [1]      # 501 rows; a group of one row last


def rank_data():
    """Graded relevance 0-3 in 11 query groups; ndcg gets a base margin
    so that no two predictions of a group tie (the port's sort path
    orders tied rows by row id, the JAX package's sort otherwise:
    ROADMAP.md section 3)."""
    rng = np.random.RandomState(3)
    X = rng.randn(N, F).astype(np.float32)
    rel = np.clip(np.round(X[:, 0] + 0.5 * rng.randn(N)), 0, 3).astype(
        np.float32)
    return X, rel, np.random.RandomState(9).randn(N).astype(np.float32)


def rank_dmatrix(pkg, objective):
    X, rel, margin = rank_data()
    d = pkg.DMatrix(X, label=rel, group=RANK_GROUPS)
    if objective == "rank:ndcg":
        d.set_base_margin(margin)
    return d


RANK = {"max_depth": 3, "eta": 0.4, "max_bin": 16, "hist_precision": "fixed",
        "dsplit": "row", "silent": 1, "device_sketch": 0}


def skewed_data():
    """2,048 rows sorted by the first feature, the label its sign: the
    first split sends one rank's block of 1,024 rows whole into one
    child, more rows than that rank's buffer of half its rows (512)."""
    X, _ = make_data(2048, F, seed=3)
    X = X[np.argsort(X[:, 0], kind="stable")]
    return X, (X[:, 0] > 0).astype(np.float32)


# ------------------------------------------------------------ rank worker

def _train(xt, params, d, rounds, evals=(), **kw):
    bst = xt.Booster(params, cache=[d] + [e for e, _ in evals], device="cpu")
    lines = []
    bst.update_many(d, 0, rounds, evals=list(evals) or None,
                    eval_callback=lambda i, m: lines.append(m), **kw)
    return bst, lines


def _raw(bst):
    return np.frombuffer(bst.save_raw(), np.uint8)


def worker_scenarios(xt, world: int, full: bool):
    """Every scenario a rank runs: ``{name: array}`` and ``{name: text}``."""
    arrs, texts = {}, {}
    X, y = make_data()
    Xe, ye = make_data(203, seed=7)
    d, de = xt.DMatrix(X, label=y), xt.DMatrix(Xe, label=ye)
    bst, lines = _train(xt, FIXED, d, 5, [(d, "train"), (de, "eval")])
    arrs["fixed"] = _raw(bst)
    texts["fixed"] = lines
    arrs["fixed_pred"] = bst.predict(de)
    arrs["fixed_margin"] = bst.predict(d, output_margin=True)
    arrs["fixed_leaf"] = bst.predict(d, pred_leaf=True)
    from xgboost_tpu_torch.obs import comm
    tot = comm.totals()
    arrs["comm_counts"] = np.asarray([tot[op]["count"] for op in comm.OPS])
    arrs["comm_families"] = np.asarray(
        [f"xgbtpu_comm_{op}_bytes_total" in comm.metrics().render()
         for op in comm.OPS])
    for obj in ("rank:pairwise", "rank:ndcg"):
        dr = rank_dmatrix(xt, obj)
        bst, lines = _train(xt, {**RANK, "objective": obj}, dr, 3,
                            [(dr, "train")])
        arrs[obj], texts[obj] = _raw(bst), lines
    if not full:
        return arrs, texts
    d = xt.DMatrix(X, label=y)
    bst, lines = _train(xt, {**FIXED, "hist_precision": "fp32"}, d, 3,
                        [(d, "train")])
    arrs["fp32"], texts["fp32"] = _raw(bst), lines
    Xm, ym = multiclass_data()
    dm = xt.DMatrix(Xm, label=ym)
    bst, lines = _train(xt, {**FIXED, "objective": "multi:softmax",
                             "num_class": 3}, dm, 3, [(dm, "train")])
    arrs["multiclass"], texts["multiclass"] = _raw(bst), lines
    db = xt.DMatrix(X, label=y)
    db.set_base_margin(base_margin())
    bst, _ = _train(xt, FIXED, db, 3)
    arrs["base_margin"] = _raw(bst)
    arrs["base_margin_pred"] = bst.predict(db, output_margin=True)
    df = xt.DMatrix(X, label=y)
    bst = xt.train(FIXED, df, 3, obj=logistic_obj, device="cpu")
    arrs["fobj"] = _raw(bst)
    dg = xt.DMatrix(X, label=y)
    bst = xt.Booster(FIXED, cache=[dg], device="cpu")
    g = (X[:, 0] - y).astype(np.float32)
    for _ in range(2):
        bst.boost(dg, g, np.ones(N, np.float32))
    arrs["boost"] = _raw(bst)
    bst, _ = _train(xt, {**FIXED, "hist_precision": "int8"},
                    xt.DMatrix(X, label=y), 3)
    arrs["int8"] = _raw(bst)
    # refresh on new labels of the same rows
    dr = xt.DMatrix(X, label=y)
    bst, _ = _train(xt, FIXED, dr, 2)
    bst.set_param({"updater": "refresh"})
    dr2 = xt.DMatrix(X, label=(X[:, 1] > 0).astype(np.float32))
    bst.update(dr2, 2)
    arrs["refresh"] = _raw(bst)
    # subtraction on a skewed layout: the full-build fallback
    from xgboost_tpu_torch.models import tree as ttree
    calls = []
    full_build = ttree._full_level_hist

    def counted(*a, **k):
        calls.append(1)
        return full_build(*a, **k)
    ttree._full_level_hist = counted
    os.environ["XGBTPU_HIST_SUBTRACTION"] = "1"
    try:
        Xs, ys = skewed_data()
        bst, _ = _train(xt, {**FIXED, "max_depth": 2}, xt.DMatrix(Xs, label=ys),
                        1)
    finally:
        del os.environ["XGBTPU_HIST_SUBTRACTION"]
        ttree._full_level_hist = full_build
    arrs["subtract"] = _raw(bst)
    arrs["subtract_full_builds"] = np.asarray([len(calls)])
    # paged growth: every batch streamed (no device cache)
    from xgboost_tpu_torch.external import ExtMemDMatrix
    import tempfile
    os.environ["XGBTPU_EXT_DEVICE_CACHE_MB"] = "0"
    try:
        chunks = [(X[s:s + 128], y[s:s + 128]) for s in range(0, N, 128)]
        dp = ExtMemDMatrix(iter(chunks), page_rows=200, cache=os.path.join(
            tempfile.mkdtemp(prefix="xgbtpu_dist_"), "m"))
        bst, _ = _train(xt, FIXED, dp, 2)
        assert bst._cache[id(dp)].external
    finally:
        del os.environ["XGBTPU_EXT_DEVICE_CACHE_MB"]
    arrs["paged"] = _raw(bst)
    # grow_tree_dp on this rank's block: the tree of all rows
    import torch
    from xgboost_tpu_torch.binning import bin_matrix
    from xgboost_tpu_torch.models.tree import GrowConfig
    from xgboost_tpu_torch.ops.split import SplitConfig
    from xgboost_tpu_torch.parallel.dp import grow_tree_dp, shard_rows
    from xgboost_tpu_torch.parallel.mesh import data_parallel_mesh
    mesh = data_parallel_mesh("cpu")
    cuts = bst.gbtree.cuts
    bins = torch.from_numpy(bin_matrix(xt.DMatrix(X), cuts).astype(np.int32))
    gh = torch.from_numpy(np.stack([y - 0.5, np.full(N, 0.25)], 1).astype(
        np.float32))
    valid = torch.from_numpy(shard_rows(mesh, np.ones(N, bool), False))
    cfg = GrowConfig(SplitConfig(), max_depth=3, n_bin=cuts.max_bin,
                     hist_precision="fixed")
    tree, row_leaf, _ = grow_tree_dp(
        mesh, shard_rows(mesh, bins), shard_rows(mesh, gh),
        torch.from_numpy(cuts.cut_values), torch.from_numpy(cuts.n_cuts),
        cfg, valid)
    arrs["grow_dp"] = np.concatenate([tree.feature.numpy().astype(
        np.float32), tree.leaf_value.numpy()])
    arrs["grow_dp_leaf"] = torch.cat(mesh.all_gather(row_leaf))[:N].numpy()
    dl = xt.DMatrix(X, label=X[:, 0] - 0.5 * X[:, 2])
    bst = xt.train({"booster": "gblinear", "objective": "reg:linear",
                    "eta": 0.5, "lambda": 1.0, "alpha": 0.01,
                    "dsplit": "row", "silent": 1}, dl, 3, device="cpu")
    arrs["gblinear"] = bst.gbtree.weight.numpy()
    arrs["gblinear_pred"] = bst.predict(dl)
    return arrs, texts


def worker_main(out_dir: str, suite: str) -> None:
    import torch
    torch.set_num_threads(1)
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.parallel.launch import init_worker
    init_worker("cpu")
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    arrs, texts = worker_scenarios(xt, world, suite == "full")
    from xgboost_tpu_torch.parallel.mesh import get_mesh
    m = get_mesh()
    arrs["installed"] = np.array([m.world, m.rank == rank,
                                  m.backend == "gloo"])
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

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu.parallel.mesh import (data_parallel_mesh,  # noqa: E402
                                       set_mesh)


def start_world(world: int, suite: str, out_dir: str) -> subprocess.Popen:
    """One job of ``world`` ranks through the port's launcher."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch", "-n",
         str(world), "--timeout-sec", "240", sys.executable,
         os.path.abspath(__file__), "worker", out_dir, suite],
        env=env, cwd=out_dir)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{W: [per-rank (arrays, texts)]} for W = 1, 2 (every scenario)
    and 3, 4 (the fixed run); the four jobs run at once."""
    jobs = {}
    for world, suite in ((1, "full"), (2, "full"), (3, "fixed"),
                         (4, "fixed")):
        d = str(tmp_path_factory.mktemp(f"w{world}"))
        jobs[world] = (d, start_world(world, suite, d))
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


def jax_train(world, params, X, y, rounds, evals=(), margin=None,
              obj=None):
    """The JAX package on a data mesh of ``world`` devices: (model
    bytes, eval lines, booster)."""
    set_mesh(data_parallel_mesh(world))
    try:
        d = xj.DMatrix(X, label=y)
        if margin is not None:
            d.set_base_margin(margin)
        ev = [(d if e is None else xj.DMatrix(e[0], label=e[1]), name)
              for e, name in evals]
        if obj is not None:
            bst = xj.train(params, d, rounds, obj=obj, verbose_eval=False)
            return bytes(bst.save_raw()), [], bst
        bst = xj.Booster(params, cache=[d] + [e for e, _ in ev])
        lines = []
        bst.update_many(d, 0, rounds, evals=ev or None,
                        eval_callback=lambda i, m: lines.append(m))
        return bytes(bst.save_raw()), lines, bst
    finally:
        set_mesh(None)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_fixed_model_and_eval_lines_match_jax_mesh(worlds, world):
    """The acceptance contract: "fixed" model bytes and eval lines at W
    ranks byte-equal to the JAX package's mesh of W devices, and to the
    port's world of one."""
    X, y = make_data()
    raw, lines, _ = jax_train(world, FIXED, X, y, 5,
                              [(None, "train"), (make_data(203, seed=7),
                                                 "eval")])
    arrs, texts = worlds[world][0]
    assert arrs["fixed"].tobytes() == raw
    assert texts["fixed"] == lines
    one = worlds[1][0][0]
    for key in ("fixed", "fixed_pred", "fixed_margin", "fixed_leaf"):
        np.testing.assert_array_equal(arrs[key], one[key], err_msg=key)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_every_rank_saves_the_same_bytes(worlds, world):
    ranks = worlds[world]
    for arrs, texts in ranks[1:]:
        for k, v in ranks[0][0].items():
            np.testing.assert_array_equal(arrs[k], v, err_msg=k)
        assert texts == ranks[0][1]


def test_init_worker_installs_the_world(worlds):
    """``init_worker`` installs its world (``set_mesh``): every rank's
    ``get_mesh()`` holds its rank, the world size and gloo."""
    for world, ranks in worlds.items():
        for arrs, _ in ranks:
            assert arrs["installed"].tolist() == [world, 1, 1], world


def test_collectives_are_counted(worlds):
    """``obs/comm.py``: a world of one makes no collective call; W > 1
    counts its level reduces (allreduce) and its gathered margins and
    float sums (allgather) on every rank alike, and the
    ``xgbtpu_comm_*`` families render."""
    assert worlds[1][0][0]["comm_counts"].tolist() == [0, 0, 0]
    for world in (2, 3, 4):
        allreduce, allgather, _ = worlds[world][0][0]["comm_counts"]
        # 5 rounds x 3 levels of int32 histograms, an int8-free run
        assert allreduce >= 15 and allgather >= 5
        assert worlds[world][0][0]["comm_families"].all()


def test_predict_and_pred_leaf_return_every_row(worlds):
    """Every rank returns all N rows (padding cut): 501 rows at W = 2 and
    4 pad one and three rows."""
    for world in (2, 4):
        arrs = worlds[world][0][0]
        assert arrs["fixed_leaf"].shape[0] == N
        assert arrs["fixed_margin"].shape == (N,)
        assert arrs["fixed_pred"].shape == (203,)


def test_fp32_trees_match_jax_mesh_structure(worlds):
    X, y = make_data()
    raw, lines, _ = jax_train(2, {**FIXED, "hist_precision": "fp32"}, X, y,
                              3, [(None, "train")])
    sj = _state(raw)
    st = _state(worlds[2][0][0]["fp32"].tobytes())
    for k in ("tree_feature", "tree_cut_index", "tree_is_leaf",
              "tree_default_left", "cut_values"):
        np.testing.assert_array_equal(st[k], sj[k], err_msg=k)
    np.testing.assert_allclose(st["tree_leaf_value"], sj["tree_leaf_value"],
                               rtol=1e-5, atol=1e-7)
    assert worlds[2][0][1]["fp32"] == lines


@pytest.mark.parametrize("name", ["multiclass", "base_margin", "fobj"])
def test_more_objectives_match_jax_mesh(worlds, name):
    """Multiclass, a base margin on odd rows (501 at W = 2 pads one) and
    a custom objective: W = 2 bytes equal to the JAX mesh of 2 and to
    W = 1."""
    if name == "multiclass":
        X, y = multiclass_data()
        raw, _, _ = jax_train(2, {**FIXED, "objective": "multi:softmax",
                                  "num_class": 3}, X, y, 3)
    elif name == "base_margin":
        X, y = make_data()
        raw, _, bj = jax_train(2, FIXED, X, y, 3, margin=base_margin())
    else:
        X, y = make_data()
        raw, _, _ = jax_train(2, FIXED, X, y, 3, obj=logistic_obj)
    assert worlds[2][0][0][name].tobytes() == raw
    np.testing.assert_array_equal(worlds[2][0][0][name], worlds[1][0][0][name])


@pytest.mark.parametrize("name", ["boost", "int8", "subtract", "paged",
                                  "base_margin_pred", "grow_dp",
                                  "grow_dp_leaf"])
def test_world_of_two_equals_world_of_one(worlds, name):
    np.testing.assert_array_equal(worlds[2][0][0][name],
                                  worlds[1][0][0][name])


def test_refresh_matches_world_one(worlds):
    """``refresh`` reduces its float K2 node sums over the ranks: the
    structure is kept bitwise, refreshed leaf values and hessian sums
    within rtol 1e-5 of W = 1, gains (a difference of three node terms,
    which cancels) within rtol 1e-4."""
    s2 = _state(worlds[2][0][0]["refresh"].tobytes())
    s1 = _state(worlds[1][0][0]["refresh"].tobytes())
    for k in ("tree_feature", "tree_cut_index", "tree_is_leaf",
              "tree_default_left"):
        np.testing.assert_array_equal(s2[k], s1[k], err_msg=k)
    for k, rtol in (("tree_leaf_value", 1e-5), ("tree_sum_hess", 1e-5),
                    ("tree_gain", 1e-4)):
        np.testing.assert_allclose(s2[k], s1[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)
    assert not np.array_equal(s1["tree_leaf_value"],
                              _state(worlds[1][0][0]["fixed"].tobytes())[
                                  "tree_leaf_value"][:2])


def test_skewed_shard_takes_the_full_build_together(worlds):
    """Subtraction: at W = 2 the skewed layout overflows one rank's
    buffer at level 1, so both ranks build that level whole (and the
    model stays that of W = 1, which subtracts)."""
    assert worlds[1][0][0]["subtract_full_builds"][0] == 1   # level 0
    for arrs, _ in worlds[2]:
        assert arrs["subtract_full_builds"][0] == 2


def test_gblinear_matches_world_one_and_jax_mesh(worlds):
    X, _ = make_data()
    yl = X[:, 0] - 0.5 * X[:, 2]
    set_mesh(data_parallel_mesh(2))
    try:
        bj = xj.train({"booster": "gblinear", "objective": "reg:linear",
                       "eta": 0.5, "lambda": 1.0, "alpha": 0.01,
                       "dsplit": "row"}, xj.DMatrix(X, label=yl), 3,
                      verbose_eval=False)
    finally:
        set_mesh(None)
    w2 = worlds[2][0][0]["gblinear"]
    np.testing.assert_allclose(w2, worlds[1][0][0]["gblinear"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(w2, np.asarray(bj.gbtree.weight), rtol=1e-5,
                               atol=1e-6)
    assert worlds[2][0][0]["gblinear_pred"].shape == (N,)


def _state(raw: bytes):
    b = xt.Booster(device="cpu")
    b.load_raw(raw)
    return b.gbtree.get_state()


@pytest.mark.parametrize("objective", ["rank:pairwise", "rank:ndcg"])
def test_rank_under_row_split_matches_world_one_and_jax_mesh(worlds,
                                                             objective):
    """``rank:*`` under ``dsplit=row``: the gradient of every row's
    gathered margin, each rank's block of it; model bytes and eval lines
    at W = 2, 3, 4 byte-equal to W = 1 and to the JAX package's mesh of
    W devices (its rounds one at a time: its fused round scan takes the
    LambdaRank gradient of each shard's rows alone)."""
    for world in (1, 2, 4):
        set_mesh(data_parallel_mesh(world))
        try:
            d = rank_dmatrix(xj, objective)
            bst = xj.Booster({**RANK, "objective": objective}, cache=[d])
            lines = []
            for i in range(3):
                bst.update(d, i)
                lines.append(bst.eval_set([(d, "train")], i))
        finally:
            set_mesh(None)
        arrs, texts = worlds[world][0]
        assert arrs[objective].tobytes() == bytes(bst.save_raw())
        assert texts[objective] == lines
    one = worlds[1][0]
    for arrs, texts in worlds[3]:
        assert arrs[objective].tobytes() == one[0][objective].tobytes()
        assert texts[objective] == one[1][objective]


def test_rank_on_a_split_load_raises(tmp_path):
    """A split-loaded matrix has no rank's whole query groups: ``rank:*``
    refuses it, as in the JAX package (``learner.py:590-594``)."""
    from xgboost_tpu_torch.parallel.sharded import ShardedDMatrix
    X, rel, _ = rank_data()
    path = tmp_path / "r.svm"
    path.write_text("".join(
        f"{int(rel[i])} " + " ".join(f"{j}:{X[i, j]:.6f}" for j in range(F))
        + "\n" for i in range(64)))
    with pytest.raises(NotImplementedError, match="rank"):
        xt.train({**RANK, "objective": "rank:pairwise"},
                 ShardedDMatrix(str(path)), 1, device="cpu")
