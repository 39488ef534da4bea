"""Row-split training of the port on the card: W = 2 ranks on one GPU
over gloo (NCCL refuses two ranks on one card), spawned by the port's
launcher.  Marked ``cuda``: without an NVIDIA GPU they skip.  No JAX
here (the repo's conftest imports JAX, hence ``--noconftest``):

    python -m pytest --noconftest tests/test_torch_dist_cuda.py -m cuda

Each rank runs this file as a script (``worker``).  Checked: K1 and K3
levels with one int8 scale over both ranks' rows (the int8 model at
W = 2 byte-equal to W = 1, and the reduced level bitwise the plain
histogram of all rows), paged growth and gblinear under the reduce, and
a rank killed mid-round making the launcher return non-zero without a
hang.  Column split (``dsplit=col``): each rank uploads its block of
the features, launches K1 on it at every level, and the trees at W = 1
and 2 are the trees of the same int8 rounds without a split.
"""

import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F = 40_003, 12


def make_data(seed=0, k=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F).astype(np.float32)
    if k:
        y = np.argmax(X[:, :k] + 0.3 * rng.randn(N, k), 1).astype(np.float32)
    else:
        y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    return X, y


def _raw(bst):
    return np.frombuffer(bst.save_raw(), np.uint8)


def worker_main(out_dir: str, suite: str) -> None:
    import torch
    import xgboost_tpu_torch as xt
    from xgboost_tpu_torch.ops import cuda_hist, cuda_hist_batched
    from xgboost_tpu_torch.parallel.launch import init_worker
    init_worker()
    import torch.distributed as dist
    rank = dist.get_rank() if dist.is_initialized() else 0
    arrs = {}
    base = {"max_depth": 5, "eta": 0.3, "max_bin": 64, "dsplit": "row",
            "device_sketch": 0, "silent": 1}
    if suite == "kill":
        X, y = make_data()
        d = xt.DMatrix(X, label=y)
        bst = xt.Booster({**base, "objective": "binary:logistic"}, cache=[d])
        for i in range(200):
            if rank == 1 and i == 2:
                os.kill(os.getpid(), 9)      # this rank dies mid-training
            bst.update(d, i)
        return
    X, y = make_data()
    d = xt.DMatrix(X, label=y)
    cuda_hist.reset_launches()
    bst = xt.train({**base, "objective": "binary:logistic"}, d, 4)
    arrs["int8"] = _raw(bst)
    arrs["k1_launches"] = np.asarray([cuda_hist.launches])
    Xm, ym = make_data(1, k=4)
    cuda_hist_batched.reset_launches()
    bst = xt.train({**base, "objective": "multi:softmax", "num_class": 4},
                   xt.DMatrix(Xm, label=ym), 2)
    arrs["k3"] = _raw(bst)
    arrs["k3_launches"] = np.asarray([cuda_hist_batched.launches])
    # one level by hand: this rank's K1 on its block, the reduced level
    # against the plain histogram of all rows
    from xgboost_tpu_torch.parallel.dp import HistReduce, shard_rows
    from xgboost_tpu_torch.parallel.mesh import data_parallel_mesh
    from xgboost_tpu_torch.ops.histogram import prepare_hist
    mesh = data_parallel_mesh("cuda")
    rng = np.random.RandomState(3)
    bins = torch.from_numpy(rng.randint(0, 64, (N, F)).astype(np.uint8))
    gh = torch.from_numpy(rng.randn(N, 2).astype(np.float32))
    pos = torch.from_numpy(rng.randint(-1, 8, N).astype(np.int32))
    red = HistReduce(mesh) if mesh.world > 1 else None
    b_blk = shard_rows(mesh, bins).cuda()
    g_blk = shard_rows(mesh, gh).cuda()
    p_blk = shard_rows(mesh, pos, fill=-1).cuda()
    prep = prepare_hist(g_blk, "int8", N, None if red is None else red.max)
    level = cuda_hist.level_histogram(b_blk, prep.gh_in, p_blk, 8, 64, "int")
    if red is not None:
        level = red(level)
    full = prepare_hist(gh.cuda(), "int8")
    want = cuda_hist.level_histogram_plain(bins.cuda(), full.gh_in,
                                           pos.cuda(), 8, 64, "int")
    arrs["level_equal"] = np.asarray([bool(torch.equal(level, want))])
    # paged growth and gblinear under the reduce
    from xgboost_tpu_torch.external import ExtMemDMatrix
    import tempfile
    os.environ["XGBTPU_EXT_DEVICE_CACHE_MB"] = "0"
    chunks = [(X[s:s + 10_000], y[s:s + 10_000]) for s in range(0, N, 10_000)]
    dp = ExtMemDMatrix(iter(chunks), page_rows=16_384, cache=os.path.join(
        tempfile.mkdtemp(prefix="xgbtpu_distc_"), "m"))
    bst = xt.train({**base, "objective": "binary:logistic",
                    "hist_precision": "fixed"}, dp, 2)
    arrs["paged"] = _raw(bst)
    torch.set_float32_matmul_precision("highest")
    bst = xt.train({"booster": "gblinear", "objective": "reg:linear",
                    "dsplit": "row", "silent": 1},
                   xt.DMatrix(X, label=X[:, 0] - X[:, 3]), 3)
    arrs["gblinear"] = bst.gbtree.weight.cpu().numpy()
    # column split: this rank's block of the features, K1 on it
    dc = xt.DMatrix(X, label=y)
    cuda_hist.reset_launches()
    bst = xt.train({**base, "dsplit": "col",
                    "objective": "binary:logistic"}, dc, 4)
    arrs["col"] = _raw(bst)
    arrs["col_k1_launches"] = np.asarray([cuda_hist.launches])
    entry = bst._entry(dc)
    arrs["col_block"] = np.asarray([entry.binned.shape[1],
                                    entry.binned.is_cuda])
    cuda_hist.reset_launches()
    bst = xt.train({**base, "dsplit": "col", "updater": "grow_colmaker",
                    "objective": "binary:logistic"}, xt.DMatrix(X, label=y),
                   2)
    arrs["col_exact"] = _raw(bst)
    arrs["col_exact_k1"] = np.asarray([cuda_hist.launches])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrs)
    if dist.is_initialized():
        dist.barrier()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    sys.path.insert(0, REPO)
    worker_main(sys.argv[2], sys.argv[3])
    sys.exit(0)


import pytest  # noqa: E402

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module")
def cuda_worlds(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    out = {}
    env = dict(os.environ, PYTHONPATH=REPO)
    for world in (1, 2):
        d = str(tmp_path_factory.mktemp(f"c{world}"))
        rc = subprocess.run(
            [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch", "-n",
             str(world), "--timeout-sec", "600", sys.executable,
             os.path.abspath(__file__), "worker", d, "full"],
            env=env, cwd=d, timeout=700).returncode
        assert rc == 0, f"world {world}: rc {rc}"
        out[world] = []
        for r in range(world):
            with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                out[world].append({k: z[k] for k in z.files})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["int8", "k3", "paged"])
def test_world_of_two_bytes_equal_world_of_one_on_the_card(cuda_worlds,
                                                            name):
    """int8 (the card's auto) through K1, 4 classes through K3, and paged
    growth: every rank's model byte-equal to the world of one."""
    for arrs in cuda_worlds[2]:
        np.testing.assert_array_equal(arrs[name], cuda_worlds[1][0][name])


@pytest.mark.cuda
def test_kernels_ran_on_each_rank(cuda_worlds):
    for arrs in cuda_worlds[2]:
        assert arrs["k1_launches"][0] == 4 * 5      # 4 rounds, depth 5
        assert arrs["k3_launches"][0] == 2 * 5


@pytest.mark.cuda
def test_reduced_int8_level_is_the_plain_level_of_all_rows(cuda_worlds):
    for arrs in cuda_worlds[2] + cuda_worlds[1]:
        assert arrs["level_equal"][0]


@pytest.mark.cuda
def test_gblinear_under_the_reduce(cuda_worlds):
    for arrs in cuda_worlds[2]:
        np.testing.assert_allclose(arrs["gblinear"],
                                   cuda_worlds[1][0]["gblinear"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_killed_rank_ends_the_launch(tmp_path):
    """A rank killed mid-training: the launcher returns non-zero (the
    kill's -9) and reaps the rank left waiting in a collective, well
    inside its time limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    t0 = time.perf_counter()
    rc = subprocess.run(
        [sys.executable, "-m", "xgboost_tpu_torch.parallel.launch", "-n",
         "2", "--timeout-sec", "300", sys.executable,
         os.path.abspath(__file__), "worker", str(tmp_path), "kill"],
        env=dict(os.environ, PYTHONPATH=REPO), timeout=400).returncode
    assert rc not in (0, 124)
    assert time.perf_counter() - t0 < 200


def _trees(raw):
    """A model's tree arrays, a leaf's rejected candidate (``cut_index``,
    ``threshold`` where ``feature < 0``) zeroed: what column split keeps
    of it is rank 0's (``tests/test_torch_colsplit.py``)."""
    import xgboost_tpu_torch as xt
    b = xt.Booster(device="cpu")
    b.load_raw(raw.tobytes())
    st = b.gbtree.get_state()
    leaf = st["tree_feature"] < 0
    for k in ("tree_cut_index", "tree_threshold"):
        st[k] = np.where(leaf, 0, st[k])
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_column_split_grows_the_unsplit_trees_on_the_card(cuda_worlds,
                                                          world):
    """``dsplit=col`` at W = 1 and 2: every rank's trees and cuts are
    those of the same int8 rounds without a split, bitwise, with K1 a
    level on each rank (4 rounds of depth 5)."""
    want = _trees(cuda_worlds[1][0]["int8"])
    for arrs in cuda_worlds[world]:
        got = _trees(arrs["col"])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert arrs["col_k1_launches"][0] == 4 * 5


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 2])
def test_column_split_uploads_the_rank_block(cuda_worlds, world):
    """Each rank's cached matrix on the card holds its F / W columns."""
    for arrs in cuda_worlds[world]:
        assert arrs["col_block"].tolist() == [F // world, 1]


@pytest.mark.cuda
def test_exact_column_split_equals_world_one_on_the_card(cuda_worlds):
    """Exact ``grow_colmaker`` by features: each rank's model bytes those
    of the world of one (every feature's sums independent of the
    features beside it), no K1."""
    for arrs in cuda_worlds[2]:
        np.testing.assert_array_equal(arrs["col_exact"],
                                      cuda_worlds[1][0]["col_exact"])
        assert arrs["col_exact_k1"][0] == 0
