"""Text dumps and split-count importance of the PyTorch port
(``xgboost_tpu_torch.dump``, ``Booster.get_dump`` / ``dump_model`` /
``get_fscore``) against the JAX package's, on the CPU.

Every comparison reads one model file in both packages, so the float32
arrays are the same and the expected tolerance is none: dump text, dump
files and importance dicts byte-equal.  The models: one-group
binary:logistic at depth 3 on data with 15% of the values missing (both
default directions occur), a 3-class softprob ensemble with
``num_parallel_tree=2`` (K3's path), and a depth-0 booster (leaves
only).  They are trained by the port and read by both packages, so no
JAX training compile is spent.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu_torch.dump import load_fmap  # noqa: E402

FMAP = ("0\tpresent\ti\n1\tsize\tq\n2\tcount\tint\n"
        "3\tratio\tq\nbad line\n")
MODELS = {
    "binary": ({"objective": "binary:logistic", "max_depth": 3,
                "eta": 0.4}, 2, 4),
    "softprob": ({"objective": "multi:softprob", "num_class": 3,
                  "num_parallel_tree": 2, "max_depth": 3, "eta": 0.3},
                 3, 2),
    "depth0": ({"objective": "reg:linear", "max_depth": 0}, 2, 2),
}


@pytest.fixture(scope="module")
def fmap(tmp_path_factory):
    path = tmp_path_factory.mktemp("fmap") / "featmap.txt"
    path.write_text(FMAP)
    return str(path)


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request, tmp_path_factory):
    """(port booster, JAX booster) on one model file."""
    params, n_class, rounds = MODELS[request.param]
    rng = np.random.RandomState(13)
    X = rng.randn(500, 5).astype(np.float32) * 3
    X[rng.rand(500, 5) < 0.15] = np.nan
    Z = np.nan_to_num(X)
    y = (np.digitize(Z[:, 0] + Z[:, 1] * Z[:, 2], [-1.0, 1.5])
         if n_class == 3 else (Z[:, 0] - Z[:, 3] > 0.2)).astype(np.float32)
    bst = xt.train(params, xt.DMatrix(X, label=y), rounds, device="cpu")
    path = str(tmp_path_factory.mktemp("dump") / f"{request.param}.model")
    bst.save_model(path)
    return (xt.Booster(model_file=path, device="cpu"),
            xj.Booster(model_file=path), request.param)


def test_load_fmap_equals_the_jax_reader(fmap):
    from xgboost_tpu.dump import load_fmap as jax_load_fmap
    assert load_fmap(fmap) == jax_load_fmap(fmap)
    assert load_fmap("") == {}


@pytest.mark.parametrize("with_fmap", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
def test_get_dump_equals_the_jax_dump(model, fmap, with_fmap, with_stats):
    bt, bj, name = model
    f = fmap if with_fmap else ""
    got = bt.get_dump(f, with_stats=with_stats)
    assert got == bj.get_dump(f, with_stats=with_stats)
    assert len(got) == bt.gbtree.num_trees
    if name == "depth0":
        assert all(d.count("\n") == 1 and "leaf=" in d for d in got)
    else:
        assert any("yes=" in d for d in got)


def test_dump_model_file_equals_the_jax_file(model, fmap, tmp_path):
    bt, bj, _ = model
    bt.dump_model(str(tmp_path / "t.txt"), fmap, with_stats=True)
    bj.dump_model(str(tmp_path / "j.txt"), fmap, with_stats=True)
    t = (tmp_path / "t.txt").read_bytes()
    assert t == (tmp_path / "j.txt").read_bytes()
    assert t.startswith(b"booster[0]:\n")


@pytest.mark.parametrize("with_fmap", [False, True])
def test_get_fscore_equals_the_jax_fscore(model, fmap, with_fmap):
    bt, bj, name = model
    f = fmap if with_fmap else ""
    got = bt.get_fscore(f)
    assert got == bj.get_fscore(f)
    assert bool(got) == (name != "depth0")


def test_dump_handles_every_fmap_type(tmp_path):
    """A hand-made tree: an indicator split (missing to the right), an
    integer split at a fractional cut (the ceiling), and a quantitative
    split, each equal to the JAX dump."""
    rng = np.random.RandomState(2)
    X = rng.rand(300, 3).astype(np.float32) * 5
    X[:, 0] = rng.rand(300) < 0.5
    X[X[:, 0] == 0, 0] = np.nan
    y = (np.nan_to_num(X[:, 0]) + (X[:, 1] > 2.5) + (X[:, 2] > 1.7)
         ).astype(np.float32)
    bst = xt.train({"max_depth": 3, "eta": 1.0}, xt.DMatrix(X, label=y), 1,
                   device="cpu")
    path = str(tmp_path / "m.model")
    bst.save_model(path)
    fm = tmp_path / "fm.txt"
    fm.write_text("0\tflag\ti\n1\tcount\tint\n2\tlevel\tq\n")
    got = xt.Booster(model_file=path, device="cpu").get_dump(str(fm), True)
    assert got == xj.Booster(model_file=path).get_dump(str(fm), True)
    text = got[0]
    assert "[flag]" in text and "[count<" in text and "[level<" in text
    assert "gain=" in text and "cover=" in text
