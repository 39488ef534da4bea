"""The PyTorch port's command line (``python -m xgboost_tpu_torch``)
against the JAX package's (``python -m xgboost_tpu``), on the CPU, on
synthetic libsvm files (``RandomState(7)``, 400 x 6, as in
``tests/test_cli.py``, and a variant with 15% of the values missing).

Tolerances and why:

- one model file saved by the JAX CLI, read by both CLIs: ``task=dump``
  (with and without stats, with an fmap of ``i`` / ``q`` / ``int``
  features) and ``task=pred pred_margin=1`` byte-equal (the same float32
  arrays formatted the same way; margins are bitwise for one model
  file); ``task=pred`` within 1e-6 (XLA's ``exp`` against torch's, a
  few ulp); ``task=eval`` the same line;
- both CLIs training on one config: eval lines with the same keys and
  values within 1e-5; the dump's structure equal at depth 3 (node ids,
  features, conditions, yes / no / missing) and leaf, gain and cover
  within rtol 1e-5 (node totals differ by f32 rounding, ROADMAP.md
  section 3; a gain also within 1e-5 of its tree's largest gain, the
  size of the terms it is the difference of); the model header's
  ``param`` equal, with no ``device``;
- the port's CLI against the port's own API and against itself (fused
  and eval'd, resumed and uninterrupted): tree arrays bitwise;
- DMatrix buffers across the packages: arrays and metadata equal;
- ``task=pipeline`` against the JAX CLI's, reg:linear: the same gate
  verdicts, tree structure bitwise, leaf values within rtol 1e-5;
- ``task=lanes`` against ``run_tenant_lanes`` through the API: gate
  verdicts equal and tree arrays bitwise (the same code on the same
  data);
- the depth-8 continuation from one JAX model file (ROADMAP.md section
  3): the new round's structure bitwise, leaf values within rtol 1e-5.

Each JAX CLI configuration costs jit compiles, so every JAX run is made
once in a module-scoped fixture and shared.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import xgboost_tpu as xj  # noqa: E402
import xgboost_tpu_torch as xt  # noqa: E402
from xgboost_tpu.cli import main as jax_main  # noqa: E402
from xgboost_tpu_torch.cli import main as port_main  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ["dense", "nan"]
FMAP = "0\tpresent\ti\n1\tsize\tq\n2\tcount\tint\n"


def write_libsvm(path, X, y, fmt="{:.6f}"):
    """Rows as libsvm text; NaN entries are left out (missing)."""
    with open(path, "w") as f:
        for row, label in zip(X, y):
            feats = " ".join(f"{j}:{fmt.format(v)}"
                             for j, v in enumerate(row) if not np.isnan(v))
            f.write(f"{label:g} {feats}\n")


def write_conf(path, **kw):
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in kw.items()))
    return str(path)


def run_cli(main, argv, cwd):
    """``main(argv)`` in ``cwd``; returns (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(list(argv))
    finally:
        os.chdir(old)
    return rc, out.getvalue(), err.getvalue()


def eval_lines(text):
    return [line for line in text.splitlines() if line.startswith("[")]


def parse_eval(line):
    out = {}
    for part in line.split("\t")[1:]:
        k, _, v = part.rpartition(":")
        out[k] = float(v)
    return out


def header_of(path):
    from xgboost_tpu_torch.reliability.integrity import (read_file,
                                                         verify_model_bytes)
    raw = verify_model_bytes(read_file(path), name=path)
    with np.load(io.BytesIO(raw)) as z:
        return json.loads(bytes(z["header"]).decode())


def tree_state(path):
    return xt.Booster(model_file=path, device="cpu").gbtree.get_state()


def assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def dump_structure(text):
    """{(booster, node id): line without its leaf / gain / cover
    values} of a dump."""
    out, b = {}, -1
    for line in text.splitlines():
        if line.startswith("booster["):
            b += 1
            continue
        nid, _, rest = line.strip().partition(":")
        out[(b, int(nid))] = ",".join(
            part.partition("=")[0] if part.partition("=")[0] in (
                "leaf", "gain", "cover") else part
            for part in rest.split(","))
    return out


# ------------------------------------------------------------ fixtures
@pytest.fixture(scope="module")
def svm(tmp_path_factory):
    """Train / test libsvm files of both variants, an fmap, and the
    numpy arrays."""
    root = tmp_path_factory.mktemp("svm")
    rng = np.random.RandomState(7)
    X = rng.rand(400, 6).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 1.0).astype(np.float32)
    Xn = X.copy()
    Xn[np.random.RandomState(8).rand(*X.shape) < 0.15] = np.nan
    out = {"root": root, "fmap": str(root / "featmap.txt")}
    with open(out["fmap"], "w") as f:
        f.write(FMAP)
    for name, A in (("dense", X), ("nan", Xn)):
        tr, te = str(root / f"{name}-train.svm"), str(root / f"{name}-test.svm")
        write_libsvm(tr, A[:300], y[:300])
        write_libsvm(te, A[300:], y[300:])
        out[name] = {"train": tr, "test": te, "X": A, "y": y}
    return out


def base_conf(train, test, **kw):
    conf = {"task": "train", "booster": "gbtree",
            "objective": "binary:logistic", "eta": "0.5", "max_depth": "3",
            "num_round": "5", "data": train, "eval[test]": test,
            "eval_metric": "error", "model_out": "final.model", "silent": "1"}
    conf.update(kw)
    return conf


@pytest.fixture(scope="module", params=VARIANTS)
def pair(request, svm, tmp_path_factory):
    """Both CLIs train on one config file (each in a directory of its
    own, the same relative ``model_out``), then both read the JAX
    model file with task=dump / pred / eval."""
    d = svm[request.param]
    root = tmp_path_factory.mktemp(f"pair-{request.param}")
    conf = write_conf(root / "run.conf",
                      **base_conf(d["train"], d["test"], eval_metric="auc",
                                  eval_train="1"))
    # repeated eval_metric: both packages collect it into a list
    with open(conf, "a") as f:
        f.write("eval_metric = error\n")
    out = {"variant": request.param, "conf": conf, "data": d}
    for tag, main, extra in (("j", jax_main, []),
                             ("t", port_main, ["device=cpu"])):
        wd = root / tag
        wd.mkdir()
        rc, _, err = run_cli(main, [conf] + extra, wd)
        assert rc == 0, err
        out[tag + "_dir"] = wd
        out[tag + "_train_err"] = err
    jmodel = str(out["j_dir"] / "final.model")
    out["jmodel"] = jmodel
    reads = {
        "dump": ["task=dump"],
        "dump_stats": ["task=dump", "dump_stats=1"],
        "dump_fmap": ["task=dump", f"fmap={svm['fmap']}"],
        "dump_fmap_stats": ["task=dump", f"fmap={svm['fmap']}",
                            "dump_stats=1"],
        "pred_margin": ["task=pred", f"test:data={d['test']}",
                        "pred_margin=1"],
        "pred": ["task=pred", f"test:data={d['test']}"],
        "eval": ["task=eval"],
    }
    for tag, main, extra in (("j", jax_main, []),
                             ("t", port_main, ["device=cpu"])):
        for name, args in reads.items():
            target = root / f"{tag}-{name}.txt"
            argv = [conf, f"model_in={jmodel}", f"name_dump={target}",
                    f"name_pred={target}"] + args + extra
            rc, _, err = run_cli(main, argv, root)
            assert rc == 0, err
            out[(tag, name)] = (target.read_bytes() if name != "eval"
                                else eval_lines(err))
    return out


# -------------------------------------------------------- config files
def test_parse_config_file_equals_the_jax_reader(tmp_path):
    from xgboost_tpu.config import parse_config_file as jax_parse
    from xgboost_tpu_torch.config import parse_config_file
    path = tmp_path / "c.conf"
    path.write_text(
        "# a comment line\n\n"
        "booster = gbtree   # trailing comment\n"
        "objective=\"binary:logistic\"\n"
        "data = 'train.txt#cache'\n"
        "eval[test] = test.txt\n"
        "eval[ train ]=train.txt\n"
        "pipeline_data = a=b=c\n"
        "   \n"
        "no equals sign here\n"
        "=orphan value\n"
        "eta = 0.3\n"
        "eta = 0.5\n")
    assert parse_config_file(str(path)) == jax_parse(str(path))
    assert ("pipeline_data", "a=b=c") in parse_config_file(str(path))


def test_lane_and_pipeline_tables_equal_the_jax_tables():
    from xgboost_tpu import config as jc
    from xgboost_tpu_torch import config as tc
    assert tc.PIPELINE_PARAMS == jc.PIPELINE_PARAMS
    assert tc.LANE_PARAMS == jc.LANE_PARAMS
    assert tc.pipeline_params_help() == jc.pipeline_params_help()
    assert tc.lane_params_help() == jc.lane_params_help()


# ----------------------------------------- one model file, both packages
@pytest.mark.parametrize("kind", ["dump", "dump_stats", "dump_fmap",
                                  "dump_fmap_stats", "pred_margin"])
def test_reads_of_one_model_file_are_byte_equal(pair, kind):
    assert pair[("t", kind)] == pair[("j", kind)], kind
    assert pair[("t", kind)]


def test_pred_of_one_model_file_within_1e6(pair):
    pj = np.loadtxt(io.BytesIO(pair[("j", "pred")]))
    pt = np.loadtxt(io.BytesIO(pair[("t", "pred")]))
    assert pj.shape == pt.shape == (100,)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)


def test_eval_of_one_model_file_prints_the_same_line(pair):
    assert pair[("t", "eval")] == pair[("j", "eval")]
    assert len(pair[("t", "eval")]) == 1


# ------------------------------------------------- training, both CLIs
def test_training_eval_lines_close(pair):
    lj = eval_lines(pair["j_train_err"])
    lt = eval_lines(pair["t_train_err"])
    assert len(lj) == len(lt) == 5
    for a, b in zip(lj, lt):
        assert a.split("\t")[0] == b.split("\t")[0]
        sa, sb = parse_eval(a), parse_eval(b)
        assert list(sa) == list(sb) == ["test-auc", "test-error",
                                        "train-auc", "train-error"]
        for k in sa:
            assert abs(sa[k] - sb[k]) <= 1e-5, (a, b)


def test_training_dumps_equal_in_structure(pair, tmp_path):
    """The dump's structure equal; leaf, gain and cover of the dumped
    nodes within rtol 1e-5, read from the model arrays (the dump prints
    six significant digits)."""
    dumps, states = [], []
    for tag, main, extra in (("j", jax_main, []),
                             ("t", port_main, ["device=cpu"])):
        model = str(pair[tag + "_dir"] / "final.model")
        target = tmp_path / f"{tag}.dump"
        rc, _, err = run_cli(
            main, [pair["conf"], "task=dump", "dump_stats=1",
                   f"model_in={model}", f"name_dump={target}"] + extra,
            tmp_path)
        assert rc == 0, err
        dumps.append(dump_structure(target.read_text()))
        states.append(tree_state(model))
    assert dumps[0] == dumps[1] and len(dumps[0]) > 5 * 3
    (sj, st), nodes = states, sorted(dumps[0])
    idx = tuple(np.array(nodes).T)
    split = sj["tree_feature"][idx] >= 0
    for k, sel in (("tree_leaf_value", ~split),
                   ("tree_sum_hess", slice(None))):
        np.testing.assert_allclose(st[k][idx][sel], sj[k][idx][sel],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # a gain is the children's score terms less the parent's: its
    # rounding is relative to those terms, bounded by the tree's largest
    # gain, not to the difference (0.226473 against 0.226477 at a node
    # whose terms are near 15)
    gj, gt = sj["tree_gain"][idx][split], st["tree_gain"][idx][split]
    scale = np.abs(sj["tree_gain"]).max(axis=1)[idx[0]][split]
    assert (np.abs(gt - gj) <= 1e-5 * np.abs(gj) + 1e-5 * scale).all()


def test_training_model_header_param_equal(pair):
    hj = header_of(str(pair["j_dir"] / "final.model"))
    ht = header_of(str(pair["t_dir"] / "final.model"))
    assert ht["param"] == hj["param"]
    assert "device" not in ht["param"]
    assert ht["param"]["eval_metric"] == ["auc", "error"]
    assert ht["param"]["seed"] == 0


# --------------------------------------------------- the port's CLI alone
def port_train(tmp_path, svm, name, variant="dense", extra=(), **kw):
    d = svm[variant]
    conf = write_conf(tmp_path / f"{name}.conf",
                      **base_conf(d["train"], d["test"],
                                  model_out=str(tmp_path / f"{name}.model"),
                                  **kw))
    rc, _, err = run_cli(port_main, [conf, "device=cpu", *extra], tmp_path)
    assert rc == 0, err
    return str(tmp_path / f"{name}.model"), err


def test_cli_model_equals_the_api_bitwise(svm, tmp_path):
    model, _ = port_train(tmp_path, svm, "cli")
    params = {"objective": "binary:logistic", "eta": 0.5, "max_depth": 3}
    bst = xt.train(params, xt.DMatrix(svm["dense"]["train"]), 5,
                   device="cpu")
    assert_states_equal(tree_state(model), bst.gbtree.get_state())


def test_cli_fused_no_evals_equals_the_evald_run(svm, tmp_path):
    seq, err = port_train(tmp_path, svm, "seq", silent="0")
    assert len(eval_lines(err)) == 5
    assert "fusing rounds 0..4 in segments of 64" in err
    d = svm["dense"]
    conf = base_conf(d["train"], d["test"],
                     model_out=str(tmp_path / "fused.model"))
    del conf["eval[test]"]
    rc, _, err = run_cli(port_main, [write_conf(tmp_path / "f.conf", **conf),
                                     "device=cpu"], tmp_path)
    assert rc == 0 and not eval_lines(err), err
    assert_states_equal(tree_state(seq), tree_state(str(tmp_path /
                                                        "fused.model")))


def test_cli_per_round_path_reports_rounds(svm, tmp_path):
    """rounds_per_dispatch=0: one round a segment, plan 0, a
    'boosting round' line before each round."""
    _, err = port_train(tmp_path, svm, "pr", silent="0",
                        rounds_per_dispatch="0")
    assert "fusing rounds" not in err
    assert [line.split(",")[0] for line in err.splitlines()
            if line.startswith("boosting round")] == [
        f"boosting round {i}" for i in range(5)]


def test_cli_save_period_and_checkpoint_resume(svm, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    port_train(tmp_path, svm, "p4", num_round="4", save_period="2",
               model_dir=str(tmp_path), checkpoint_dir=ckpt)
    assert os.path.exists(tmp_path / "0002.model")
    assert os.path.exists(tmp_path / "0004.model")
    # save_period divides num_round: no final save
    assert not os.path.exists(tmp_path / "p4.model")
    kept = sorted(f for f in os.listdir(ckpt) if f.startswith("ckpt-"))
    assert kept == ["ckpt-000002.model", "ckpt-000004.model"]
    # "killed" after round 4 of 6: the rerun resumes from ckpt 4
    resumed, err = port_train(tmp_path, svm, "resumed", num_round="6",
                              checkpoint_dir=ckpt, silent="0")
    assert "[ckpt] resume at round 4" in err
    whole, _ = port_train(tmp_path, svm, "whole", num_round="6")
    assert xt.Booster(model_file=resumed,
                      device="cpu").gbtree.num_trees == 6
    assert_states_equal(tree_state(resumed), tree_state(whole))


def test_cli_model_out_none_and_null(svm, tmp_path):
    d = svm["dense"]
    conf = write_conf(tmp_path / "n.conf",
                      **base_conf(d["train"], d["test"], model_out="NONE",
                                  num_round="3", model_dir=str(tmp_path)))
    assert run_cli(port_main, [conf, "device=cpu"], tmp_path)[0] == 0
    assert not any(f.endswith(".model") for f in os.listdir(tmp_path))
    assert run_cli(port_main, [conf, "device=cpu", "model_out=NULL"],
                   tmp_path)[0] == 0
    assert os.path.exists(tmp_path / "0003.model")


def test_cli_model_in_continuation_gives_five_trees(svm, tmp_path):
    m1, _ = port_train(tmp_path, svm, "m1", num_round="3")
    m2, _ = port_train(tmp_path, svm, "m2", num_round="2",
                       extra=[f"model_in={m1}"])
    assert xt.Booster(model_file=m2, device="cpu").gbtree.num_trees == 5


def test_cli_pred_to_stdout_and_ntree_limit(svm, tmp_path):
    model, _ = port_train(tmp_path, svm, "s")
    d = svm["dense"]
    conf = write_conf(tmp_path / "s.conf", **base_conf(d["train"], d["test"]))
    rc, out, _ = run_cli(port_main, [conf, "device=cpu", "task=pred",
                                     f"model_in={model}", "name_pred=stdout",
                                     f"test:data={d['test']}",
                                     "ntree_limit=2"], tmp_path)
    assert rc == 0
    bst = xt.Booster(model_file=model, device="cpu")
    want = bst.predict(xt.DMatrix(d["test"]), ntree_limit=2)
    assert out == "".join(f"{p:g}\n" for p in want)


# ------------------------------------------------------------ buffers
def _meta_matrix(pkg, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.rand(40, 5).astype(np.float32)
    X[rng.rand(40, 5) < 0.3] = np.nan
    y = rng.rand(40).astype(np.float32)
    return pkg.DMatrix(X, label=y, weight=rng.rand(40) + 0.5,
                       base_margin=rng.randn(40), group=[10, 25, 5])


def _same_matrix(a, b):
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert a.num_col == b.num_col and a.num_row == b.num_row
    for f in ("label", "weight", "base_margin", "group_ptr"):
        x, y = getattr(a.info, f), getattr(b.info, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_buffers_cross_load(tmp_path, writer):
    src_pkg, dst_pkg = (xj, xt) if writer == "jax" else (xt, xj)
    src = _meta_matrix(src_pkg)
    path = str(tmp_path / "m.npz")
    src.save_binary(path)
    _same_matrix(src, dst_pkg.DMatrix(path))
    _same_matrix(src, src_pkg.DMatrix(path))


def test_port_buffers_are_deterministic(tmp_path):
    a, b = str(tmp_path / "a.buffer"), str(tmp_path / "b.buffer")
    _meta_matrix(xt).save_binary(a)
    _meta_matrix(xt).save_binary(b)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_buffer_magic_under_any_name_and_file_uri(svm, tmp_path):
    text = xt.DMatrix(svm["nan"]["train"])
    path = str(tmp_path / "train.buffer")
    text.save_binary(path)
    with open(path, "rb") as f:
        assert f.read(4) == b"PK\x03\x04"
    _same_matrix(text, xt.DMatrix(path))
    _same_matrix(text, xt.DMatrix("file://" + path))
    _same_matrix(xj.DMatrix(path), xt.DMatrix(path))


def test_path_cache_writes_then_reads_its_cache(svm, tmp_path):
    import shutil
    src = str(tmp_path / "t.svm")
    shutil.copy(svm["nan"]["train"], src)
    with open(src + ".weight", "w") as f:
        f.write("\n".join(str(0.5 + i % 3) for i in range(300)))
    cache = str(tmp_path / "cachefile")
    first = xt.DMatrix(f"{src}#{cache}")
    assert os.path.exists(cache + ".npz")
    np.testing.assert_array_equal(first.info.weight[:3], [0.5, 1.5, 2.5])
    _same_matrix(first, xj.DMatrix(f"{src}#{str(tmp_path / 'jcache')}"))
    os.remove(src)   # the second load reads the cache only
    _same_matrix(first, xt.DMatrix(f"{src}#{cache}"))


def test_stdin_data_loading(monkeypatch):
    text = b"1 0:0.5 2:1.0\n0 1:0.25\n1 0:0.9\n"
    monkeypatch.setattr(sys, "stdin",
                        type("S", (), {"buffer": io.BytesIO(text)})())
    d = xt.DMatrix("stdin")
    assert d.num_row == 3 and d.num_col == 3
    np.testing.assert_array_equal(d.get_label(), [1, 0, 1])
    np.testing.assert_array_equal(d.indptr, [0, 2, 3, 4])


def test_cli_trains_from_a_buffer_as_from_text(svm, tmp_path):
    text_model, _ = port_train(tmp_path, svm, "text", variant="nan")
    buf = str(tmp_path / "train.buffer")
    xt.DMatrix(svm["nan"]["train"]).save_binary(buf)
    buf_model, _ = port_train(tmp_path, svm, "buf", variant="nan",
                              extra=[f"data={buf}"])
    assert_states_equal(tree_state(text_model), tree_state(buf_model))


# ------------------------------------------------------ pipeline, lanes
def test_task_pipeline_matches_the_jax_cli(tmp_path):
    rng = np.random.RandomState(11)
    for c in range(2):
        X = rng.rand(300, 6).astype(np.float32)
        write_libsvm(tmp_path / f"train-{c}.svm", X,
                     X[:, 0] + 0.5 * X[:, 1] ** 2)
    Xh = rng.rand(200, 6).astype(np.float32)
    write_libsvm(tmp_path / "hold.svm", Xh, Xh[:, 0] + 0.5 * Xh[:, 1] ** 2)
    conf = write_conf(tmp_path / "p.conf", task="pipeline",
                      objective="reg:linear", max_depth="3", eta="0.4",
                      silent="1", pipeline_publish_path="pub.model",
                      pipeline_dir="work", pipeline_rounds_per_cycle="2",
                      pipeline_cycles="2",
                      pipeline_data=str(tmp_path / "train-{cycle}.svm"),
                      pipeline_holdout=str(tmp_path / "hold.svm"),
                      pipeline_max_regression="0.5")
    done = []
    for tag, main, extra in (("j", jax_main, []),
                             ("t", port_main, ["device=cpu"])):
        wd = tmp_path / tag
        wd.mkdir()
        rc, _, err = run_cli(main, [conf] + extra, wd)
        assert rc == 0, err
        done.append([line for line in err.splitlines()
                     if line.startswith("[pipeline] done")])
    assert done[0] == done[1] and len(done[0]) == 1
    sj = tree_state(str(tmp_path / "j" / "pub.model"))
    st = tree_state(str(tmp_path / "t" / "pub.model"))
    for k in ("tree_feature", "tree_is_leaf", "cut_values", "cut_n"):
        np.testing.assert_array_equal(sj[k], st[k], err_msg=k)
    split = sj["tree_feature"] >= 0
    for k in ("tree_cut_index", "tree_threshold", "tree_default_left"):
        np.testing.assert_array_equal(sj[k][split], st[k][split], err_msg=k)
    np.testing.assert_allclose(st["tree_leaf_value"], sj["tree_leaf_value"],
                               rtol=1e-5, atol=1e-7)


def _gate_verdicts(path):
    out = {}
    with open(path) as f:
        for line in f:
            e = json.loads(line)
            if e.get("kind") == "event" and e.get("name") == "pipeline.gate":
                a = e["attrs"]
                out[(a["lane"], a["cycle"])] = (a["passed"], a["metric"],
                                                a["candidate"],
                                                a["incumbent"])
    return out


def test_task_lanes_matches_run_tenant_lanes(tmp_path):
    from xgboost_tpu_torch.obs import configure_log
    from xgboost_tpu_torch.pipeline import run_tenant_lanes
    names = [f"t{i}" for i in range(4)]
    for i, n in enumerate(names):
        rng = np.random.RandomState(40 + i)
        for part, rows in (("train", 256), ("hold", 128)):
            X = rng.rand(rows, 4).astype(np.float32)
            y = ((X[:, 0] + 0.25 * X[:, 1]) > 0.6).astype(np.float32)
            xt.DMatrix(X, label=y).save_binary(
                str(tmp_path / f"{n}-{part}.buffer"))
    knobs = {"objective": "binary:logistic", "max_depth": "2", "eta": "0.3"}
    manifest = ",".join(f"{n}={tmp_path / 'cli' / n / 'model.bin'}"
                        for n in names)
    conf = write_conf(tmp_path / "l.conf", task="lanes", silent="1",
                      lanes=manifest, lanes_dir=str(tmp_path / "cli"),
                      lane_data=str(tmp_path / "{lane}-train.buffer"),
                      lane_holdout=str(tmp_path / "{lane}-hold.buffer"),
                      lane_rounds_per_cycle="3", lane_cycles="2",
                      lane_stack="1", lane_window_ms="5000",
                      pipeline_metric="auc", pipeline_max_regression="0.5",
                      obs_log=str(tmp_path / "cli.jsonl"), **knobs)
    try:
        rc, _, err = run_cli(port_main, [conf, "device=cpu"], tmp_path)
    finally:
        configure_log(None)
    assert rc == 0, err
    lanes = {n: dict(publish_path=str(tmp_path / "api" / n / "model.bin"),
                     workdir=str(tmp_path / "api" / n),
                     data=str(tmp_path / f"{n}-train.buffer"),
                     holdout=str(tmp_path / f"{n}-hold.buffer"),
                     rounds_per_cycle=3, cycles=2, metric="auc",
                     max_regression=0.5, params=dict(knobs, seed="0"))
             for n in names}
    configure_log(str(tmp_path / "api.jsonl"))
    try:
        res = run_tenant_lanes(lanes, quiet=True, stacked=True,
                               window_sec=5.0, device="cpu")
    finally:
        configure_log(None)
    assert all(r["status"] == "ok" for r in res.values()), res
    vc = _gate_verdicts(tmp_path / "cli.jsonl")
    assert vc == _gate_verdicts(tmp_path / "api.jsonl") and len(vc) == 8
    for n in names:
        cli_model = str(tmp_path / "cli" / n / "model.bin")
        assert os.path.exists(cli_model), n
        assert_states_equal(tree_state(cli_model),
                            tree_state(lanes[n]["publish_path"]))


# ------------------------------------------------ what is not ported
@pytest.mark.parametrize("arg,item", [("task=stream", 15)])
def test_unported_names_raise_with_their_item(svm, tmp_path, arg, item):
    d = svm["dense"]
    conf = write_conf(tmp_path / "u.conf", **base_conf(d["train"], d["test"]))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        run_cli(port_main, [conf, "device=cpu", arg], tmp_path)


@pytest.mark.parametrize("arg", ["dsplit=col", "updater=distcol"])
def test_column_split_names_train(svm, tmp_path, arg):
    """``dsplit=col`` and ``updater=distcol`` (item 13b, ported): a world
    of one trains and writes its model."""
    d = svm["dense"]
    conf = write_conf(tmp_path / "c.conf", **base_conf(d["train"], d["test"]))
    rc, _, _ = run_cli(port_main, [conf, "device=cpu", arg,
                                   f"model_out={tmp_path / 'c.model'}"],
                       tmp_path)
    assert rc == 0 and os.path.exists(tmp_path / "c.model")


def test_fleet_router_placer_and_metrics_port_run(svm, tmp_path):
    """The names this slice ported: ``task=fleet_router`` answers on its
    bound port, ``task=placer`` takes the router's placer lease, and
    ``metrics_port=0`` serves /metrics while ``task=train`` runs."""
    import re
    import time
    import urllib.request
    env = dict(os.environ, PYTHONPATH=REPO)
    router = subprocess.Popen(
        [sys.executable, "-m", "xgboost_tpu_torch", "task=fleet_router",
         "fleet_port=0", "fleet_hc_sec=0"],
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(tmp_path))
    procs = [router]
    try:
        banner = router.stderr.readline()
        base = re.search(r"http://[0-9.]+:\d+", banner).group(0)
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.load(r)
        assert health["role"] == "fleet_router"
        placer = subprocess.Popen(
            [sys.executable, "-m", "xgboost_tpu_torch", "task=placer",
             f"placer_router_url={base}", "placer_catalog=a=m.bin",
             "placer_id=cli", "placer_tick_sec=0.2", "silent=2"],
            stderr=subprocess.DEVNULL, env=env, cwd=str(tmp_path))
        procs.append(placer)
        deadline = time.perf_counter() + 60.0
        holder = None
        while holder != "cli" and time.perf_counter() < deadline:
            time.sleep(0.2)
            with urllib.request.urlopen(base + "/placer/status",
                                        timeout=10) as r:
                holder = json.load(r)["holder"]
        assert holder == "cli"
    finally:
        for p in procs:
            p.terminate()
            p.wait(30)
    d = svm["dense"]
    conf = write_conf(tmp_path / "m.conf",
                      **base_conf(d["train"], d["test"], silent="0"))
    from xgboost_tpu_torch.obs import (get_metrics_server,
                                       stop_metrics_server)
    try:
        rc, _, err = run_cli(port_main, [conf, "device=cpu",
                                         "metrics_port=0"], tmp_path)
        srv = get_metrics_server()
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/metrics", timeout=10) as r:
            text = r.read().decode()
    finally:
        stop_metrics_server()
    assert rc == 0
    assert f"training metrics on http://{srv.host}:{srv.port}" in err
    assert "# TYPE xgbtpu_training_rounds_total counter" in text


def test_cli_defaults_to_the_gpu(svm, tmp_path):
    """No device=: cuda, which raises without a GPU (nothing runs on the
    CPU unasked)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    d = svm["dense"]
    conf = write_conf(tmp_path / "g.conf", **base_conf(d["train"], d["test"]))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        run_cli(port_main, [conf], tmp_path)


def test_entry_point_prints_the_usage():
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.run([sys.executable, "-m", "xgboost_tpu_torch"],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith(
        "Usage: python -m xgboost_tpu_torch <config> [name=value ...]")
    for task in ("train", "pred", "eval", "dump", "serve", "fleet_router",
                 "pipeline", "lanes", "stream", "placer"):
        assert f"\n  {task}" in p.stdout, task
    assert "pipeline_publish_path" in p.stdout and "lane_stack" in p.stdout


# ------------------------------------- depth 8, from one shared model file
def test_depth8_continuation_from_a_shared_model_file(tmp_path):
    """ROADMAP.md section 3: the JAX CLI trains 3 rounds at depth 8;
    both CLIs continue one round from that file.  The new round's
    structure is bitwise, its leaf values within rtol 1e-5."""
    rng = np.random.RandomState(5)
    X = rng.randn(3000, 6).astype(np.float32)
    X[rng.rand(3000, 6) < 0.15] = np.nan
    Z = np.nan_to_num(X)
    y = (2 * Z[:, 0] + Z[:, 1] ** 2 - Z[:, 2] * Z[:, 3]
         + 0.1 * rng.randn(3000)).astype(np.float32)
    data = str(tmp_path / "d8.svm")
    write_libsvm(data, X, y, fmt="{:.9g}")
    conf = write_conf(tmp_path / "d8.conf", task="train",
                      objective="reg:linear", max_depth="8", eta="0.3",
                      max_bin="32", hist_precision="fp32", data=data,
                      num_round="3", model_out=str(tmp_path / "base.model"),
                      silent="1")
    assert run_cli(jax_main, [conf], tmp_path)[0] == 0
    outs = []
    for tag, main, extra in (("j", jax_main, []),
                             ("t", port_main, ["device=cpu"])):
        out = str(tmp_path / f"{tag}4.model")
        rc, _, err = run_cli(main, [conf, "num_round=1",
                                    f"model_in={tmp_path / 'base.model'}",
                                    f"model_out={out}"] + extra, tmp_path)
        assert rc == 0, err
        outs.append(tree_state(out))
    sj, st = outs
    assert sj["tree_feature"].shape[0] == st["tree_feature"].shape[0] == 4
    for k in ("tree_feature", "tree_is_leaf", "tree_group_arr",
              "cut_values", "cut_n"):
        np.testing.assert_array_equal(sj[k], st[k], err_msg=k)
    split = sj["tree_feature"] >= 0
    for k in ("tree_cut_index", "tree_threshold", "tree_default_left"):
        np.testing.assert_array_equal(sj[k][split], st[k][split], err_msg=k)
    # the three shared trees are the file's, bit for bit
    for k in ("tree_leaf_value", "tree_gain", "tree_sum_hess"):
        np.testing.assert_array_equal(sj[k][:3], st[k][:3], err_msg=k)
    assert int((sj["tree_feature"][3] >= 0).sum()) > 50
    np.testing.assert_allclose(st["tree_leaf_value"][3],
                               sj["tree_leaf_value"][3], rtol=1e-5,
                               atol=1e-7)
