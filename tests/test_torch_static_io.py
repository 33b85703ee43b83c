"""Export and serving: ``static.save_inference_model`` /
``load_inference_model``, ``jit.save`` / ``jit.load``, the inference
``Predictor`` and ``paddle.save`` / ``load``, against the JAX package on
the CPU.

Each case gives both packages the same weights, exports in both, and
holds the port's Predictor outputs against the reference Predictor's and
against the port's eager forward: f32 within 1e-5 (a small MLP: the
same f32 arithmetic) or, for BERT, 1e-4 (two encoder layers of matmuls
summed in other orders, logits of order 1).  The reference's cases are
``tests/test_static.py:120`` (handles), ``:176`` (jit.save), ``:190``
(a None batch at 1, 3 and 16) and ``:279`` (the BERT round trip).  The
port's own format: both files load with ``torch.load(weights_only=True)``
and hold no callable; an op the registry cannot name raises at save.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as jjit
import paddle_tpu.nn as jnn
from paddle_tpu import inference as jinference
from paddle_tpu import static as jstatic
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch as pt
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.framework import op_registry
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn import Linear, ReLU, Sequential
from _torch_threads import _one_thread  # noqa: F401

MLP_TOL = 1e-5
BERT_TOL = 1e-4


def _arrays(layer):
    return {k: np.asarray(v._value) for k, v in layer.state_dict().items()}


def _mlp_pair(seed):
    paddle.seed(seed)
    jm = jnn.Sequential(jnn.Linear(4, 8), jnn.ReLU(), jnn.Linear(8, 2))
    tm = Sequential(Linear(4, 8, device="cpu"), ReLU(), Linear(8, 2, device="cpu"))
    load_jax_state_dict(tm, _arrays(jm))
    return jm.eval() or jm, tm.eval()


def _eager(tm, x):
    with torch.no_grad():
        return tm(torch.from_numpy(x)).numpy()


def test_save_load_inference_model_and_handles(tmp_path):
    paddle.seed(3)
    jl = jnn.Linear(3, 2)
    tl = Linear(3, 2, device="cpu")
    load_jax_state_dict(tl, _arrays(jl))
    jmain, tmain = jstatic.Program(), tstatic.Program()
    with jstatic.program_guard(jmain):
        jx = jstatic.data("x", [2, 3], "float32")
        jout = paddle.tanh(jl(jx))
    with tstatic.program_guard(tmain):
        tx = tstatic.data("x", [2, 3], "float32")
        tout = torch.tanh(tl(tx))
    jstatic.save_inference_model(str(tmp_path / "j" / "net"), [jx], [jout], jstatic.Executor(),
                                 program=jmain)
    prefix = str(tmp_path / "t" / "net")
    tstatic.save_inference_model(prefix, [tx], [tout], tstatic.Executor("cpu"), program=tmain)
    for ext in (".pdmodel", ".pdiparams", ".json"):
        assert os.path.exists(prefix + ext)
    jpred, _, _ = jstatic.load_inference_model(str(tmp_path / "j" / "net"))
    pred, feeds, fetches = tstatic.load_inference_model(prefix, tstatic.Executor("cpu"))
    assert feeds == ["x"] and pred.place == torch.device("cpu")
    xv = np.random.default_rng(5).standard_normal((2, 3)).astype(np.float32)
    (want,) = jpred.run([xv])
    (got,) = pred.run([xv])
    np.testing.assert_allclose(got, want, atol=MLP_TOL, rtol=MLP_TOL)
    with torch.no_grad():
        np.testing.assert_allclose(got, torch.tanh(tl(torch.from_numpy(xv))).numpy(),
                                   atol=MLP_TOL, rtol=MLP_TOL)
    h = pred.get_input_handle("x")
    h.reshape([2, 3])
    h.copy_from_cpu(xv)
    pred.run()
    np.testing.assert_array_equal(pred.get_output_handle(fetches[0]).copy_to_cpu(), got)


def test_jit_save_load_matches_reference_predictor(tmp_path):
    jm, tm = _mlp_pair(7)
    spec = [([2, 4], "float32", "inp")]
    jjit.save(jm, str(tmp_path / "j"), input_spec=[jstatic.InputSpec(*s) for s in spec])
    pt.jit.save(tm, str(tmp_path / "t"), input_spec=[tstatic.InputSpec(*s) for s in spec])
    jpred = jjit.load(str(tmp_path / "j"))
    pred = pt.jit.load(str(tmp_path / "t"), device="cpu")
    assert isinstance(pred, pt.jit.TranslatedLayer)
    xv = np.random.default_rng(11).standard_normal((2, 4)).astype(np.float32)
    (got,), (want,) = pred.run([xv]), jpred.run([xv])
    np.testing.assert_allclose(got, want, atol=MLP_TOL, rtol=MLP_TOL)
    np.testing.assert_allclose(got, _eager(tm, xv), atol=MLP_TOL, rtol=MLP_TOL)
    pt.jit.save(tm, str(tmp_path / "state_only"))  # no input_spec: the state payload alone
    state = pt.jit.load(str(tmp_path / "state_only"))
    assert state["class"] == "Sequential" and "0.weight" in state["state_dict"]


def test_jit_save_dynamic_batch(tmp_path):
    paddle.seed(9)
    jl = jnn.Linear(4, 2)
    tl = Linear(4, 2, device="cpu")
    load_jax_state_dict(tl, _arrays(jl))
    jjit.save(jl, str(tmp_path / "j"), input_spec=[jstatic.InputSpec([None, 4], "float32", "x")])
    pt.jit.save(tl, str(tmp_path / "t"), input_spec=[tstatic.InputSpec([None, 4], "float32", "x")])
    jpred, pred = jjit.load(str(tmp_path / "j")), pt.jit.load(str(tmp_path / "t"), device="cpu")
    assert pred.manifest["feed"][0]["shape"] == [None, 4]
    for bs in (1, 3, 16):
        xv = np.random.default_rng(bs).standard_normal((bs, 4)).astype(np.float32)
        (got,), (want,) = pred.run([xv]), jpred.run([xv])
        assert got.shape == (bs, 2)
        np.testing.assert_allclose(got, want, atol=MLP_TOL, rtol=MLP_TOL)
        np.testing.assert_allclose(got, _eager(tl, xv), atol=MLP_TOL, rtol=MLP_TOL)
    assert sorted(pred._programs) == [1, 3, 16]  # one program (and one recording) a batch size


@pytest.fixture(scope="module")
def bert_pair():
    paddle.seed(0)
    jm = jbert.BertForSequenceClassification(jbert.bert_tiny(), num_classes=2)
    jm.eval()
    tm = tbert.BertForSequenceClassification(tbert.bert_tiny(), num_classes=2, device="cpu")
    load_jax_state_dict(tm, _arrays(jm))
    return jm, tm.eval()


def test_bert_jit_save_predictor_roundtrip(tmp_path, bert_pair):
    """The reference's serving round trip: jit.save a BERT classifier,
    create_predictor, the handle API; the port's Predictor against the
    reference's and the port's eager logits.  The port's artifact leaves
    the batch None, so it also serves batch 5 (the reference's is fixed
    at 2 x 16)."""
    jm, tm = bert_pair
    ids = np.random.default_rng(0).integers(1, 1000, (2, 16)).astype(np.int32)
    ids[1, 9:] = 0
    jjit.save(jm, str(tmp_path / "j"), input_spec=[jstatic.InputSpec([2, 16], "int32", "ids")])
    pt.jit.save(tm, str(tmp_path / "t"), input_spec=[tstatic.InputSpec([None, 16], "int32", "ids")])
    jpred = jinference.create_predictor(jinference.Config(str(tmp_path / "j.pdmodel")))
    cfg = tinference.Config(str(tmp_path / "t.pdmodel"), str(tmp_path / "t.pdiparams"))
    cfg.disable_gpu()
    pred = tinference.create_predictor(cfg)
    outs = []
    for p in (jpred, pred):
        p.get_input_handle(p.get_input_names()[0]).copy_from_cpu(ids)
        p.run()
        outs.append(p.get_output_handle(p.get_output_names()[0]).copy_to_cpu())
    want, got = outs
    np.testing.assert_allclose(got, want, atol=BERT_TOL, rtol=BERT_TOL)
    np.testing.assert_allclose(got, _eager(tm, ids), atol=BERT_TOL, rtol=BERT_TOL)
    ids5 = np.random.default_rng(1).integers(1, 1000, (5, 16)).astype(np.int32)
    (got5,) = pred.run([ids5])
    np.testing.assert_allclose(got5, _eager(tm, ids5), atol=BERT_TOL, rtol=BERT_TOL)
    # the Predictor's Executor ran the fusion pass on the loaded program
    types = [op.type for op in pred._programs[2][0].global_block().ops]
    assert types.count("add_layer_norm") == 5 and types.count("matmul_epilogue") == 2


def test_artifact_is_data_and_loads_weights_only(tmp_path, bert_pair):
    _, tm = bert_pair
    prefix = str(tmp_path / "b")
    pt.jit.save(tm, prefix, input_spec=[tstatic.InputSpec([None, 16], "int32", "ids")])
    model = torch.load(prefix + ".pdmodel", weights_only=True)
    params = torch.load(prefix + ".pdiparams", weights_only=True)
    assert set(model) == {"format", "program", "consts"}
    desc = json.loads(model["program"])  # the op list is plain data
    assert {op["type"] for op in desc["ops"]} >= {"linear", "layer_norm", "embedding",
                                                 "scaled_dot_product_attention", "gelu"}
    assert all(isinstance(t, torch.Tensor) for t in list(params.values())
               + list(model["consts"].values()))
    assert sorted(params) == sorted(n for n, _ in tm.named_parameters())
    manifest = json.load(open(prefix + ".json"))
    assert manifest["feed"] == [{"name": "ids", "shape": [None, 16], "dtype": "int32"}]
    blob = tstatic.serialize_program(*_captured(tm))
    prog, feeds, fetches = tstatic.deserialize_program(blob, params, "cpu")
    ids = np.ones((2, 16), np.int32)
    (got,) = tstatic.Executor("cpu").run(prog, feed={"ids": ids}, fetch_list=fetches)
    np.testing.assert_allclose(got, _eager(tm, ids), atol=BERT_TOL, rtol=BERT_TOL)


def _tamper_linear(desc):
    next(d for d in desc["ops"] if "call" in d["impl"])["impl"]["call"] = \
        "paddle_tpu_torch.static.io:os.system"


def _tamper_package_function(desc):  # a function of the package that records no op
    next(d for d in desc["ops"] if "call" in d["impl"])["impl"]["call"] = \
        "paddle_tpu_torch.framework.io_utils:save"


def _tamper_torch_call(desc):
    next(d for d in desc["ops"] if "torch_call" in d["impl"])["impl"]["torch_call"] = \
        "torch.save"


def _tamper_type(desc):
    desc["ops"][0]["type"] = "no_such_op"


def _tamper_dtype(desc):
    desc["vars"][0][1] = "save"


@pytest.mark.parametrize("tamper", [_tamper_linear, _tamper_package_function,
                                    _tamper_torch_call, _tamper_type, _tamper_dtype])
def test_hostile_artifact_raises_at_load(tmp_path, monkeypatch, tamper):
    """A name in the artifact binds only through the registry's closed
    tables: an artifact naming any other callable (``os`` reached through a
    module of the package, a package function that records no op,
    ``torch.save``), an unknown op type or a non-dtype raises in
    ``create_predictor`` and in ``deserialize_program``, and nothing runs."""
    called = []
    monkeypatch.setattr(os, "system", lambda *a: called.append(a) or 0)
    lin = Linear(3, 2, device="cpu")
    main = tstatic.Program()
    with tstatic.program_guard(main):
        x = tstatic.data("x", [2, 3], "float32")
        out = torch.tanh(lin(x))
    prefix = str(tmp_path / "net")
    tstatic.save_inference_model(prefix, [x], [out], tstatic.Executor("cpu"), program=main)
    model = torch.load(prefix + ".pdmodel", weights_only=True)
    desc = json.loads(model["program"])
    tamper(desc)
    model["program"] = json.dumps(desc)
    torch.save(model, prefix + ".pdmodel")
    config = tinference.Config(prefix)
    config.disable_gpu()
    config.enable_warmup()
    with pytest.raises(ValueError):
        tinference.create_predictor(config)
    params = torch.load(prefix + ".pdiparams", weights_only=True)
    with open(prefix + ".pdmodel", "rb") as fh, pytest.raises(ValueError):
        tstatic.deserialize_program(fh.read(), params, "cpu")
    assert called == []


def _captured(tm):
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        ids = tstatic.data("ids", [2, 16], "int32")
        out = tm(ids)
    for name, p in tm.named_parameters():
        prog.param_vars[id(p)]._name = name
    return prog, [ids], [out]


def test_unnameable_ops_raise_at_save(tmp_path):
    prog = tstatic.Program()
    lin = Linear(4, 4, device="cpu")
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [2, 4], "float32")
        y = torch.nn.functional.gelu(lin(x))
    op = prog.global_block().ops[-1]
    saved_type = op.type
    op.type = "my_custom_op"
    with pytest.raises(op_registry.NotDescribable, match="my_custom_op"):
        tstatic.save_inference_model(str(tmp_path / "a"), [x], [y], program=prog)
    op.type = saved_type
    op.impl = lambda v: v  # a closure: the registry cannot bind it
    with pytest.raises(op_registry.NotDescribable, match=saved_type):
        tstatic.save_inference_model(str(tmp_path / "b"), [x], [y], program=prog)
    op.impl = torch.nn.functional.gelu
    # dead-code elimination runs on the exported clone; the fusion pass's
    # kernels are closures, so exporting them raises naming the fused op
    prefix = str(tmp_path / "c")
    tstatic.save_inference_model(prefix, [x], [y], program=prog, passes=["dead_code_elimination"])
    assert json.load(open(prefix + ".json"))["passes"] == ["dead_code_elimination"]
    with pytest.raises(op_registry.NotDescribable, match="matmul_epilogue"):
        tstatic.save_inference_model(str(tmp_path / "d"), [x], [y], program=prog,
                                     passes=["pallas_fusion"])
    for kw, item in (({"precision": "bfloat16"}, "A.5.6"),
                     ({"extra_precisions": ["int8"]}, "A.6")):
        with pytest.raises(NotImplementedError, match=item):
            tstatic.save_inference_model(str(tmp_path / "e"), [x], [y], program=prog, **kw)
    pred = tinference.create_predictor(tinference.Config(prefix).disable_gpu())
    (got,) = pred.run([np.ones((2, 4), np.float32)])
    with torch.no_grad():
        np.testing.assert_allclose(got, torch.nn.functional.gelu(lin(torch.ones(2, 4))).numpy(),
                                   atol=MLP_TOL)


def test_export_verify_mode_and_config_switches(tmp_path):
    jm, tm = _mlp_pair(12)
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [None, 4], "float32")
        y = tm(x)
    from paddle_tpu_torch.static import verify

    pt.set_flags({"FLAGS_verify_programs": True})
    try:
        base = verify.verify_stats()
        tstatic.save_inference_model(str(tmp_path / "v"), [x], [y], program=prog,
                                     passes=["dead_code_elimination"])
        stats = verify.verify_stats()
    finally:
        pt.set_flags({"FLAGS_verify_programs": False})
    assert stats["programs_verified"] > base["programs_verified"]
    assert stats["differential_checks"] == base["differential_checks"] + 1
    cfg = tinference.Config(str(tmp_path / "v.pdmodel"))
    cfg.disable_gpu()
    cfg.enable_profile()
    cfg.enable_warmup()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg.enable_memory_optim()
        cfg.switch_ir_optim(False)
        cfg.enable_mkldnn()
    assert len(caught) == 3 and all(w.category is RuntimeWarning for w in caught)
    with pytest.raises(NotImplementedError, match="A.6"):
        cfg.enable_tensor_parallel(None)
    with pytest.raises(NotImplementedError, match="A.5.6"):
        cfg.set_precision("bfloat16")
    pred = tinference.create_predictor(cfg)
    assert pred.profile_stats()["count"] == 0  # the warm-up run is not counted
    xv = np.random.default_rng(3).standard_normal((3, 4)).astype(np.float32)
    twin = pred.clone()
    (a,), (b,) = pred.run([xv]), twin([xv])
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, _eager(tm, xv), atol=MLP_TOL, rtol=MLP_TOL)
    assert pred.profile_stats()["count"] == 1 and twin.profile_stats()["count"] == 1


def test_static_state_and_paddle_save_load(tmp_path):
    """static.save / load of a trained program's state into a fresh scope
    (in place where the scope holds a tensor), and paddle.save / load of a
    state dict with the reference's nesting."""
    lin = Linear(3, 1, device="cpu")
    opt = pt.optimizer.Adam(0.1, parameters=lin.parameters())
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [8, 3], "float32")
        loss = torch.mean(lin(x) ** 2)
        opt.minimize(loss)
    exe = tstatic.Executor("cpu")
    feed = {"x": np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)}
    with tstatic.scope_guard(tstatic.Scope()):
        for _ in range(3):
            exe.run(prog, feed=feed, fetch_list=[loss])
        trained = {k: v.clone() for k, v in exe.state_dict(prog).items()}
        tstatic.save(prog, str(tmp_path / "st"))
    with tstatic.scope_guard(tstatic.Scope()):
        exe.run(prog, feed=feed, fetch_list=[loss])  # the scope now holds its own copies
        held = exe.state_dict(prog)["param_0"]
        tstatic.load(prog, str(tmp_path / "st"))
        loaded = exe.state_dict(prog)
        assert loaded["param_0"] is held  # written in place
        for k, v in trained.items():
            assert torch.equal(loaded[k], v), k
    state = {"w": torch.arange(6.0).reshape(2, 3), "nested": {"n": [torch.ones(2), 3]}, "s": "x"}
    pt.save(state, str(tmp_path / "sd" / "m.pdparams"))
    back = pt.load(str(tmp_path / "sd" / "m.pdparams"))
    assert torch.equal(back["w"], state["w"]) and back["nested"]["n"][1] == 3
    assert pt.load(str(tmp_path / "sd" / "m.pdparams"), return_numpy=True)["w"].shape == (2, 3)
    assert os.listdir(tmp_path / "sd") == ["m.pdparams"]  # the temporary file was renamed
