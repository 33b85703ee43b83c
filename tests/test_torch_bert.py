"""The port's BERT family against the JAX package's, on the CPU, in f32.

Both models hold the same weights: the JAX model is built from a seed and
its ``state_dict`` is carried into the port by
``paddle_tpu_torch.convert.load_jax_state_dict`` (the keys are the same).
The static path captures ``BertForSequenceClassification(bert_tiny())``
in both packages: the same fused op counts after ``PallasFusionPass`` (5
``add_layer_norm``, 2 ``matmul_epilogue``), the JAX Executor running its
Pallas kernels in interpret mode, the port's its plain versions.
Tolerance: f32 logits within 1e-4 absolute and relative (two encoder
layers of matmuls summed in other orders; logits are of order 1).
"""

import collections

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import static as jstatic
from paddle_tpu.models import bert as jbert
from paddle_tpu.nn.layer import transformer as jtransformer

from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn import TransformerEncoderLayer

TOL = 1e-4


def _jax_arrays(model):
    return {k: np.asarray(v._value) for k, v in model.state_dict().items()}


def _pair(jax_cls, torch_cls, seed, **kw):
    paddle.seed(seed)
    jm = jax_cls(jbert.bert_tiny(), **kw)
    jm.eval()
    tm = torch_cls(tbert.bert_tiny(), **kw, device="cpu")
    load_jax_state_dict(tm, _jax_arrays(jm))
    return jm, tm.eval()


@pytest.fixture(scope="module")
def classifier():
    return _pair(jbert.BertForSequenceClassification, tbert.BertForSequenceClassification, 3,
                 num_classes=2)


def _ids(seed, b=2, s=16, lengths=(16, 9)):
    """Token ids with pad id 0 after each sequence's length (ragged)."""
    ids = np.random.default_rng(seed).integers(1, 1024, (b, s)).astype(np.int32)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids


def test_state_dict_keys_equal_jax_and_load_carries_the_weights(classifier):
    jm, tm = classifier
    assert list(tm.state_dict()) == list(jm.state_dict())
    assert "bert.encoder.layers.0.self_attn.q_proj.bias" in tm.state_dict()
    arrays = _jax_arrays(jm)
    for key, t in tm.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), arrays[key])


def test_eager_classifier_matches_jax(classifier):
    jm, tm = classifier
    ids = _ids(0)
    want = np.asarray(jm(paddle.to_tensor(ids))._value)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids)).numpy()
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_eager_classifier_loss_matches_jax(classifier):
    jm, tm = classifier
    ids, labels = _ids(1), np.array([0, 1], np.int64)
    want, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    with torch.no_grad():
        got, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(np.asarray(want._value)), atol=TOL, rtol=TOL)


def test_eager_masked_lm_matches_jax():
    jm, tm = _pair(jbert.BertForMaskedLM, tbert.BertForMaskedLM, 4)
    ids = _ids(2)
    labels = np.where(ids > 0, ids, -100).astype(np.int64)
    jloss, jlogits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    with torch.no_grad():
        tloss, tlogits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert tlogits.shape == (2, 16, 1024)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits._value), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(tloss), float(np.asarray(jloss._value)), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("normalize_before", [False, True])
def test_encoder_layer_matches_jax(normalize_before):
    paddle.seed(5)
    jl = jtransformer.TransformerEncoderLayer(64, 4, 128, activation="gelu",
                                              normalize_before=normalize_before)
    jl.eval()
    tl = TransformerEncoderLayer(64, 4, 128, activation="gelu",
                                 normalize_before=normalize_before, device="cpu").eval()
    load_jax_state_dict(tl, _jax_arrays(jl))
    x = np.random.default_rng(6).standard_normal((2, 10, 64)).astype(np.float32)
    mask = np.zeros((2, 1, 1, 10), np.float32)
    mask[1, ..., 7:] = -1e4
    want = np.asarray(jl(paddle.to_tensor(x), paddle.to_tensor(mask))._value)
    with torch.no_grad():
        got = tl(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _capture_jax(model, shape):
    main = jstatic.Program()
    with jstatic.program_guard(main):
        out = model(jstatic.data("ids", list(shape), "int32"))
    return main, out


def _capture_port(model, shape):
    main = tstatic.Program()
    with tstatic.program_guard(main):
        out = model(tstatic.data("ids", list(shape), "int32"))
    return main, out


def test_static_bert_tiny_matches_jax(classifier):
    """The static path at bert_tiny: both Executors run their default
    pass pipelines; the fused op counts and the logits agree."""
    jm, tm = classifier
    ids = _ids(3)
    jmain, jout = _capture_jax(jm, ids.shape)
    tmain, tout = _capture_port(tm, ids.shape)
    assert len(tmain.param_inits) == len(jmain.param_inits) == 41
    (want,) = jstatic.Executor().run(jmain, feed={"ids": ids}, fetch_list=[jout])
    (got,) = tstatic.Executor("cpu").run(tmain, feed={"ids": ids}, fetch_list=[tout])
    jcount = collections.Counter(op.type for op in jmain.global_block().ops)
    tcount = collections.Counter(op.type for op in tmain.global_block().ops)
    for t, n in (("add_layer_norm", 5), ("matmul_epilogue", 2), ("linear", 14),
                 ("scaled_dot_product_attention", 2), ("embedding", 3)):
        assert tcount[t] == jcount[t] == n, t
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    with torch.no_grad():
        eager = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, eager, atol=TOL, rtol=TOL)


def test_ernie_names_alias_bert():
    assert tbert.ErnieModel is tbert.BertModel
    assert tbert.ErnieForSequenceClassification is tbert.BertForSequenceClassification
    assert tbert.ErnieConfig is tbert.BertConfig


def test_dropout_in_training_raises_naming_the_roadmap():
    tm = tbert.BertForSequenceClassification(tbert.bert_tiny(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue A item 2"):
        tm(torch.ones(1, 4, dtype=torch.int32))
