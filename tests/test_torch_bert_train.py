"""BERT fine-tuned eagerly through the port's ``jit.TrainStep``, against
the JAX package's compiled ``TrainStep``, on the CPU.

The reference's own test (``tests/test_bert.py:18``): ``bert_tiny``,
``BertForSequenceClassification(num_classes=3)``, ``AdamW(5e-4)``, 10
steps on one batch whose last 3 positions are padding.  Both models hold
the same weights (the JAX model's, carried by ``load_jax_state_dict``).
Held with dropout 0 (the two packages draw their masks from different
generators; ``test_torch_static_train.py`` holds the port's masks):

- f32: every loss within 2e-5 of max(|loss|, 1) (the same f32 arithmetic
  summed in other orders), and the trained parameters within 2e-5
  relative L2, but the attention's key biases: their gradient is zero in
  exact arithmetic (a softmax does not move when a row's logits shift
  together), so what each package computes is rounding noise, which
  Adam scales up to full steps;
- O1 bf16 (``amp.auto_cast`` in the loss function): the losses within
  2e-2 of max(|loss|, 1), and the port's parameter moves within twice
  the distance of the reference's O1 run from an f32 run (the port's,
  held above), the rule of ``tests/test_torch_vision.py``.

With dropout 0.1 the port trains on its own: the loss falls, as the
reference's test asks, and two forwards in training draw other masks.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert as tbert
from _torch_threads import _one_thread  # noqa: F401

F32_REL = 2e-5
O1_REL = 2e-2
STEPS = 10
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _batch(vocab, b=4, s=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (b, s)).astype(np.int32)
    ids[:, -3:] = 0  # a padding tail: the attention mask does work
    return ids, np.array([0, 1, 2, 1], np.int64)


def _compared(state):
    return sorted(k for k in state if not k.endswith("k_proj.bias"))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def init():
    paddle.seed(0)
    jm = jbert.BertForSequenceClassification(jbert.bert_tiny(**NO_DROPOUT), num_classes=3)
    return {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _train_ref(init, o1):
    jm = jbert.BertForSequenceClassification(jbert.bert_tiny(**NO_DROPOUT), num_classes=3)
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in init.items()})
    opt = paddle.optimizer.AdamW(5e-4, parameters=jm.parameters())

    def loss_fn(m, i, l):
        if o1:
            with jamp.auto_cast(True, dtype="bfloat16"):
                return m(i, labels=l)[0]
        return m(i, labels=l)[0]

    step = JTrainStep(jm, opt, loss_fn)
    ids, labels = _batch(1024)
    losses = [float(step(paddle.to_tensor(ids), paddle.to_tensor(labels.astype(np.int32))))
              for _ in range(STEPS)]
    return losses, {k: np.asarray(v._value) for k, v in jm.state_dict().items()}


def _train_port(init, o1):
    tm = tbert.BertForSequenceClassification(tbert.bert_tiny(**NO_DROPOUT), num_classes=3,
                                             device="cpu")
    load_jax_state_dict(tm, init)
    opt = topt.AdamW(5e-4, parameters=tm.parameters())

    def loss_fn(m, i, l):
        if o1:
            with tamp.auto_cast(True, dtype="bfloat16"):
                return m(i, labels=l)[0]
        return m(i, labels=l)[0]

    step = TrainStep(tm, opt, loss_fn)
    ids, labels = _batch(1024)
    losses = [float(step(torch.from_numpy(ids), torch.from_numpy(labels))) for _ in range(STEPS)]
    return losses, {k: v.detach().numpy() for k, v in tm.state_dict().items()}


@pytest.fixture(scope="module")
def f32_runs(init):
    return _train_ref(init, False), _train_port(init, False)


def test_trainstep_f32_matches_reference(f32_runs):
    (ref_losses, ref_state), (losses, state) = f32_runs
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= F32_REL * max(abs(b), 1.0), (losses, ref_losses)
    assert losses[-1] < losses[0] * 0.7, losses  # the reference test's own bar
    assert sorted(state) == sorted(ref_state)
    for name in _compared(state):
        assert _rel_l2(state[name], ref_state[name]) <= F32_REL, name


def test_trainstep_o1_matches_reference_by_the_o1_rule(init, f32_runs):
    ref_losses, ref_state = _train_ref(init, True)
    losses, state = _train_port(init, True)
    _, (_, f32_state) = f32_runs
    for a, b in zip(losses, ref_losses):
        assert abs(a - b) <= O1_REL * max(abs(b), 1.0), (losses, ref_losses)
    assert losses[-1] < losses[0] * 0.7, losses

    def moves(s):
        return np.concatenate([(s[k] - init[k]).ravel() for k in _compared(init)])

    assert _rel_l2(moves(state), moves(ref_state)) <= \
        2 * _rel_l2(moves(f32_state), moves(ref_state))


@pytest.mark.parametrize("model,o1", [("classifier", False), ("masked_lm", True)],
                         ids=["classifier_f32", "masked_lm_o1_bf16"])
def test_dropout_training_loss_falls(model, o1):
    """Dropout 0.1 in training: each forward draws fresh masks, and the
    model learns its batch in 10 steps (the classifier in f32, the masked
    LM under O1 bf16)."""
    g = torch.Generator().manual_seed(1)
    ids, labels = _batch(1024)
    ids_t = torch.from_numpy(ids)
    if model == "classifier":
        m = tbert.BertForSequenceClassification(tbert.bert_tiny(), num_classes=3, device="cpu",
                                                generator=g)
        lab = torch.from_numpy(labels)
    else:
        m = tbert.BertForMaskedLM(tbert.bert_tiny(), device="cpu", generator=g)
        lab = torch.from_numpy(np.where(ids > 0, ids, -100).astype(np.int64))
    with torch.no_grad():
        assert not torch.equal(m(ids_t), m(ids_t))  # fresh masks each call

    def loss_fn(mm, i, l):
        with tamp.auto_cast(o1, dtype="bfloat16"):
            return mm(i, labels=l)[0]

    step = TrainStep(m, topt.AdamW(5e-4, parameters=m.parameters()), loss_fn)
    losses = [float(step(ids_t, lab)) for _ in range(STEPS)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] * 0.9, losses
