"""Training through a static Program, and the IR verifier, against the
JAX package on the CPU.

- ``append_backward`` and ``gradients`` (the reference's
  ``tests/test_static.py:49`` and ``:164`` programs): the fetches equal
  the reference Executor's within 2e-5 (f32);
- ``Adam.minimize`` over 20 runs (``:69``): every loss within 2e-5 of
  max(|loss|, 1) of the reference's, the final state by name
  (``Executor.state_dict``) within 2e-5 relative L2, and the live
  parameters untouched; ``clone(for_test=True)`` drops the writes (:107);
- BERT-tiny trained through a Program (``AdamW.minimize``): with dropout
  0, its losses and state within 2e-5 of the eager ``TrainStep``'s (which
  ``test_torch_bert_train.py`` holds to the reference's); with dropout,
  fresh masks each run and the same bits on a replay from one RNG state;
- static dropout's keep rate within 5 standard deviations of 1 - p, and
  its mask the eager ``F.dropout``'s from the same state, bit for bit;
- the verifier: each detection on a hand-built bad program in both
  packages (the same violation codes) and its passing twin, the
  differential checker, the verify-mode Executor and pass manager, and
  every program these paths build verifying with the fusion pipeline on.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import static as jstatic
from paddle_tpu.models import bert as jbert
from paddle_tpu.static import verify as jverify
from paddle_tpu.static.program import Operator as JOperator

import paddle_tpu_torch as pt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.static import verify as tverify
from paddle_tpu_torch.static.program import Operator as TOperator
from _torch_threads import _one_thread  # noqa: F401

F32_TOL = 2e-5
# BERT's trained state against the reference's: its zero-initialised
# biases are Adam's steps alone, and a step carries its gradient's relative
# rounding (~1e-5 for an element), not the 2e-5 of a sum of many
STATE_TOL = 1e-4


def _linear_pair(w, b):
    """A reference and a port Linear holding ``w`` and ``b``."""
    jl = jnn.Linear(*w.shape)
    jl.weight.set_value(w)
    jl.bias.set_value(b)
    tl = Linear(*w.shape, device="cpu")
    with torch.no_grad():
        tl.weight.copy_(torch.from_numpy(w))
        tl.bias.copy_(torch.from_numpy(b))
    return jl, tl


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------- autodiff

def test_append_backward_matches_reference():
    w, b = np.array([[2.0, 0.0], [0.0, 3.0]], np.float32), np.array([0.5, -1.0], np.float32)
    jl, tl = _linear_pair(w, b)
    jmain, tmain = jstatic.Program(), tstatic.Program()
    with jstatic.program_guard(jmain):
        jloss = paddle.sum(jl(jstatic.data("x", [3, 2], "float32")) ** 2)
        jpg = jstatic.append_backward(jloss, parameter_list=[jl.weight, jl.bias])
    with tstatic.program_guard(tmain):
        tloss = torch.sum(tl(tstatic.data("x", [3, 2], "float32")) ** 2)
        tpg = tstatic.append_backward(tloss, parameter_list=[tl.weight, tl.bias])
    xv = np.random.default_rng(0).standard_normal((3, 2)).astype(np.float32)
    want = jstatic.Executor().run(jmain, feed={"x": xv}, fetch_list=[jloss] + [g for _, g in jpg])
    got = tstatic.Executor("cpu").run(tmain, feed={"x": xv},
                                      fetch_list=[tloss] + [g for _, g in tpg])
    for a, e in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(e), atol=F32_TOL, rtol=F32_TOL)
    # the fetch of the loss reads the grad op: the recorded forward is pruned
    exe = tstatic.Executor("cpu")
    assert [op.type for op in exe._prune(tmain, (tloss._vid,))] == ["grad", "share_loss"]


def test_gradients_matches_reference():
    xv = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    jmain, tmain = jstatic.Program(), tstatic.Program()
    with jstatic.program_guard(jmain):
        x = jstatic.data("x", [2, 2], "float32")
        (jg,) = jstatic.gradients([paddle.sum(paddle.tanh(x) * x)], [x])
    with tstatic.program_guard(tmain):
        x = tstatic.data("x", [2, 2], "float32")
        (tg,) = tstatic.gradients([torch.sum(torch.tanh(x) * x)], [x])
    (want,) = jstatic.Executor().run(jmain, feed={"x": xv}, fetch_list=[jg])
    (got,) = tstatic.Executor("cpu").run(tmain, feed={"x": xv}, fetch_list=[tg])
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)


# ------------------------------------------------------------ minimize

def _adam_programs():
    rng = np.random.default_rng(2)
    true_w = rng.standard_normal((4, 1)).astype(np.float32)
    X = rng.standard_normal((64, 4)).astype(np.float32)
    w, b = rng.standard_normal((4, 1)).astype(np.float32), np.zeros(1, np.float32)
    jl, tl = _linear_pair(w, b)
    jopt = paddle.optimizer.Adam(learning_rate=0.1, parameters=jl.parameters())
    popt = topt.Adam(learning_rate=0.1, parameters=tl.parameters())
    jmain, tmain = jstatic.Program(), tstatic.Program()
    with jstatic.program_guard(jmain):
        x, y = jstatic.data("x", [64, 4], "float32"), jstatic.data("y", [64, 1], "float32")
        jloss = paddle.mean((jl(x) - y) ** 2)
        jopt.minimize(jloss)
    with tstatic.program_guard(tmain):
        x, y = tstatic.data("x", [64, 4], "float32"), tstatic.data("y", [64, 1], "float32")
        tpred = tl(x)
        tloss = torch.mean((tpred - y) ** 2)
        popt.minimize(tloss)
    return (jmain, jloss, jl), (tmain, tloss, tl, tpred), {"x": X, "y": X @ true_w}


def test_minimize_adam_20_runs_matches_reference():
    (jmain, jloss, jl), (tmain, tloss, tl, _), feed = _adam_programs()
    w0 = tl.weight.detach().clone()
    jexe, texe = jstatic.Executor(), tstatic.Executor("cpu")
    with jstatic.scope_guard(jstatic.Scope()), tstatic.scope_guard(tstatic.Scope()):
        want = [float(jexe.run(jmain, feed=feed, fetch_list=[jloss])[0]) for _ in range(20)]
        got = [float(texe.run(tmain, feed=feed, fetch_list=[tloss])[0]) for _ in range(20)]
        jstate = {k: np.asarray(v) for k, v in jexe.state_dict(jmain).items()}
        tstate = {k: v.numpy() for k, v in texe.state_dict(tmain).items()}
    for a, b in zip(got, want):
        assert abs(a - b) <= F32_TOL * max(abs(b), 1.0), (got, want)
    assert got[-1] < got[0] * 0.2, got  # the reference test's own bar
    # the same names: param_<i> and opt_<accumulator>_<param index>
    assert sorted(jstate) == sorted(tstate) and len(tstate) == 10, sorted(tstate)
    for name in tstate:
        assert _rel_l2(tstate[name], jstate[name]) <= F32_TOL, name
    assert torch.equal(tl.weight, w0)  # the live parameters are untouched


def test_clone_for_test_drops_writes():
    _, (tmain, tloss, tl, tpred), feed = _adam_programs()
    assert tmain.writes
    test = tmain.clone(for_test=True)
    assert not test.writes and not test.host_syncs
    exe = tstatic.Executor("cpu")
    with tstatic.scope_guard(tstatic.Scope()):
        (p0,) = exe.run(test, feed=feed, fetch_list=[tpred])
        exe.run(tmain, feed=feed, fetch_list=[tloss])  # one training run
        (p1,) = exe.run(test, feed=feed, fetch_list=[tpred])
        (p2,) = exe.run(test, feed=feed, fetch_list=[tpred])
        trained = exe.state_dict(tmain)
    with torch.no_grad():
        np.testing.assert_allclose(p0, tl(torch.from_numpy(feed["x"])).numpy(), atol=F32_TOL)
        want = torch.from_numpy(feed["x"]) @ trained["param_0"] + trained["param_1"]
    # the test clone reads the trained scope and writes nothing
    np.testing.assert_allclose(p1, want.numpy(), atol=F32_TOL)
    np.testing.assert_array_equal(p1, p2)
    assert not np.array_equal(p0, p1)


# ------------------------------------------------------- BERT through a Program

def _bert_program(model, opt, b=4, s=16):
    main = tstatic.Program()
    with tstatic.program_guard(main):
        ids = tstatic.data("ids", [b, s], "int32")
        labels = tstatic.data("labels", [b], "int64")
        loss, _ = model(ids, labels=labels)
        opt.minimize(loss)
    return main, loss


def _bert_batch():
    ids = np.random.default_rng(0).integers(1, 1024, (4, 16)).astype(np.int32)
    ids[:, -3:] = 0
    return {"ids": ids, "labels": np.array([0, 1, 2, 1], np.int64)}


def test_static_bert_training_matches_eager_trainstep():
    """Dropout 0, the same weights: the port's Program of AdamW runs against
    the reference's Program (losses, and the final state by name), and
    against the port's eager TrainStep."""
    no_dropout = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    paddle.seed(3)
    jm = jbert.BertForSequenceClassification(jbert.bert_tiny(**no_dropout), num_classes=3)
    m = tbert.BertForSequenceClassification(tbert.bert_tiny(**no_dropout), num_classes=3,
                                            device="cpu")
    load_jax_state_dict(m, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    init = {k: v.clone() for k, v in m.state_dict().items()}
    main, loss = _bert_program(m, topt.AdamW(5e-4, parameters=m.parameters()))
    jmain = jstatic.Program()
    with jstatic.program_guard(jmain):
        jids = jstatic.data("ids", [4, 16], "int32")
        jlabels = jstatic.data("labels", [4], "int32")
        jloss, _ = jm(jids, labels=jlabels)
        paddle.optimizer.AdamW(5e-4, parameters=jm.parameters()).minimize(jloss)
    feed = _bert_batch()
    jfeed = {"ids": feed["ids"], "labels": feed["labels"].astype(np.int32)}
    exe, jexe = tstatic.Executor("cpu"), jstatic.Executor()
    with tstatic.scope_guard(tstatic.Scope()), jstatic.scope_guard(jstatic.Scope()):
        got = [float(exe.run(main, feed=feed, fetch_list=[loss])[0]) for _ in range(5)]
        ref = [float(jexe.run(jmain, feed=jfeed, fetch_list=[jloss])[0]) for _ in range(5)]
        trained = {k: v.numpy() for k, v in exe.state_dict(main).items()}
        jtrained = {k: np.asarray(v) for k, v in jexe.state_dict(jmain).items()}
    for a, b in zip(got, ref):
        assert abs(a - b) <= F32_TOL * max(abs(b), 1.0), (got, ref)
    assert sorted(trained) == sorted(jtrained)
    names = {id(p): name for name, p in m.named_parameters()}
    by_name = {names[pid]: var.name for pid, var in main.param_vars.items()}
    # the key biases' gradient is zero in exact arithmetic: Adam steps on
    # rounding noise, so neither they nor their moments are compared
    noise = {by_name[n].removeprefix("param_") for n in by_name if n.endswith("k_proj.bias")}
    for name in trained:
        if name.rsplit("_", 1)[-1] not in noise:
            assert _rel_l2(trained[name], jtrained[name]) <= STATE_TOL, name
    for k, v in init.items():
        assert torch.equal(m.state_dict()[k], v), k  # the live model is untouched
    step = TrainStep(m, topt.AdamW(5e-4, parameters=m.parameters()),
                     lambda mm, i, l: mm(i, labels=l)[0])
    want = [float(step(torch.from_numpy(feed["ids"]), torch.from_numpy(feed["labels"])))
            for _ in range(5)]
    for a, b in zip(got, want):
        assert abs(a - b) <= F32_TOL * max(abs(b), 1.0), (got, want)
    for name, p in m.named_parameters():
        if not name.endswith("k_proj.bias"):
            assert _rel_l2(trained[by_name[name]], p.detach()) <= F32_TOL, name


def test_static_bert_dropout_fresh_masks_and_replay():
    g = torch.Generator().manual_seed(4)
    m = tbert.BertForSequenceClassification(tbert.bert_tiny(), num_classes=3, device="cpu",
                                            generator=g)
    main, loss = _bert_program(m, topt.AdamW(0.0, parameters=m.parameters()))
    assert [op.type for op in main.global_block().ops].count("dropout") == 10
    feed = _bert_batch()
    exe = tstatic.Executor("cpu")
    with tstatic.scope_guard(tstatic.Scope()):
        state = pt.get_rng_state()
        first = [float(exe.run(main, feed=feed, fetch_list=[loss])[0]) for _ in range(3)]
        pt.set_rng_state(state)
        again = [float(exe.run(main, feed=feed, fetch_list=[loss])[0]) for _ in range(3)]
    assert len(set(first)) == 3, first  # lr 0: only the masks move the loss
    assert first == again  # the same bits from the same state


def test_static_dropout_keep_rate_and_eager_bits():
    n, p = 20000, 0.3
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x = tstatic.data("x", [n], "float32")
        y = tF.dropout(x, p, training=True)
    ones = np.ones(n, np.float32)
    exe = tstatic.Executor("cpu")
    state = pt.get_rng_state()
    (a,) = exe.run(prog, feed={"x": ones}, fetch_list=[y])
    (b,) = exe.run(prog, feed={"x": ones}, fetch_list=[y])
    pt.set_rng_state(state)
    eager = tF.dropout(torch.ones(n), p, training=True).numpy()
    np.testing.assert_array_equal(a, eager)  # the eager dropout's mask, bit for bit
    assert not np.array_equal(a, b)  # the run advanced the state: fresh masks
    kept = float((a != 0).mean())
    assert abs(kept - (1 - p)) <= 5 * np.sqrt(p * (1 - p) / n), kept
    np.testing.assert_allclose(a[a != 0], 1 / (1 - p), rtol=1e-6)


# ------------------------------------------------------------- the verifier

def _jfeed(prog, name, shape, dtype=np.float32):
    v = prog.new_var(jax.ShapeDtypeStruct(tuple(shape), dtype), name)
    prog.add_feed(v)
    return v


def _tfeed(prog, name, shape, dtype=torch.float32):
    return prog.add_feed(prog.new_var(shape, dtype, name=name))


def _corrupt(kind, prog, y, new_var, op_cls, fn_of, single):
    """Break a one-op program ``y = f(x)`` the way ``kind`` names; returns
    the fetch vids to verify.  ``new_var(shape)``, ``op_cls`` and ``fn_of``
    build package-specific pieces."""
    op = prog.global_block().ops[0]
    if kind == "dangling-vid":
        op.arg_spec[0] = ("var", new_var((2, 3))._vid)
    elif kind == "dangling-fetch":
        return [y._vid, new_var((2, 3))._vid]
    elif kind == "unknown-op-type":
        op.type = "definitely_not_registered"
    elif kind == "shape-mismatch":
        op.fn, op.impl = fn_of("shape"), None
    elif kind == "dtype-mismatch":
        op.fn, op.impl = fn_of("dtype"), None
    elif kind == "arity-mismatch":
        op.fn, op.impl = fn_of("arity"), None
    elif kind == "bad-write":
        prog.writes[y._vid] = 987654321
    elif kind == "duplicate-producer":
        # a two-output op makes y and aux, and an alias re-binds y from
        # another op: with aux fetched the first op stays live, and its y
        # is never read before the re-bind (the Executor-prune invariant)
        aux, u = new_var((2, 3)), new_var((2, 3))
        ops = prog.global_block().ops
        ops[0] = op_cls("grad", fn_of("pair"), list(op.arg_spec), {}, [y._vid, aux._vid],
                        fn_of("pair_tree"))
        ops.append(op_cls("exp", fn_of("same"), list(op.arg_spec), {}, [u._vid], single))
        ops.append(op_cls("share_loss", lambda v: v, [("var", u._vid)], {}, [y._vid], single))
        return [y._vid, aux._vid]
    return [y._vid]


KINDS = ["dangling-vid", "dangling-fetch", "unknown-op-type", "shape-mismatch",
         "dtype-mismatch", "arity-mismatch", "bad-write", "duplicate-producer"]


@pytest.mark.parametrize("kind", KINDS)
def test_verifier_detections_match_reference(kind):
    jprog = jstatic.Program()
    with jstatic.program_guard(jprog):
        jy = paddle.tanh(_jfeed(jprog, "x", (2, 3)))
    tprog = tstatic.Program()
    with tstatic.program_guard(tprog):
        ty = torch.tanh(_tfeed(tprog, "x", (2, 3)))
    assert jverify.ProgramVerifier().verify(jprog, [jy._vid]) == []
    assert tverify.ProgramVerifier().verify(tprog, [ty._vid]) == []  # the passing twin
    jfns = {"shape": lambda v: jnp.zeros((5, 5), jnp.float32),
            "dtype": lambda v: jnp.zeros((2, 3), jnp.int32), "arity": lambda v: (v, v),
            "same": jnp.exp, "pair": lambda v: (jnp.tanh(v), jnp.exp(v)),
            "pair_tree": jax.tree_util.tree_structure((0, 0))}
    tfns = {"shape": lambda v: torch.zeros(5, 5, device=v.device),
            "dtype": lambda v: torch.zeros(2, 3, dtype=torch.int32, device=v.device),
            "arity": lambda v: (v, v), "same": torch.exp,
            "pair": lambda v: (torch.tanh(v), torch.exp(v)),
            "pair_tree": torch.utils._pytree.tree_structure((0, 0))}
    jfetch = _corrupt(kind, jprog, jy,
                      lambda s: jprog.new_var(jax.ShapeDtypeStruct(s, np.float32)),
                      JOperator, jfns.get, jax.tree_util.tree_structure(0))
    tfetch = _corrupt(kind, tprog, ty, lambda s: tprog.new_var(s, torch.float32),
                      TOperator, tfns.get, tprog.global_block().ops[0].out_tree)
    want = {v.code for v in jverify.ProgramVerifier().verify(jprog, jfetch)}
    got = {v.code for v in tverify.ProgramVerifier().verify(tprog, tfetch)}
    assert kind in got and got == want, (got, want)


def test_missing_kwargs_and_registry_namespaces():
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        y = tF.gelu(_tfeed(prog, "x", (4, 4)))
    assert tverify.verify_program(prog, [y._vid]) == []
    prog.global_block().ops[0].kwargs.pop("approximate")
    assert "missing-kwargs" in {v.code for v in tverify.ProgramVerifier().verify(prog, [y._vid])}
    prog.global_block().ops[0].kwargs["approximate"] = False
    prog.global_block().ops[0].type = "wq::fp16::gelu"  # a namespaced real op resolves
    assert tverify.ProgramVerifier().verify(prog, [y._vid]) == []
    with pytest.raises(tverify.VerificationError, match="dangling-fetch"):
        tverify.verify_program(prog, [987654321])


def test_differential_catches_a_wrong_and_a_crashing_rewrite():
    """A transpose-blind epilogue rewrite (square weight: every shape
    agrees) passes the structural checks, and only the replay on a feed
    catches it; a rewrite that raises is a crash violation."""
    from paddle_tpu_torch.static.rewrite import _make_op

    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        x, w = _tfeed(prog, "x", (4, 4)), _tfeed(prog, "w", (4, 4))
        y = tF.gelu(torch.matmul(x, w.t()))
    ref = prog.clone()
    ops = prog.global_block().ops
    blind = _make_op("matmul_epilogue", lambda a, b: tF.gelu(a @ b), [x._vid, w._vid], ops[-1])
    prog.global_block().ops = [blind]
    prog.version += 1
    assert tverify.ProgramVerifier().verify(prog, [y._vid]) == []
    bad = tverify.differential_check(ref, prog, [y._vid], raise_on_error=False)
    assert {v.code for v in bad} == {"differential-mismatch"}
    with pytest.raises(tverify.DifferentialError):
        tverify.differential_check(ref, prog, [y._vid])

    def broken(a, b):
        raise RuntimeError("broken kernel")

    prog.global_block().ops = [_make_op("matmul_epilogue", broken, [x._vid, w._vid], ops[-1])]
    bad = tverify.differential_check(ref, prog, [y._vid], raise_on_error=False)
    assert "differential-crash" in {v.code for v in bad}


def _attention_program(S=32, D=8):
    prog = tstatic.Program()
    with tstatic.program_guard(prog):
        q, k, v = (_tfeed(prog, n, (1, 2, S, D)) for n in "qkv")
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / (D ** 0.5), dim=-1)
        attn = torch.matmul(probs, v)
    return prog, attn


def test_verify_mode_executor_and_pass_manager():
    from paddle_tpu_torch.static.passes import ProgramPass, ProgramPassManager

    rng = np.random.default_rng(0)
    prog, attn = _attention_program()
    feed = {n: rng.standard_normal((1, 2, 32, 8)).astype(np.float32) for n in "qkv"}
    pt.set_flags({"FLAGS_verify_programs": True})
    try:
        base = tverify.verify_stats()
        (out,) = tstatic.Executor("cpu").run(prog, feed=feed, fetch_list=[attn])
        stats = tverify.verify_stats()
        assert "flash_attention" in [op.type for op in prog.global_block().ops]
        assert stats["differential_checks"] > base["differential_checks"]
        assert stats["differential_failures"] == base["differential_failures"]
        assert stats["programs_failed"] == base["programs_failed"]

        class _Corruptor(ProgramPass):
            name = "corruptor"

            def apply(self, program):
                program.global_block().ops[0].arg_spec[0] = ("var", 424242)
                program.version += 1
                return 1

        prog2 = tstatic.Program()
        with tstatic.program_guard(prog2):
            y = torch.exp(_tfeed(prog2, "x", (2,)))
        with pytest.raises(tverify.VerificationError, match="corruptor"):
            ProgramPassManager([_Corruptor()], fetch_vids=[y._vid]).run(prog2)
    finally:
        pt.set_flags({"FLAGS_verify_programs": False})
    q, k, v = feed["q"], feed["k"], feed["v"]
    s = q @ np.swapaxes(k, -1, -2) / np.sqrt(8.0)
    e = np.exp(s - s.max(-1, keepdims=True))
    np.testing.assert_allclose(out, (e / e.sum(-1, keepdims=True)) @ v, atol=1e-4, rtol=1e-4)


def test_every_program_of_these_paths_verifies_with_fusion_on():
    with tverify.track_programs() as programs:
        test_append_backward_matches_reference()
        test_clone_for_test_drops_writes()
        test_static_bert_dropout_fresh_masks_and_replay()
        prog, attn = _attention_program()
        feed = {n: np.ones((1, 2, 32, 8), np.float32) for n in "qkv"}
        tstatic.Executor("cpu").run(prog, feed=feed, fetch_list=[attn])
    assert len(programs) >= 5
    verifier = tverify.ProgramVerifier(strict_abstract=True)
    for prog in programs:
        assert verifier.verify(prog) == [], [op.type for op in prog.global_block().ops]
