"""The port's ``amp`` (``auto_cast``, ``decorate``, ``GradScaler``,
``TrainStep(scaler=)``) against the JAX package's, on the CPU.

Both sides get the same numpy inputs and weights (carried by
``load_jax_state_dict``, or copied by name for the small MLP).  The JAX
package runs with ``FLAGS_use_pallas`` on, as the port's kernel path is
its Pallas path's counterpart: there ``nn.RMSNorm`` calls
``fused_rms_norm``, which is in neither AMP list (ROADMAP.md §C).
Tolerances, with their reasons:

- O1 losses: 1e-4 relative (the same bf16 or f16 products, summed in
  other orders, feed an f32 cross entropy);
- O1 gradients: 2e-2 relative L2 (one rounding of each bf16 product and
  of the flash backward's P and dS);
- the scaled MLP's losses: 1e-5 relative (f32 throughout; the scale is a
  power of two, so scaling and unscaling are exact);
- the scale trajectory and the skip: exact.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu import amp as jamp
from paddle_tpu._core import autograd as jautograd
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import llama as jllama

from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static as tstatic
from paddle_tpu_torch.convert import load_jax_state_dict
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn import functional as tF

LOSS_REL = 1e-4
GRAD_REL_L2 = 2e-2
MLP_LOSS_REL = 1e-5
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


@pytest.fixture
def pallas_on():
    prev = paddle.get_flags(["FLAGS_use_pallas"])["FLAGS_use_pallas"]
    paddle.set_flags({"FLAGS_use_pallas": "true"})
    yield
    paddle.set_flags({"FLAGS_use_pallas": prev})


def _llama_pair(tie=False):
    paddle.seed(0)
    cfg = dict(num_hidden_layers=2, dtype="float32", tie_word_embeddings=tie)
    jm = jllama.LlamaForCausalLM(jllama.llama_tiny(**cfg))
    tm = tllama.LlamaForCausalLM(tllama.llama_tiny(**cfg), device="cpu")
    load_jax_state_dict(tm, {k: np.asarray(v._value) for k, v in jm.state_dict().items()})
    return jm, tm


def _ids():
    return np.random.default_rng(0).integers(0, 1024, (2, 16)).astype(np.int32)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("tie", [False, True])
def test_hook_sees_the_reference_op_names(pallas_on, monkeypatch, tie):
    """The names the JAX package's hook sees on a llama_tiny forward with
    its loss, against the port's: every name the port's hook sees is one
    the reference's saw, and the names either AMP list acts on come in
    the same numbers (the tied head's ``matmul`` and the loss's
    ``cross_entropy`` included)."""
    jm, tm = _llama_pair(tie)
    ids = _ids()
    seen = {"jax": [], "port": []}
    j_orig, t_orig = jautograd._maybe_amp_cast, tamp.cast_args

    def j_rec(name, args):
        seen["jax"].append(name)
        return j_orig(name, args)

    def t_rec(name, args):
        seen["port"].append(name)
        return t_orig(name, args)

    monkeypatch.setattr(jautograd, "_maybe_amp_cast", j_rec)
    monkeypatch.setattr(tamp, "cast_args", t_rec)
    # the reference compiled whole under the same auto_cast: its hook sees
    # each op once as it is traced, as op by op
    with jamp.auto_cast(True):
        paddle.jit.to_static(jm)(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    with tamp.auto_cast(True):
        tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    assert set(seen["port"]) <= set(seen["jax"])
    acted = tamp.WHITE_LIST | tamp.BLACK_LIST

    def count(names):
        return sorted((n, names.count(n)) for n in set(names) if n in acted)

    assert count(seen["port"]) == count(seen["jax"])
    assert ("matmul" in seen["port"]) == tie and "cross_entropy" in seen["port"]
    assert seen["port"].count("fused_rms_norm") == 2 * 2 + 1


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_o1_loss_and_grads_match_reference(pallas_on, dtype):
    """An f32 llama_tiny under auto_cast O1: the loss and every gradient
    against the JAX package's; the logits come out in the AMP dtype and
    every gradient in f32 (the cotangent cast back through each cast).
    The reference's forward is compiled whole (``paddle.jit.to_static``,
    traced under the same auto_cast) and differentiated by its tape: its
    gradients lie within 1e-3 of its op-by-op run's, far inside the
    tolerance, at a third of the time."""
    jm, tm = _llama_pair()
    ids = _ids()
    with jamp.auto_cast(True, dtype=dtype):
        jloss, jlogits = paddle.jit.to_static(jm)(paddle.to_tensor(ids),
                                                  labels=paddle.to_tensor(ids))
    jloss.backward()
    with tamp.auto_cast(True, dtype=dtype):
        tloss, tlogits = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    tloss.backward()
    assert tlogits.dtype == DTYPES[dtype] and tloss.dtype == torch.float32
    assert str(jlogits._value.dtype) == dtype
    assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    jgrads = {n: np.asarray(p.grad._value, np.float32) for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32
        rel = _rel_l2(p.grad.numpy(), jgrads[name])
        assert rel <= GRAD_REL_L2, (name, rel)


def test_custom_lists_and_nested_scopes_restore_state():
    """Custom lists move an op between the lists (as in the JAX package);
    a nested auto_cast (or one disabled inside) gives the outer state back
    on exit, even when its body raises."""
    x = torch.randn(4, 8)
    w = torch.randn(8, 8)
    lin = lambda: tF.linear(x, w)  # noqa: E731
    sdpa = lambda q: tF.scaled_dot_product_attention(q, q, q)  # noqa: E731
    q = torch.randn(1, 4, 2, 8)
    st = tamp.amp_state()
    assert not st.enabled and lin().dtype == torch.float32
    with tamp.auto_cast():
        assert lin().dtype == torch.bfloat16 and sdpa(q).dtype == torch.bfloat16
        assert tF.cross_entropy(x.bfloat16(), torch.zeros(4, dtype=torch.long)).dtype \
            == torch.float32
        with tamp.auto_cast(custom_black_list={"linear"}, dtype="float16"):
            assert lin().dtype == torch.float32 and sdpa(q).dtype == torch.float16
            assert "linear" in tamp.black_list() and "linear" not in tamp.white_list()
            with tamp.auto_cast(enable=False):
                assert lin().dtype == torch.float32 and sdpa(q).dtype == torch.float32
            assert st.dtype == torch.float16 and st.custom_black == {"linear"}
        assert st.dtype == torch.bfloat16 and st.custom_black == set()
        with tamp.auto_cast(custom_white_list={"cross_entropy"}):
            out = tF.cross_entropy(x, torch.zeros(4, dtype=torch.long))
            assert out.dtype == torch.bfloat16
        with pytest.raises(RuntimeError), tamp.amp_guard(custom_white_list={"x"}):
            raise RuntimeError("body fails")
        assert st.enabled and st.custom_white == set()
    assert not st.enabled and lin().dtype == torch.float32
    # the JAX package moves the same names the same way
    with jamp.auto_cast(custom_black_list={"linear"}, custom_white_list={"cross_entropy"}):
        jw, jb = jamp.white_list(), jamp.black_list()
    with tamp.auto_cast(custom_black_list={"linear"}, custom_white_list={"cross_entropy"}):
        assert tamp.white_list() == jw and tamp.black_list() == jb


def test_auto_cast_refuses_static_capture():
    """auto_cast entered inside a capture, or a capture that records an op
    inside auto_cast, raises naming the ROADMAP item."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5.6"), \
            tstatic.program_guard(tstatic.Program()), tamp.auto_cast():
        pass
    w = torch.nn.Parameter(torch.ones(4, 4))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.5.6"), tamp.auto_cast(), \
            tstatic.program_guard(tstatic.Program()):
        tF.linear(torch.ones(2, 4), w)
    assert not tamp.amp_state().enabled
    assert tamp.is_bfloat16_supported() and tamp.is_float16_supported()


def test_decorate_o2_casts_parameters_in_place():
    """decorate(level="O2") casts every floating parameter as the JAX
    package's does, keeping each Parameter object; the optimizer then keeps
    f32 masters and the f32 update; O1 changes nothing."""
    jm, tm = _llama_pair()
    params = list(tm.parameters())
    opt = topt.AdamW(1e-3, parameters=tm.parameters())
    assert tamp.decorate(tm, level="O1") is tm
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    got_m, got_o = tamp.decorate(tm, opt, level="O2", dtype="bfloat16")
    assert got_m is tm and got_o is opt
    assert all(a is b for a, b in zip(tm.parameters(), params))
    jamp.decorate(jm, level="O2", dtype="bfloat16")
    jdt = {n: str(p._value.dtype) for n, p in jm.named_parameters()}
    assert {n: str(p.dtype).replace("torch.", "") for n, p in tm.named_parameters()} == jdt
    ids = torch.from_numpy(_ids())
    step = TrainStep(tm, opt, lambda m, i, l: m(i, labels=l)[0])
    step(ids, ids)
    masters = [k for k in opt.state_dict() if k.startswith("master_weight")]
    assert len(masters) == len(params)
    assert all(t.dtype == torch.float32 for (n, _), t in opt._accumulators.items()
               if n == "master_weight")
    two = tamp.decorate([tm], level="O2", dtype="float16")
    assert two == [tm] and all(p.dtype == torch.float16 for p in tm.parameters())


# ------------------------------------------------------------------ scaler

class _MLP(torch.nn.Module):
    """The JAX test's Sequential(Linear(8, 16), ReLU(), Linear(16, 1)) out
    of the port's Linears."""

    def __init__(self):
        super().__init__()
        self.fc1 = Linear(8, 16, device="cpu")
        self.fc2 = Linear(16, 1, device="cpu")

    def forward(self, x):
        return self.fc2(tF.relu(self.fc1(x)))


def _mlp_pair():
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 1))
    tm = _MLP()
    sd = {k: np.asarray(v._value) for k, v in jm.state_dict().items()}
    with torch.no_grad():
        for (tname, p), jname in zip(tm.named_parameters(),
                                     ("0.weight", "0.bias", "2.weight", "2.bias")):
            p.copy_(torch.from_numpy(sd[jname]))
    return jm, tm


def _mse(m, a, b):
    return ((m(a) - b) ** 2).mean()


def _regression(inf=False):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 8)).astype(np.float32)
    y = (x @ rng.standard_normal((8, 1))).astype(np.float32)
    if inf:
        x[:4] = np.inf
    return x, y


@pytest.mark.parametrize("inf", [False, True], ids=["trains", "skips_on_inf"])
def test_train_step_scaler_matches_reference(inf):
    """TrainStep(scaler=) over 5 steps against the JAX package's compiled
    TrainStep: losses and the scale after every step (incr_every_n_steps 2
    doubles it; inf inputs skip every step and halve it, parameters bit
    for bit as they were)."""
    jm, tm = _mlp_pair()
    x, y = _regression(inf)
    jo = paddle.optimizer.SGD(learning_rate=0.05, parameters=jm.parameters())
    to = topt.SGD(learning_rate=0.05, parameters=tm.parameters())
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw, device="cpu")
    jstep = JTrainStep(jm, jo, _mse, scaler=js)
    tstep = TrainStep(tm, to, _mse, scaler=ts)
    before = [p.detach().clone() for p in tm.parameters()]
    jx, jy = paddle.to_tensor(x), paddle.to_tensor(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    for i in range(5):
        jl, tl = float(jstep(jx, jy)), float(tstep(tx, ty))
        if inf:
            assert not np.isfinite(jl) and not np.isfinite(tl)
        else:
            assert abs(tl - jl) <= MLP_LOSS_REL * abs(jl), (i, tl, jl)
        assert ts.get_loss_scaling() == js.get_loss_scaling(), i
    if inf:
        assert ts.get_loss_scaling() == 2.0 ** 5
        for a, b in zip(before, tm.parameters()):
            assert torch.equal(a, b)
    else:
        assert ts.get_loss_scaling() > 2.0 ** 10
    assert ts.state_dict() == {k: v for k, v in js.state_dict().items()}
    assert to._step_count == 5  # steps run, skipped ones too (ROADMAP.md §C)


def test_adamw_skip_keeps_every_state_tensor():
    """A skipped AdamW step leaves each parameter, f32 master, moment and
    beta power bit for bit (a select in every write), and the next finite
    step equals a step of an unscaled optimizer from the same state."""
    torch.manual_seed(0)
    w = torch.nn.Parameter(torch.randn(6, 5).bfloat16())
    b = torch.nn.Parameter(torch.randn(5))
    ref_w = torch.nn.Parameter(w.detach().clone())
    ref_b = torch.nn.Parameter(b.detach().clone())
    opt = topt.AdamW(1e-2, parameters=[w, b])
    ref = topt.AdamW(1e-2, parameters=[ref_w, ref_b])
    scaler = tamp.GradScaler(init_loss_scaling=8.0, device="cpu")
    x = torch.randn(3, 6)

    def loss_of(ww, bb, xx):
        return ((xx @ ww.float() + bb) ** 2).mean()

    for xx in (x, x * 2):  # two finite steps create and move every accumulator
        scaler.scale(loss_of(w, b, xx)).backward()
        scaler.step(opt)
        opt.clear_grad()
        loss_of(ref_w, ref_b, xx).backward()
        ref.step()
        ref.clear_grad()
    state = [t.clone() for t in [w, b] + opt.opt_state_tensors()]
    scaler.scale(loss_of(w, b, torch.full_like(x, float("inf")))).backward()
    scaler.step(opt)
    opt.clear_grad()
    for a, t in zip(state, [w, b] + opt.opt_state_tensors()):
        assert torch.equal(a, t)
    assert scaler.get_loss_scaling() == 4.0 and opt._step_count == 3
    scaler.scale(loss_of(w, b, x)).backward()
    scaler.step(opt)
    loss_of(ref_w, ref_b, x).backward()
    ref.step()
    for a, t in zip([ref_w, ref_b] + ref.opt_state_tensors()[:-1],
                    [w, b] + opt.opt_state_tensors()[:-1]):
        assert torch.equal(a, t)


def test_eager_scaler_semantics_match_reference():
    """The JAX package's test_eager_scaler_matches_semantics: two good
    steps at incr_every_n_steps 2 double the scale; then the floor of 1.0
    on a decrease, and decr_every_n_nan_or_inf 2 halving only after two
    bad steps in a row."""
    jm, tm = _mlp_pair()
    jo = paddle.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
    to = topt.SGD(learning_rate=0.1, parameters=tm.parameters())
    js = jamp.GradScaler(init_loss_scaling=4.0, incr_every_n_steps=2)
    ts = tamp.GradScaler(init_loss_scaling=4.0, incr_every_n_steps=2, device="cpu")
    x, y = np.ones((4, 8), np.float32), np.zeros((4, 1), np.float32)
    for _ in range(2):
        jl = _mse(jm, paddle.to_tensor(x), paddle.to_tensor(y))
        js.scale(jl).backward()
        js.step(jo)
        jo.clear_grad()
        tl = _mse(tm, torch.from_numpy(x), torch.from_numpy(y))
        ts.scale(tl).backward()
        ts.step(to)
        to.clear_grad()
        assert float(tl) == pytest.approx(float(jl), rel=MLP_LOSS_REL)
    assert ts.get_loss_scaling() == js.get_loss_scaling() == 8.0

    seq = []
    s = tamp.GradScaler(init_loss_scaling=1.5, decr_every_n_nan_or_inf=2, device="cpu")
    for found in (True, True, True, False, True, True):
        s._found_t.fill_(found)
        s.update()
        seq.append((s.get_loss_scaling(), int(s._good_t), int(s._bad_t)))
    assert seq == [(1.5, 0, 1), (1.0, 0, 0), (1.0, 0, 1), (1.0, 1, 0), (1.0, 0, 1),
                   (1.0, 0, 0)]
    off = tamp.GradScaler(enable=False, device="cpu")
    loss = torch.tensor(3.0)
    assert off.scale(loss) is loss and not off.is_enable()
    static = tamp.GradScaler(use_dynamic_loss_scaling=False, device="cpu")
    static._found_t.fill_(True)
    static.update()
    assert static.get_loss_scaling() == 2.0 ** 16 and not static.is_use_dynamic_loss_scaling()


def test_scaler_state_dict_round_trip_in_place():
    """state_dict matches the JAX package's keys; load_state_dict and
    set_init_loss_scaling write the state tensors in place (a recorded
    step reads them at fixed addresses); minimize is scaled backward plus
    step."""
    s = tamp.GradScaler(init_loss_scaling=2.0 ** 12, device="cpu")
    ptrs = [t.data_ptr() for t in s.state_tensors()]
    ids = [id(t) for t in s.state_tensors()]
    s.load_state_dict({"scale": 256.0, "incr_count": 7, "decr_count": 1})
    sd = s.state_dict()
    want = jamp.GradScaler()
    want.load_state_dict({"scale": 256.0, "incr_count": 7, "decr_count": 1})
    assert sd == want.state_dict()
    s.set_init_loss_scaling(2.0 ** 40)
    assert s.get_loss_scaling() == 2.0 ** 40
    assert [t.data_ptr() for t in s.state_tensors()] == ptrs
    assert [id(t) for t in s.state_tensors()] == ids
    assert s._scale_t.dtype == torch.float32 and s._good_t.dtype == torch.int32

    _, tm = _mlp_pair()
    opt = topt.SGD(0.1, parameters=tm.parameters())
    before = [p.detach().clone() for p in tm.parameters()]
    s.set_init_loss_scaling(4.0)
    x, y = torch.ones(4, 8), torch.zeros(4, 1)
    s.minimize(opt, s.scale(_mse(tm, x, y)))
    assert any(not torch.equal(a, p) for a, p in zip(before, tm.parameters()))
    assert int(s._good_t) == 8  # load_state_dict's 7, then one good step


def test_train_step_scaler_state_joins_the_step_state():
    """The scaler's scale and counts are part of TrainStep's state (and so
    of lower()/warmup()'s roll-back); a disabled scaler adds nothing."""
    _, tm = _mlp_pair()
    opt = topt.SGD(0.05, parameters=tm.parameters())
    s = tamp.GradScaler(device="cpu")
    step = TrainStep(tm, opt, _mse, scaler=s)
    state = step._state()
    assert all(any(t is u for u in state) for t in s.state_tensors())
    x, y = _regression()
    step.warmup(torch.from_numpy(x), torch.from_numpy(y))
    assert s.get_loss_scaling() == 2.0 ** 16 and int(s._good_t) == 0
    off = TrainStep(tm, opt, _mse, scaler=tamp.GradScaler(enable=False, device="cpu"))
    assert len(off._state()) == len(state) - 3
