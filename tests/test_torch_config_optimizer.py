"""Two repairs of the port against the JAX package, on the CPU.

- Optimizer parameter groups: a list of ``{"params": [...], ...}`` dicts is
  flattened as the JAX package flattens it (its per-group options kept in
  ``_param_groups`` and ignored there as here); AdamW over two groups must
  match the JAX AdamW's three steps (f32: 1e-6, the same operations summed
  in other orders).
- ``LlamaConfig`` carries the JAX package's five parallel and memory
  fields; a JAX config's ``__dict__`` builds the port's config, and a model
  built with a value the port has not ported raises ``NotImplementedError``
  naming its ROADMAP item.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as jopt
from paddle_tpu._core.tensor import Parameter, Tensor
from paddle_tpu.models import llama as jllama

import paddle_tpu_torch.optimizer as topt
from paddle_tpu_torch.models import llama as tllama

F32_TOL = 1e-6
SHAPES = {"w": (6, 5), "b": (5,), "norm": (5,)}


def _arrays(seed=7):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("named", [False, True])
def test_adamw_two_param_groups_match_jax(named):
    """Two groups, the second with its own (ignored) options; the port's
    groups may hold tensors or (name, param) pairs."""
    params, grads = _arrays()
    jps = {n: Parameter(jnp.asarray(a), name=n) for n, a in params.items()}
    tps = {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in params.items()}

    def groups(ps, pairs):
        item = (lambda n: (n, ps[n])) if pairs else (lambda n: ps[n])
        return [{"params": [item("w"), item("b")]},
                {"params": [item("norm")], "weight_decay": 0.0, "learning_rate": 0.5}]

    jo = jopt.AdamW(0.05, parameters=groups(jps, False), weight_decay=0.1)
    to = topt.AdamW(0.05, parameters=groups(tps, named), weight_decay=0.1)
    assert len(to._parameter_list) == len(jo._parameter_list) == 3
    assert [len(g["params"]) for g in to._param_groups] == [2, 1]
    assert to._param_groups[1]["learning_rate"] == 0.5
    for g in grads:
        for n in SHAPES:
            jps[n].grad = Tensor(jnp.asarray(g[n]))
            tps[n].grad = torch.from_numpy(g[n].copy())
        jo.step()
        jo.clear_grad()
        to.step()
        to.clear_grad()
    for n in SHAPES:
        np.testing.assert_allclose(tps[n].detach().numpy(), np.asarray(jps[n]._value),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=n)
    jstate, tstate = jo.state_dict(), to.state_dict()
    assert list(tstate) == list(jstate)
    assert tstate["step_count"] == jstate["step_count"] == 3


NEW_FIELDS = {"tensor_parallel_degree": 1, "sequence_parallel": False, "use_recompute": False,
              "recompute_granularity": "full", "fuse_layer_stack": False}


def test_llama_config_has_the_reference_fields_and_defaults():
    want = {f.name: f.default for f in dataclasses.fields(jllama.LlamaConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tllama.LlamaConfig)}
    assert got == want
    assert {n: want[n] for n in NEW_FIELDS} == NEW_FIELDS
    assert tllama.llama_tiny(use_recompute=True).use_recompute is True


def test_reference_config_carries_across():
    jcfg = jllama.llama_tiny(num_hidden_layers=1, recompute_granularity="core_attn")
    tcfg = tllama.LlamaConfig(**jcfg.__dict__)
    assert dataclasses.asdict(tcfg) == jcfg.__dict__
    ported = tllama.LlamaConfig(**jllama.llama_tiny(num_hidden_layers=1).__dict__)
    model = tllama.LlamaForCausalLM(ported, device="cpu")
    assert len(model.model.layers) == 1


@pytest.mark.parametrize("field,value,item", [
    ("tensor_parallel_degree", 2, "A.6"), ("sequence_parallel", True, "A.6"),
    ("use_recompute", True, "A.3.4"), ("recompute_granularity", "full_attn", "A.3.4"),
    ("fuse_layer_stack", True, "A.3.4")])
def test_unported_config_values_raise_naming_their_item(field, value, item):
    cfg = tllama.llama_tiny(num_hidden_layers=1, **{field: value})
    with pytest.raises(NotImplementedError, match=f"{field}.*ROADMAP.md {item}"):
        tllama.LlamaForCausalLM(cfg, device="cpu")


def _auto_cast_in_capture():
    from paddle_tpu_torch import amp, static

    with static.program_guard(static.Program()), amp.auto_cast():
        pass


def _dropout_in_capture(tF, tstatic):
    with tstatic.program_guard(tstatic.Program()):
        tF.dropout(tstatic.data("x", [2, 4], "float32"), p=0.5, training=True)


def _raiser(case):
    """A call of the port that raises NotImplementedError naming a ROADMAP
    item (the message's item, then the call)."""
    from paddle_tpu_torch import static as tstatic
    from paddle_tpu_torch.nn import functional as tF
    from paddle_tpu_torch.nn import Linear, ParamAttr
    from paddle_tpu_torch.nn.layer.common import Embedding
    from paddle_tpu_torch.regularizer import L1Decay
    from paddle_tpu_torch.nn.lora import adapter_prefill_scope
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.static.passes import apply_pass

    x = torch.ones(2, 4)
    calls = {
        # amp and TrainStep(scaler=) are ported (A.3.1); auto_cast over a
        # static capture is not
        "scaler": ("A.5.6", _auto_cast_in_capture),
        # adapters are ported; their LayerStack layout is not
        "serving_adapters": ("A.3.4", lambda: adapter_prefill_scope(object(), None, 1)
                             .__enter__()),
        "serving_mesh": ("A.6", lambda: GenerationEngine(None, mesh=object())),
        # dropout in training is ported (A.3.2); inside a static capture
        # it is static training
        "dropout": ("A.5.2", lambda: _dropout_in_capture(tF, tstatic)),
        # regularizers and ParamAttr are ported (A.3.3); ParamAttr's
        # initializer is nn/initializer, and LBFGS is A.3.3's last item
        "regularizer": ("A.7", lambda: Linear(4, 2, weight_attr=ParamAttr(
            regularizer=L1Decay(0.1), initializer=object()), device="cpu")),
        "adamw_regularizer": ("A.3.3", lambda: topt.LBFGS(
            0.1, parameters=[torch.nn.Parameter(x)])),
        "sparse_embedding": ("A.3.5", lambda: Embedding(8, 4, sparse=True)),
        "static_pass": ("A.5.6", lambda: apply_pass(tstatic.Program(), "weight_only_quant")),
        "mesh_pass": ("A.6", lambda: apply_pass(tstatic.Program(), "auto_parallel_sharding")),
    }
    return calls[case]


@pytest.mark.parametrize("case", ["scaler", "serving_adapters", "serving_mesh", "dropout",
                                  "regularizer",
                                  "adamw_regularizer", "sparse_embedding", "static_pass",
                                  "mesh_pass"])
def test_unported_calls_name_the_current_roadmap_item(case):
    """Each message names the item of ROADMAP.md's queue A that ports it
    (training A.3 with LBFGS A.3.3, the LayerStack layout A.3.4, sparse
    A.3.5; static A.5, dropout in a captured Program A.5.2; distributed
    A.6; initializers A.7), never a retired "queue A item" number."""
    item, call = _raiser(case)
    with pytest.raises(NotImplementedError) as err:
        call()
    assert f"ROADMAP.md {item}" in str(err.value) and "queue A item" not in str(err.value)
