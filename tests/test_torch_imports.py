"""The port stands alone: no JAX, no paddle_tpu, no library kernels.

- importing paddle_tpu_torch loads neither jax nor any paddle_tpu module;
- no module of the package imports them (AST scan);
- the package never calls torch's scaled_dot_product_attention,
  rms_norm or layer_norm, nor torch.compile (AST scan, and CPU runs with
  those entry points, and torch._addmm_activation, made to raise);
- the training path uses no torch.optim (AST scan, and a CPU TrainStep
  run with torch.optim's optimizers made to raise);
- the entry points default to the CUDA card and raise without one.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "paddle_tpu_torch"
FORBIDDEN_CALLS = {"scaled_dot_product_attention", "rms_norm", "layer_norm"}


def _sources():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    return [(f, ast.parse(f.read_text(), filename=str(f))) for f in files]


def _is_reference(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


def test_import_loads_no_jax_and_no_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, paddle_tpu_torch.convert,"
            " paddle_tpu_torch.optimizer, paddle_tpu_torch.jit, paddle_tpu_torch.device,"
            " paddle_tpu_torch.nn.clip, paddle_tpu_torch.optimizer.lr,"
            " paddle_tpu_torch.ops.decode_chain, paddle_tpu_torch.ops.autotune,"
            " paddle_tpu_torch.static.schedule_search, paddle_tpu_torch.cost_model,"
            " paddle_tpu_torch.static, paddle_tpu_torch.models.bert,"
            " paddle_tpu_torch.ops.matmul_epilogue, paddle_tpu_torch.static.codegen,"
            " paddle_tpu_torch.static.rewrite;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'paddle_tpu'));"
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_module_imports_the_reference():
    for path, tree in _sources():
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_is_reference(n) for n in names), (path, names)


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def test_no_library_attention_norm_or_compile():
    for path, tree in _sources():
        torch_f_aliases = {"torch.nn.functional"}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module in ("torch.nn.functional",
                                                                    "torch"):
                bad = {a.name for a in node.names} & (FORBIDDEN_CALLS | {"compile"})
                assert not bad, (path, bad)
            if isinstance(node, ast.ImportFrom) and node.module == "torch.nn":
                torch_f_aliases |= {a.asname or a.name for a in node.names
                                    if a.name == "functional"}
            if isinstance(node, ast.Import):
                torch_f_aliases |= {a.asname for a in node.names
                                    if a.name == "torch.nn.functional" and a.asname}
        for node in ast.walk(tree):
            name = _dotted(node) if isinstance(node, ast.Attribute) else None
            if name is None:
                continue
            head, _, attr = name.rpartition(".")
            assert not (head in torch_f_aliases | {"torch"} and attr in FORBIDDEN_CALLS), \
                (path, name)
            assert name != "torch.compile", path
            assert not name.startswith("torch.optim"), (path, name)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""])
                assert not any(m.startswith("torch.optim") for m in mods), (path, mods)


def test_train_step_never_reaches_torch_optim(monkeypatch):
    def _refuse(*args, **kwargs):
        raise AssertionError("the port used torch.optim")

    for name in ("SGD", "Adam", "AdamW"):
        monkeypatch.setattr(torch.optim, name, _refuse)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.optimizer import AdamW

    g = torch.Generator().manual_seed(0)
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, dtype="float32"), device="cpu",
                             generator=g)
    step = TrainStep(model, AdamW(1e-3, parameters=model.parameters()),
                     lambda m, ids, labels: m(ids, labels=labels)[0])
    ids = torch.randint(0, 1024, (1, 8), generator=g)
    losses = [float(step(ids, ids)) for _ in range(2)]
    assert losses[1] < losses[0]


def test_cpu_run_never_reaches_library_kernels(monkeypatch):
    def _refuse(*args, **kwargs):
        raise AssertionError("the port called a library kernel")

    for mod, name in ((torch.nn.functional, "scaled_dot_product_attention"),
                      (torch.nn.functional, "rms_norm"), (torch, "rms_norm"),
                      (torch, "compile")):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, _refuse)
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import GenerationEngine

    g = torch.Generator().manual_seed(0)
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, dtype="float32"), device="cpu",
                             generator=g)
    eng = GenerationEngine(model, max_batch=2, block_size=8, num_blocks=8, device="cpu",
                           decode_chunk=2)
    eng.add_request("a", [1, 2, 3], max_new_tokens=4)
    while eng.has_work():
        eng.step()
    assert len(eng.result("a")) == 4


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import GenerationEngine

    cfg = llama_tiny(num_hidden_layers=1, dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        LlamaForCausalLM(cfg)
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerationEngine(model, max_batch=1, block_size=8, num_blocks=4)
    from paddle_tpu_torch.device import synchronize, time_step_ms

    with pytest.raises(RuntimeError, match="CUDA"):
        time_step_ms(lambda: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        synchronize()
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models import BertForSequenceClassification, bert_tiny

    with pytest.raises(RuntimeError, match="CUDA"):
        static.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        BertForSequenceClassification(bert_tiny(num_hidden_layers=1))
    static.Executor(place="cpu")
    BertForSequenceClassification(bert_tiny(num_hidden_layers=1), device="cpu")
    from paddle_tpu_torch.static.rewrite import ScheduleSearchPass

    with pytest.raises(RuntimeError, match="CUDA"):
        ScheduleSearchPass()
    ScheduleSearchPass(device="cpu")


def test_generated_kernels_call_no_library():
    """The codegen templates and a generated source (an elementwise chain
    and a matmul-rooted subgraph) include no library's kernels: no
    cuBLAS, cuDNN, torch headers or CUTLASS device-level GEMMs."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.static import schedule_search as ss
    from paddle_tpu_torch.static.rewrite import ProgramGraph

    main = static.Program()
    with static.program_guard(main):
        x = static.data("x", [16, 64], "bfloat16")
        w = static.data("w", [64, 32], "bfloat16")
        out = torch.tanh(torch.matmul(x, w) + 1.0)
        chain = torch.exp(torch.sigmoid(x * 2.0) + 1.0)
    graph = ProgramGraph(main, (out._vid, chain._vid))
    (spec,) = [sp for sp in (ss.match_subgraph(op, graph) for op in main.global_block().ops) if sp]
    static.passes.apply_pass(main, "generic_elementwise_fusion", fetch_vids=[chain._vid])
    texts = [spec.source(), main.global_block().ops[-1].fn.source]
    texts += [p.read_text() for p in sorted((PKG / "csrc" / "codegen").glob("*.cuh"))]
    for text in texts:
        low = text.lower()
        for word in ("cublas", "cudnn", "torch/", "cutlass", "aten"):
            assert word not in low, word


def test_chained_int8_run_never_reaches_library_kernels(monkeypatch, tmp_path):
    """The int8, chunked-prefill engine with both serving chains adopted
    runs on the CPU without torch's attention or any jax module."""
    import sys

    def _refuse(*args, **kwargs):
        raise AssertionError("the port called a library kernel")

    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention", _refuse)
    from paddle_tpu_torch import set_flags
    from paddle_tpu_torch.models import LlamaForCausalLM, llama_tiny
    from paddle_tpu_torch.serving import GenerationEngine
    from paddle_tpu_torch.static.schedule_search import measure_override

    loaded = {m for m in sys.modules if m.split(".")[0] in ("jax", "paddle_tpu")}
    g = torch.Generator().manual_seed(0)
    model = LlamaForCausalLM(llama_tiny(num_hidden_layers=1, dtype="float32"), device="cpu",
                             generator=g)
    set_flags({"FLAGS_schedule_search": True, "FLAGS_autotune_cache_dir": str(tmp_path)})
    try:
        with measure_override(lambda fn, args, *, label, config: 1.0 if config else 2.0):
            eng = GenerationEngine(model, max_batch=2, block_size=8, num_blocks=32,
                                   device="cpu", decode_chunk=2, kv_cache_dtype="int8",
                                   prefill_chunk=64)
            eng.add_request("a", list(range(1, 70)), max_new_tokens=4)
            while eng.has_work():
                eng.step()
    finally:
        set_flags({"FLAGS_schedule_search": False, "FLAGS_autotune_cache_dir": ""})
    assert eng._decode_chain_cfg and eng._prefill_chain_cfg
    assert len(eng.result("a")) == 4
    assert {m for m in sys.modules if m.split(".")[0] in ("jax", "paddle_tpu")} == loaded


def test_static_bert_cpu_run_never_reaches_library_kernels(monkeypatch):
    """The static BERT path (capture, PallasFusionPass, Executor) on the
    CPU calls none of torch's layer_norm, attention or fused
    matmul-activation: the port's own plain versions stand in."""
    import collections

    def _refuse(*args, **kwargs):
        raise AssertionError("the port called a library kernel")

    for mod, name in ((torch.nn.functional, "layer_norm"), (torch, "layer_norm"),
                      (torch.nn.functional, "scaled_dot_product_attention"),
                      (torch, "_addmm_activation")):
        monkeypatch.setattr(mod, name, _refuse)
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models import BertForSequenceClassification, bert_tiny

    g = torch.Generator().manual_seed(0)
    model = BertForSequenceClassification(bert_tiny(), device="cpu", generator=g).eval()
    main = static.Program()
    with static.program_guard(main):
        logits = model(static.data("ids", [2, 16], "int32"))
    ids = torch.randint(1, 1024, (2, 16), generator=g, dtype=torch.int32)
    ids[1, 9:] = 0
    (out,) = static.Executor("cpu").run(main, feed={"ids": ids}, fetch_list=[logits])
    counts = collections.Counter(op.type for op in main.global_block().ops)
    assert counts["add_layer_norm"] == 5 and counts["matmul_epilogue"] == 2
    assert out.shape == (2, 2)
