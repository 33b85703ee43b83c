"""Static model serialisation, the deploy format (counterpart of
paddle_tpu/static/io.py).

The JAX package writes its program as StableHLO through ``jax.export``.
The port writes its own format, which only the port reads:

- ``<prefix>.pdmodel``: the pruned op list as data, written by
  ``torch.save`` and read with ``torch.load(weights_only=True)``: per op
  its type, its input wiring (var ids, plain values, const tensors), its
  attributes and its callable as the op registry names it
  (``framework/op_registry.py``: ``describe`` / ``build``); the vars'
  shapes and dtypes; the const tensors;
- ``<prefix>.pdiparams``: the state the program reads, a dict of tensors
  by name (``torch.save``, read with ``weights_only=True``);
- ``<prefix>.json``: the manifest (feed and fetch names, shapes, dtypes).

No callable is pickled: loading rebuilds each op through the registry,
which binds only the functions the package records ops over and the
torch (and ``operator``) callables of its closed table; an op type the
registry does not resolve, or a dtype that is not one, makes the load
raise.  An op the registry cannot name (one a pass or
autodiff built) makes the save raise, naming it; the Predictor's Executor
runs the fusion pass at load, so the unfused program is what is saved.

A batch left ``None`` (``jit.save`` with an ``InputSpec`` of ``None``
batch) is captured at three batch sizes; every integer of the program that
differs between them (a reshape's size, a var's shape) must be affine in
the batch and is written as such, so the Predictor rebuilds the program
for each batch size it sees.  ``save_inference_model`` of a Program
whose feeds were declared with ``None`` or ``-1`` dims keeps the captured
program and lets those dims vary, which holds for programs that bake no
size.
"""

from __future__ import annotations

import io
import json
import os

import torch
from torch.utils import _pytree as pytree

from paddle_tpu_torch.framework import op_registry
from paddle_tpu_torch.framework.io_utils import atomic_write

from .executor import global_scope
from .program import Operator, Program, Variable, bind_op, default_main_program, prune_ops

__all__ = [
    "save",
    "load",
    "save_inference_model",
    "load_inference_model",
    "serialize_program",
    "deserialize_program",
    "FORMAT",
]

FORMAT = "paddle_tpu_torch.program/1"
NUMERICS_PRESERVING = {"dead_code_elimination", "pallas_fusion", "generic_elementwise_fusion"}
_SYM = "__batch__"  # an int affine in the batch: {_SYM: [slope, offset]}


def _dtype_name(dtype):
    return str(dtype).removeprefix("torch.")


def _dtype_of(name):
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"{name!r} is not a torch dtype")
    return dtype


# --------------------------------------------------------------- state files

def _state_values(program, scope, vids):
    """Name -> the scope's value of each state vid (its init value if no
    run set it)."""
    out = {}
    for vid in vids:
        val = scope.find_var(vid)
        if val is None:
            val = program.param_inits[vid]
        out[program._var_by_vid[vid].name] = val
    return out


def save(program: Program, model_path: str):
    """``paddle.static.save``: the program's state (parameters and optimizer
    accumulators, the scope's values) to ``<model_path>.pdparams``."""
    vids = [v for v in program.param_inits if v != program.rng_vid]
    state = {k: v.detach().cpu() for k, v in
             _state_values(program, global_scope(), vids).items()}
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    with atomic_write(model_path + ".pdparams") as f:
        torch.save(state, f)


def load(program: Program, model_path: str, executor=None, var_list=None):
    """``paddle.static.load``: values saved by ``save`` into the scope, by
    name.  The scope's own copy of a tensor is written in place (a
    recorded run keeps reading its address); where the scope shares the
    live parameter, it gets a new tensor, and the parameter is left as
    it was."""
    data = torch.load(model_path + ".pdparams", map_location="cpu", weights_only=True)
    scope = global_scope()
    by_name = {program._var_by_vid[vid].name: vid for vid in program.param_inits
               if vid != program.rng_vid}
    for name, value in data.items():
        vid = by_name.get(name)
        if vid is None:
            continue
        have, init = scope.find_var(vid), program.param_inits[vid]
        if have is not None and \
                have.untyped_storage().data_ptr() != init.untyped_storage().data_ptr():
            with torch.no_grad():
                have.copy_(value)
        else:
            scope.set_var(vid, value.to(init.device, init.dtype))


# ------------------------------------------------------------ program format

def _describe_program(program, feed_vars, fetch_vars):
    """(desc, consts, state vids): the program pruned to the fetches, as
    data; var ids renumbered in order of appearance (feeds, state, ops)."""
    fetch_vids = [v._vid for v in fetch_vars]
    ops = prune_ops(program.global_block().ops, fetch_vids)
    index: dict[int, int] = {}

    def idx(vid):
        if vid not in index:
            index[vid] = len(index)
        return index[vid]

    feeds = [idx(v._vid) for v in feed_vars]
    state_vids = [vid for op in ops for vid in op.input_vids() if vid in program.param_inits]
    state_vids = list(dict.fromkeys(state_vids))
    if program.rng_vid in state_vids:
        raise op_registry.NotDescribable(
            "the program draws random numbers (a dropout in training): export a model in "
            "eval() or a clone(for_test=True) of an eval capture")
    state = [idx(vid) for vid in state_vids]
    consts: dict[str, torch.Tensor] = {}
    op_descs = []
    for op in ops:
        try:
            impl = op_registry.describe(op)
            kwargs = op_registry.encode_value(dict(op.kwargs))
        except (op_registry.NotDescribable, TypeError) as e:
            raise op_registry.NotDescribable(f"cannot save op {op.type!r}: {e}") from None
        args = []
        for kind, val in op.arg_spec:
            if kind == "var":
                args.append(["var", idx(val)])
            elif isinstance(val, torch.Tensor):
                key = f"c{len(consts)}"
                consts[key] = val.detach().cpu()
                args.append(["tensor", key])
            else:
                try:
                    args.append(["const", op_registry.encode_value(val)])
                except TypeError as e:
                    raise op_registry.NotDescribable(f"cannot save op {op.type!r}: {e}") \
                        from None
        op_descs.append({"type": op.type, "impl": impl, "args": args, "kwargs": kwargs,
                         "outs": [idx(v) for v in op.out_vids],
                         "out_tree": pytree.treespec_dumps(op.out_tree)})
    missing = [v for v in fetch_vids if v not in index]
    if missing:
        raise ValueError(f"fetch vids {missing} are defined by no feed, state or op")
    fetches = [index[v] for v in fetch_vids]
    variables = [None] * len(index)
    for vid, i in index.items():
        var = program._var_by_vid[vid]
        variables[i] = [list(var.shape), _dtype_name(var.dtype)]
    names = {"feeds": [v.name for v in feed_vars],
             "fetches": [v.name if not v.name.startswith("var_") else f"fetch_{i}"
                         for i, v in enumerate(fetch_vars)],
             "state": [program._var_by_vid[vid].name for vid in state_vids]}
    desc = {"format": FORMAT, "vars": variables, "feeds": feeds, "fetches": fetches,
            "state": state, "ops": op_descs, "names": names}
    return desc, consts, state_vids


def _merge(values, sizes, path="program"):
    """One description of the program captured at each of ``sizes``: ints
    that differ become ``{_SYM: [slope, offset]}``, anything else that
    differs raises."""
    a = values[0]
    if all(type(v) is int for v in values):
        if all(v == a for v in values):
            return a
        slope = (values[1] - a) // (sizes[1] - sizes[0])
        offset = a - slope * sizes[0]
        if any(slope * s + offset != v for s, v in zip(sizes, values)):
            raise ValueError(f"{path}: {values} at batch sizes {sizes} is not affine in the batch")
        return {_SYM: [slope, offset]}
    if isinstance(a, list) and all(isinstance(v, list) and len(v) == len(a) for v in values):
        return [_merge([v[i] for v in values], sizes, f"{path}[{i}]") for i in range(len(a))]
    if isinstance(a, dict) and all(isinstance(v, dict) and v.keys() == a.keys() for v in values):
        return {k: _merge([v[k] for v in values], sizes, f"{path}.{k}") for k in a}
    if all(v == a for v in values):
        return a
    raise ValueError(f"{path} differs between batch sizes {sizes}: the program is not "
                     "batch-polymorphic (a const or an attribute depends on the batch; "
                     "build it from the inputs)")


def _instantiate(obj, batch):
    if isinstance(obj, list):
        return [_instantiate(v, batch) for v in obj]
    if isinstance(obj, dict):
        if _SYM in obj:
            slope, offset = obj[_SYM]
            return slope * batch + offset
        return {k: _instantiate(v, batch) for k, v in obj.items()}
    return obj


def _pack(desc, consts) -> bytes:
    buf = io.BytesIO()
    torch.save({"format": FORMAT, "program": json.dumps(desc), "consts": consts}, buf)
    return buf.getvalue()


def serialize_program(program: Program, feed_vars, fetch_vars) -> bytes:
    """The program pruned to ``fetch_vars``, as bytes of the port's format
    (``torch.save`` of plain data and tensors)."""
    desc, consts, _ = _describe_program(program, feed_vars, fetch_vars)
    return _pack(desc, consts)


def _unpack(blob):
    src = io.BytesIO(blob) if isinstance(blob, (bytes, bytearray)) else blob
    data = torch.load(src, map_location="cpu", weights_only=True)
    if data.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} artifact (format {data.get('format')!r}); the port "
                         "reads only its own artifacts")
    desc = json.loads(data["program"])
    _check_names(desc)
    return desc, data["consts"]


def _check_names(desc):
    """Every op type, callable and dtype the description names resolves in
    the registry: a hostile or foreign artifact raises here, at load,
    before anything of it runs."""
    for _, dtype in desc["vars"]:
        _dtype_of(dtype)
    for d in desc["ops"]:
        if not op_registry.resolve_op_type(d["type"]):
            raise ValueError(f"op type {d['type']!r} does not resolve in the op registry")
        impl = d["impl"]
        op_registry.resolve_callable(impl["torch_call"] if "torch_call" in impl else impl["call"])


def build_program(desc, consts, params, device, batch=None):
    """A Program from its description (``batch`` resolves a ``None``
    batch), its state the tensors of ``params`` by name on ``device``.
    Returns (program, feed vars, fetch vars)."""
    if batch is not None:
        desc = _instantiate(desc, batch)
    elif _SYM in json.dumps(desc):
        raise ValueError("this program has a None batch: give the batch size")
    device = torch.device(device)
    prog = Program()
    var = []
    for shape, dtype in desc["vars"]:
        var.append(prog.new_var(shape, _dtype_of(dtype)))
    names = desc["names"]
    feeds = []
    for i, name in zip(desc["feeds"], names["feeds"]):
        v = var[i]
        v._name = name
        prog.global_block().vars[name] = v
        feeds.append(prog.add_feed(v))
    for i, name in zip(desc["state"], names["state"]):
        v = var[i]
        v._name = name
        t = params[name].to(device)
        prog.param_vars[id(t)] = v
        prog.param_inits[v._vid] = t
    for d in desc["ops"]:
        if not op_registry.resolve_op_type(d["type"]):
            raise ValueError(f"op type {d['type']!r} does not resolve in the op registry")
        impl = op_registry.build(d["impl"], device)
        arg_spec = []
        for kind, val in d["args"]:
            if kind == "var":
                arg_spec.append(("var", var[val]._vid))
            elif kind == "tensor":
                arg_spec.append(("const", consts[val].to(device)))
            else:
                arg_spec.append(("const", op_registry.decode_value(val, device)))
        kwargs = op_registry.decode_value(d["kwargs"], device)
        prog.global_block().ops.append(Operator(
            d["type"], bind_op(impl, arg_spec, kwargs), arg_spec, kwargs,
            [var[i]._vid for i in d["outs"]], pytree.treespec_loads(d["out_tree"]),
            impl=impl))
    fetches = []
    for i, name in zip(desc["fetches"], names["fetches"]):
        v = var[i]
        v._name = name
        prog.global_block().vars[name] = v
        fetches.append(v)
    prog.version += 1
    return prog, feeds, fetches


def deserialize_program(blob, params, device="cpu", batch=None):
    """``serialize_program``'s bytes back to (program, feed vars, fetch
    vars) on ``device``, its state ``params`` (name -> tensor)."""
    desc, consts = _unpack(blob)
    return build_program(desc, consts, params, device, batch)


# ------------------------------------------------------------------ export

def _check_precision(precision, extra_precisions):
    if precision not in (None, "float32", "fp32"):
        raise NotImplementedError(
            f"save_inference_model(precision={precision!r}) needs the weight-only "
            "quantisation and fp16 program passes, not ported yet (ROADMAP.md A.5.6 "
            "weight_only_quant, A.6 auto_parallel_fp16); cast the model before capture")
    if extra_precisions:
        raise NotImplementedError(
            "save_inference_model(extra_precisions=...) needs the fp16 and weight-only "
            "program passes, not ported yet (ROADMAP.md A.5.6 weight_only_quant, A.6 "
            "auto_parallel_fp16)")


def _optimized(program, fetch_vids, passes):
    """``program``, or a ``clone(for_test=True)`` the named passes ran on
    (their fetch frontier the export's), and the names applied."""
    if not passes:
        return program, []
    from .passes import apply_pass

    clone = program.clone(for_test=True)
    applied = []
    for entry in passes:
        opts = dict(entry) if isinstance(entry, dict) else {}
        name = opts.pop("name", entry) if isinstance(entry, dict) else entry
        if name in ("dead_code_elimination", "pallas_fusion", "generic_elementwise_fusion"):
            opts.setdefault("fetch_vids", list(fetch_vids))
        apply_pass(clone, name, **opts)
        applied.append(name)
    return clone, applied


def _verify_export(base, program, fetch_vids, applied):
    """Verify mode: the exported clone is verified for the export's fetch
    frontier, and checked against the unrewritten program when only
    numerics-preserving passes ran."""
    from paddle_tpu_torch._core import flags

    if not flags.flag("FLAGS_verify_programs"):
        return
    from .verify import differential_check, verify_program

    verify_program(program, fetch_vids)
    if program is not base and set(applied) <= NUMERICS_PRESERVING:
        device = next((t.device for vid, t in base.param_inits.items()
                       if isinstance(t, torch.Tensor)), torch.device("cpu"))
        differential_check(base, program, fetch_vids, device=device)


def write_artifact(path_prefix, captures, scope=None, passes=None, dynamic=()):
    """Write the artifact of ``captures``: one (program, feed vars, fetch
    vars), or one for each of several batch sizes (``{batch: capture}``),
    whose descriptions merge into one with the batch symbolic.  ``dynamic``
    lists (feed index, axis) pairs the manifest marks ``None``."""
    scope = scope or global_scope()
    batched = isinstance(captures, dict)
    items = list(captures.items()) if batched else [(None, captures)]
    descs, applied = [], []
    for _, (program, feed_vars, fetch_vars) in items:
        fetch_vids = [v._vid for v in fetch_vars]
        optimized, applied = _optimized(program, fetch_vids, passes)
        _verify_export(program, optimized, fetch_vids, applied)
        descs.append(_describe_program(optimized, feed_vars, fetch_vars) + (optimized,))
    desc, consts, state_vids, program = descs[0]
    if batched:
        sizes = [b for b, _ in items]
        desc = _merge([d[0] for d in descs], sizes)
        for key, t in consts.items():
            if any(not torch.equal(t, d[1][key]) for d in descs[1:]):
                raise ValueError(f"const {key} differs between batch sizes {sizes}: the "
                                 "program is not batch-polymorphic (build it from the inputs)")
    params = {k: v.detach().cpu() for k, v in
              _state_values(program, scope, state_vids).items()}
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with atomic_write(path_prefix + ".pdmodel") as f:
        f.write(_pack(desc, consts))
    with atomic_write(path_prefix + ".pdiparams") as f:
        torch.save(params, f)
    _, feed_vars, fetch_vars = items[0][1]
    dyn = set(dynamic)

    def spec(i, v, name, feed):
        shape = [None if (feed and (i, a) in dyn) else d for a, d in enumerate(v.shape)]
        return {"name": name, "shape": shape, "dtype": _dtype_name(v.dtype)}

    manifest = {
        "feed": [spec(i, v, n, True) for i, (v, n) in
                 enumerate(zip(feed_vars, desc["names"]["feeds"]))],
        "fetch": [spec(i, v, n, False) for i, (v, n) in
                  enumerate(zip(fetch_vars, desc["names"]["fetches"]))],
        "format": FORMAT, "passes": applied, "precision": "float32",
        "batch": "symbolic" if batched else "captured",
    }
    with atomic_write(path_prefix + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    return path_prefix


def save_inference_model(path_prefix: str, feed_vars, fetch_vars, executor=None, program=None,
                         passes=None, precision=None, **kwargs):
    """Write ``<prefix>.pdmodel``, ``<prefix>.pdiparams`` and
    ``<prefix>.json`` (module docstring).  The state is the scope's
    (trained) values.  ``passes`` run on a ``clone(for_test=True)`` with
    the export's fetch frontier; ``precision`` / ``extra_precisions`` other
    than float32 raise (their passes are not ported)."""
    _check_precision(precision, kwargs.pop("extra_precisions", None))
    feed_vars = list(feed_vars)
    fetch_vars = list(fetch_vars) if isinstance(fetch_vars, (list, tuple)) else [fetch_vars]
    if program is None:
        program = (feed_vars[0]._program if feed_vars and isinstance(feed_vars[0], Variable)
                   else default_main_program())
    dynamic = [(i, a) for i, v in enumerate(feed_vars) for a in v.dynamic_dims]
    return write_artifact(path_prefix, (program, feed_vars, fetch_vars), passes=passes,
                          dynamic=dynamic)


def load_inference_model(path_prefix: str, executor=None, **kwargs):
    """``(predictor, feed names, fetch names)``: the Predictor serving the
    artifact on the executor's device (the card by default)."""
    from paddle_tpu_torch.inference import Config, Predictor

    config = Config(path_prefix)
    if executor is not None and executor.place.type == "cpu":
        config.disable_gpu()
    pred = Predictor(config)
    return pred, pred.get_input_names(), pred.get_output_names()
