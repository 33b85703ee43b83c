"""``paddle.inference``: the serving path (counterpart of
paddle_tpu/inference/__init__.py).

The JAX package's Predictor calls the StableHLO it deserialised
(``exported.call``).  Here the Predictor rebuilds the saved Program
through the op registry (``static/io.py``) and runs it with the port's
``static.Executor`` in a scope of its own: the flags' pass pipeline
(``PallasFusionPass`` puts BERT's residual adds + LayerNorms and its
linear + GELUs on the hand-written kernels), then one recorded CUDA graph
per feed signature.  A ``None`` batch in the artifact is rebuilt for each
batch size the Predictor sees, each with its own graph.  It runs on the
card unless ``Config.disable_gpu()`` asks for the CPU.

``Config``'s switches work or warn, never silently do nothing.  Precision
variants (``set_precision`` other than float32) and tensor parallelism
raise, naming the ROADMAP items that port their passes.
"""

from __future__ import annotations

import json
import time
import warnings

import numpy as np
import torch

__all__ = ["Config", "Predictor", "create_predictor", "PrecisionType"]


class PrecisionType:
    """AnalysisConfig::Precision's names."""

    Float32 = "float32"
    Half = "float16"
    Bfloat16 = "bfloat16"
    Int8 = "weight_only_int8"


def _warn_unsupported(switch, why):
    warnings.warn(f"inference.Config.{switch}: {why}", RuntimeWarning, stacklevel=3)


class Config:
    """AnalysisConfig: the artifact's path and the serving switches."""

    def __init__(self, model_path=None, params_path=None):
        self.model_path = model_path
        self.params_path = params_path
        self._device = None  # the card
        self._warmup = False
        self._profile = False

    def set_model(self, model_path, params_path=None):
        self.model_path = model_path
        self.params_path = params_path

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0, precision=None):
        """Serve on the card (the default); ``device_id`` picks the card.
        The memory pool is PyTorch's caching allocator (the size warns)."""
        if memory_pool_init_size_mb != 100:
            _warn_unsupported("enable_use_gpu", "memory_pool_init_size_mb is managed by "
                              "PyTorch's caching allocator; the argument is ignored")
        self._device = f"cuda:{int(device_id)}"
        if precision is not None:
            self.set_precision(precision)
        return self

    def disable_gpu(self):
        self._device = "cpu"
        return self

    def use_gpu(self):
        return self._device != "cpu"

    def set_precision(self, precision):
        """Only the artifact's own precision is served: cast the model
        before export for bf16."""
        p = str(precision).lower()
        if p not in ("float32", "fp32"):
            raise NotImplementedError(
                f"inference precision {precision!r}: precision variants need the fp16 and "
                "weight-only program passes, not ported yet (ROADMAP.md A.5.6 "
                "weight_only_quant, A.6 auto_parallel_fp16)")
        return self

    def enable_tensorrt_engine(self, workspace_size=1 << 30, max_batch_size=1,
                               min_subgraph_size=3, precision=None, use_static=False,
                               use_calib_mode=False):
        _warn_unsupported("enable_tensorrt_engine", "the hand-written kernels and the "
                          "recorded CUDA graph serve the whole program (no TensorRT subgraph "
                          "engine); the tuning arguments do not apply")
        if precision is not None:
            self.set_precision(precision)
        return self

    def enable_memory_optim(self, *a, **k):
        _warn_unsupported("enable_memory_optim", "each run already drops every value after "
                          "its last reader (Program.as_function); the switch adds nothing")

    def switch_ir_optim(self, flag=True):
        if not flag:
            _warn_unsupported("switch_ir_optim", "the pass pipeline follows the flags "
                              "(FLAGS_use_pallas_fusion); set them instead")

    def switch_ir_debug(self, *a, **k):
        _warn_unsupported("switch_ir_debug", "per-pass IR dumps are not written; print "
                          "the Predictor's program (Program.to_string) instead")

    def enable_mkldnn(self, *a, **k):
        _warn_unsupported("enable_mkldnn", "CPU serving runs PyTorch's own CPU kernels")

    def set_cpu_math_library_num_threads(self, n):
        _warn_unsupported("set_cpu_math_library_num_threads", "set torch.set_num_threads "
                          "in the serving process instead")

    def set_optim_cache_dir(self, path):
        """Where the schedule search's verdicts persist
        (``FLAGS_autotune_cache_dir``)."""
        from paddle_tpu_torch import set_flags

        set_flags({"FLAGS_autotune_cache_dir": str(path)})
        return self

    def disable_glog_info(self):
        import logging

        logging.getLogger("paddle_tpu_torch").setLevel(logging.WARNING)
        return self

    def enable_profile(self):
        """Per-run latency on the Predictor (``profile_stats()``)."""
        self._profile = True
        return self

    def enable_warmup(self):
        """Run once on zeros at load, so the first request pays no build or
        recording."""
        self._warmup = True
        return self

    def enable_tensor_parallel(self, mesh, input_specs=None):
        raise NotImplementedError("tensor-parallel serving is not ported yet (ROADMAP.md A.6)")


def _prefix(path):
    return path[: -len(".pdmodel")] if path.endswith(".pdmodel") else path


class _InputHandle:
    def __init__(self, pred, name):
        self._pred, self._name = pred, name

    def copy_from_cpu(self, arr):
        self._pred._inputs[self._name] = np.asarray(arr)

    def reshape(self, shape):
        """Accepted for the reference's signature: the copied array's own
        shape is used."""

    def shape(self):
        return list(self._pred._inputs[self._name].shape)


class _OutputHandle:
    def __init__(self, pred, name):
        self._pred, self._name = pred, name

    def copy_to_cpu(self):
        out = self._pred._last[self._pred._output_names.index(self._name)]
        if isinstance(out, torch.Tensor):  # a run with return_numpy=False
            out = out.detach().to("cpu", torch.float32 if out.dtype == torch.bfloat16
                                  else out.dtype).numpy()
        return out

    def shape(self):
        return list(self.copy_to_cpu().shape)


class Predictor:
    """Serves a ``save_inference_model`` / ``jit.save`` artifact."""

    def __init__(self, path_prefix_or_config):
        from paddle_tpu_torch._core.device import resolve_device
        from paddle_tpu_torch.static import Executor, Scope
        from paddle_tpu_torch.static.io import _unpack

        cfg = path_prefix_or_config
        if not isinstance(cfg, Config):
            cfg = Config(cfg)
        self.prefix = _prefix(cfg.model_path)
        with open(self.prefix + ".json") as f:
            self.manifest = json.load(f)
        with open(self.prefix + ".pdmodel", "rb") as f:
            self._desc, self._consts = _unpack(f)
        self.place = resolve_device(cfg._device)
        params = torch.load(self.prefix + ".pdiparams", map_location="cpu", weights_only=True)
        self._params = {k: v.to(self.place) for k, v in params.items()}
        self._symbolic = self.manifest.get("batch") == "symbolic"
        self._programs: dict = {}  # batch size (None: the captured one) -> (program, feeds, fetches)
        self._exe = Executor(self.place)
        self._scope = Scope()
        self._input_names = [s["name"] for s in self.manifest["feed"]]
        self._output_names = [s["name"] for s in self.manifest["fetch"]]
        self._dyn = [[a for a, d in enumerate(s["shape"]) if d is None]
                     for s in self.manifest["feed"]]
        self._inputs: dict = {}
        self._last = []
        self._profile = cfg._profile
        self._stats = {"count": 0, "total_ms": 0.0, "last_ms": 0.0}
        if cfg._warmup:
            self.warmup()

    def _program(self, vals):
        """The program for these feeds: the captured one, or the one
        rebuilt for their batch size (the first ``None`` axis)."""
        from paddle_tpu_torch.static.io import build_program

        batch = None
        if self._symbolic:
            i, axes = next((i, a) for i, a in enumerate(self._dyn) if a)
            batch = int(vals[i].shape[axes[0]])
        if batch not in self._programs:
            self._programs[batch] = build_program(self._desc, self._consts, self._params,
                                                  self.place, batch)
        return self._programs[batch]

    def get_input_names(self):
        return list(self._input_names)

    def get_output_names(self):
        return list(self._output_names)

    def get_input_handle(self, name):
        return _InputHandle(self, name)

    def get_output_handle(self, name):
        return _OutputHandle(self, name)

    def _run(self, vals, return_numpy=True):
        program, feeds, fetches = self._program(vals)
        if len(vals) != len(feeds):
            raise ValueError(f"{len(vals)} inputs for {len(feeds)} feeds")
        return self._exe.run(program, feed={v.name: x for v, x in zip(feeds, vals)},
                             fetch_list=fetches, scope=self._scope, return_numpy=return_numpy)

    def run(self, inputs=None, return_numpy=True):
        """The outputs for ``inputs`` (numpy arrays or tensors in feed
        order), or for the arrays copied into the input handles; numpy
        arrays, or tensors on the Predictor's device with
        ``return_numpy=False``."""
        t0 = time.perf_counter()
        vals = list(inputs) if inputs is not None else [self._inputs[n]
                                                        for n in self._input_names]
        out = self._run(vals, return_numpy)
        self._last = out
        if self._profile:
            if self.place.type == "cuda":
                torch.cuda.synchronize(self.place)
            dt = (time.perf_counter() - t0) * 1e3
            self._stats["count"] += 1
            self._stats["total_ms"] += dt
            self._stats["last_ms"] = dt
        return out

    __call__ = run

    def warmup(self):
        """One run on zeros of the manifest's shapes (a ``None`` dim as 1):
        the kernels build and the run is recorded before traffic."""
        dtypes = {"bfloat16": torch.float32}
        zeros = [np.zeros([1 if d is None else d for d in s["shape"]],
                          dtype=str(dtypes.get(s["dtype"], s["dtype"])).removeprefix("torch."))
                 for s in self.manifest["feed"]]
        self._run(zeros)
        return self

    def profile_stats(self):
        """{count, total_ms, avg_ms, last_ms} with ``Config.enable_profile()``."""
        s = dict(self._stats)
        s["avg_ms"] = s["total_ms"] / s["count"] if s["count"] else 0.0
        return s

    def clone(self):
        """A handle for another serving thread: the same programs and
        weights, its own Executor (its own recorded runs and their fixed
        buffers) and its own input and output bindings."""
        from paddle_tpu_torch.static import Executor, Scope

        twin = object.__new__(Predictor)
        twin.__dict__.update(self.__dict__)
        twin._exe, twin._scope = Executor(self.place), Scope()
        twin._inputs = {}
        twin._last = []
        twin._stats = {"count": 0, "total_ms": 0.0, "last_ms": 0.0}
        return twin


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)
