"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

What is kept from the JAX package:
- per-parameter state ("accumulators") keyed by (name, parameter), created
  at the first step that reaches the parameter;
- f32 master weights, always on for bf16 and fp16 parameters: the update
  reads and writes the f32 master and the parameter gets its cast, so
  updates below the bf16 ulp are not lost;
- ``weight_decay`` as a float is L2 decay added to the gradient (taken
  from the master for low-precision parameters); decoupled optimizers
  (AdamW) apply their own decay instead;
- ``grad_clip`` sees the ``(param, grad)`` pairs before the update;
- ``state_dict`` keys ``f"{name}_{param_index}"``, ``LR_Scheduler`` and
  ``step_count``.

``parameters`` may also be ``(name, param)`` pairs, as
``model.named_parameters()`` gives them, or a list of parameter groups
(``{"params": [...], ...}`` dicts, flattened; their other keys are kept
in ``_param_groups`` and ignored, as in the JAX package): a torch tensor's ``name`` cannot
be set, so this is where the port finds the name that the JAX package
reads from ``param.name`` (``apply_decay_param_fun``); a bare tensor's
name is "".

What differs, in PyTorch idiom: gradients are ``p.grad``; the parameters,
master weights and moments are updated in place under ``torch.no_grad()``
(JAX rebinds new arrays), which keeps the optimizer's memory at one copy
of each state tensor; the update math is plain torch per parameter, as
it is plain jnp there.  ``torch.optim`` is not used: it keeps no master
weights and names its state otherwise.
"""

from __future__ import annotations

import torch

from .lr import LRScheduler

__all__ = ["Optimizer"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        if parameters is None:
            raise ValueError("parameters must be provided")
        self._names: dict = {}
        items = list(parameters)
        # parameter groups: a list of {"params": [...], ...} dicts is
        # flattened, as the JAX package does; per-group options are kept
        # in _param_groups and, as there, not applied
        groups = items if items and isinstance(items[0], dict) else [{"params": items}]
        self._parameter_list = []
        self._param_groups = []
        for group in groups:
            params = [self._unpack(item) for item in group["params"]]
            self._parameter_list.extend(params)
            self._param_groups.append({**group, "params": params})

        self._lr_scheduler = learning_rate if isinstance(learning_rate, LRScheduler) else None
        self._lr = None if self._lr_scheduler is not None else float(learning_rate)
        if weight_decay is None or isinstance(weight_decay, (int, float)):
            self._weight_decay = float(weight_decay or 0.0)
        else:
            raise NotImplementedError(
                f"weight_decay {type(weight_decay).__name__}: regularizer objects are not "
                "ported yet (ROADMAP.md A.3.3); pass a float (L2 decay)")
        self._grad_clip = grad_clip
        self._accumulators: dict = {}
        self._step_count = 0

    def _unpack(self, item):
        """A parameter, or a ``(name, param)`` pair whose name is kept."""
        if isinstance(item, tuple):
            name, item = item
            self._names[id(item)] = name
        return item

    def _param_name(self, p) -> str:
        return self._names.get(id(p), "")

    # ------------------------------------------------------------------- lr
    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler.get_lr())
        return self._lr

    def set_lr(self, value: float):
        if self._lr_scheduler is not None:
            raise RuntimeError("can't set_lr when using an LRScheduler")
        self._lr = float(value)

    # ---------------------------------------------------------- accumulators
    def _acc(self, name: str, p: torch.Tensor, init=None, dtype=None) -> torch.Tensor:
        key = (name, id(p))
        if key not in self._accumulators:
            if init is None:
                value = torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device)
            else:
                value = init() if callable(init) else init
            self._accumulators[key] = value
        return self._accumulators[key]

    # ---------------------------------------------------------------- update
    def _single_update(self, p, value, g, lr):
        """The updated value of ``p`` from its current ``value`` (the f32
        master for low-precision parameters) and its gradient ``g``."""
        raise NotImplementedError

    def _decoupled_wd(self) -> bool:
        return False

    def _reg_grad_term(self, value):
        if self._decoupled_wd() or not self._weight_decay:
            return None
        return self._weight_decay * value

    @torch.no_grad()
    def step(self):
        lr = self.get_lr()
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        for p, g in params_grads:
            if g is None:
                continue
            if g.is_sparse:
                raise NotImplementedError(
                    "sparse (SelectedRows) gradient updates are not ported yet "
                    "(ROADMAP.md A.3.5)")
            gv = g.float() if g.dtype == torch.float16 else g
            if p.dtype in _LOW_PRECISION:
                master = self._acc("master_weight", p, init=lambda p=p: p.detach().float())
                reg = self._reg_grad_term(master)
                if reg is not None:
                    gv = gv.float() + reg
                master.copy_(self._single_update(p, master, gv, lr))
                p.copy_(master)
            else:
                reg = self._reg_grad_term(p)
                if reg is not None:
                    gv = gv + reg
                p.copy_(self._single_update(p, p, gv, lr))
        self._step_count += 1

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if set_to_zero and p.grad is not None:
                p.grad.zero_()
            else:
                p.grad = None

    # ------------------------------------------------------------ state dict
    def _param_index(self, pid):
        return next((i for i, p in enumerate(self._parameter_list) if id(p) == pid), None)

    def state_dict(self) -> dict:
        out = {f"{name}_{self._param_index(pid)}": t
               for (name, pid), t in self._accumulators.items()}
        out["LR_Scheduler"] = (self._lr_scheduler.state_dict() if self._lr_scheduler is not None
                               else {"lr": self._lr})
        out["step_count"] = self._step_count
        return out

    def set_state_dict(self, state: dict):
        """Load accumulators saved by ``state_dict``; an accumulator this
        optimizer has not created yet is created from the saved value."""
        index = {f"{name}_{self._param_index(pid)}": (name, pid)
                 for name, pid in self._accumulators}
        for key, value in state.items():
            if key in ("LR_Scheduler", "step_count"):
                continue
            name, _, idx = key.rpartition("_")
            if key in index:
                self._accumulators[index[key]].copy_(value)
            elif idx.isdigit() and int(idx) < len(self._parameter_list):
                p = self._parameter_list[int(idx)]
                self._accumulators[(name, id(p))] = value.detach().clone().to(p.device)
        if "LR_Scheduler" in state and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(state["LR_Scheduler"])
        self._step_count = state.get("step_count", self._step_count)
