"""Optimizer base (counterpart of paddle_tpu/optimizer/optimizer.py).

What is kept from the JAX package:
- per-parameter state ("accumulators") keyed by (name, parameter), created
  at the first step that reaches the parameter, or ahead of any step by
  ``_journaled_step`` (a rolled-back step on zero grads);
- the learning rate as a 0-d f32 tensor on the parameters' device
  (``_lr_t``): the updates read it there, ``set_lr`` and the scheduler
  (``_sync_lr``, between steps) write it in place, so a step captured as
  a CUDA graph reads every later rate;
- f32 master weights, always on for bf16 and fp16 parameters: the update
  reads and writes the f32 master and the parameter gets its cast, so
  updates below the bf16 ulp are not lost;
- ``weight_decay`` as a float is ``L2Decay``, or an ``L1Decay`` /
  ``L2Decay`` (``regularizer.py``): its gradient term is added to the
  gradient (taken from the master for low-precision parameters).  A
  parameter's own ``regularizer`` (``ParamAttr``) comes first, a
  coefficient of 0 disables the term, and decoupled optimizers (AdamW)
  skip the optimizer-level term and apply their own decay;
- ``grad_clip`` sees the ``(param, grad)`` pairs before the update;
- ``state_dict`` keys ``f"{name}_{param_index}"``, ``LR_Scheduler`` and
  ``step_count``; ``opt_state_tensors()`` lists the accumulators and the
  rate, the state a captured step reads and writes.

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

from paddle_tpu_torch.regularizer import L2Decay, WeightDecayRegularizer

from .lr import LRScheduler

__all__ = ["Optimizer"]

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _capturing(t) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


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
        device = self._parameter_list[0].device if self._parameter_list else None
        self._lr_t = torch.tensor(self.get_lr(), dtype=torch.float32, device=device)
        # the optimizer-level decay is always a regularizer (a float is L2Decay)
        if isinstance(weight_decay, WeightDecayRegularizer):
            self._regularizer = weight_decay
        elif weight_decay is None or isinstance(weight_decay, (int, float)):
            self._regularizer = L2Decay(float(weight_decay)) if weight_decay else None
        else:
            raise TypeError(f"weight_decay must be a float or a regularizer (L1Decay, "
                            f"L2Decay), got {type(weight_decay).__name__}")
        self._grad_clip = grad_clip
        self._accumulators: dict = {}
        self._step_count = 0
        # a 0-d bool device tensor while amp.GradScaler.step runs the update
        # (its found-inf flag): where it is set, every state write keeps
        # the old value (_put)
        self._skip = None

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
        self._lr_t.fill_(self._lr)

    def _sync_lr(self):
        """Write the scheduler's current rate into ``_lr_t``, in place (a
        no-op without a scheduler: ``set_lr`` writes it)."""
        if self._lr_scheduler is not None:
            self._lr_t.fill_(float(self._lr_scheduler.get_lr()))

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
    def _put(self, t, new):
        """``t <- new`` in place; under a scaler's skip flag a select on the
        device keeps ``t`` where the flag is set (no host sync)."""
        if self._skip is not None:
            new = torch.where(self._skip, t, new)
        t.copy_(new)

    def _single_update(self, p, value, g, lr):
        """The updated value of ``p`` from its current ``value`` (the f32
        master for low-precision parameters), its gradient ``g`` and the
        0-d f32 rate tensor ``lr``."""
        raise NotImplementedError

    def _decoupled_wd(self) -> bool:
        return False

    def _reg_grad_term(self, p, value):
        """The penalty gradient of ``p`` at ``value``, or None: its own
        regularizer first, else the optimizer's (not for decoupled decay);
        a zero coefficient is none."""
        reg = getattr(p, "regularizer", None)
        if reg is None:
            if self._decoupled_wd():
                return None
            reg = self._regularizer
        if reg is None or not reg.coeff:
            return None
        return reg._grad_term(value)

    @torch.no_grad()
    def step(self):
        # while a CUDA graph records the step, the rate is what the caller
        # synced into _lr_t before each replay: a fill here would be
        # recorded with this moment's value
        if not _capturing(self._lr_t):
            self._sync_lr()
        lr = self._lr_t
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
                reg = self._reg_grad_term(p, master)
                if reg is not None:
                    gv = gv.float() + reg
                self._put(master, self._single_update(p, master, gv, lr))
                self._put(p, master)
            else:
                reg = self._reg_grad_term(p, p)
                if reg is not None:
                    gv = gv + reg
                self._put(p, self._single_update(p, p, gv, lr))
        self._step_count += 1

    def _journaled_step(self, params):
        """Create the accumulators a step on ``params`` reaches, without a
        step: run ``step()`` on zero grads, then roll back every mutation,
        in place (every tensor keeps its address).  Parameters, grads, the
        rate tensor and the step count are restored from snapshots,
        accumulators that existed keep their values, and new ones are
        reset to the value their creation gave them (taken by a spy on
        ``_acc`` before the step updates them)."""
        pre = {k: t.clone() for k, t in self._accumulators.items()}
        fresh = {}
        orig_acc = self._acc

        def acc_spy(name, p, init=None, dtype=None):
            key = (name, id(p))
            existed = key in self._accumulators
            t = orig_acc(name, p, init=init, dtype=dtype)
            if not existed:
                fresh[key] = t.clone()
            return t

        saved = [(p, p.detach().clone(), p.grad) for p in params]
        saved_count, saved_lr = self._step_count, self._lr_t.clone()
        self._acc = acc_spy
        try:
            for p in params:
                p.grad = torch.zeros_like(p)
            self.step()
        finally:
            del self._acc  # the bound method again
            with torch.no_grad():
                for p, v, g in saved:
                    p.copy_(v)
                    p.grad = g
                for k, t in self._accumulators.items():
                    if k in pre:
                        t.copy_(pre[k])
                    elif k in fresh:
                        t.copy_(fresh[k])
                self._lr_t.copy_(saved_lr)
            self._step_count = saved_count

    def opt_state_tensors(self) -> list:
        """Every mutable optimizer state tensor: the accumulators, then the
        rate."""
        return list(self._accumulators.values()) + [self._lr_t]

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
