"""paddle_tpu_torch.jit — the training step (counterpart of paddle_tpu/jit).

The JAX package traces the step into one ``jax.jit`` program per batch
signature, with the state donated, and ``lower``/``warmup`` compile it
ahead of traffic.  Here the same step is recorded as a CUDA graph
(``_core/graphs.py``), once per batch signature (shapes and dtypes, the
JAX package's ``_batch_sig``):

- the first call of a signature copies the batch into fixed buffers and
  runs the real step as the capture's warm-up (its loss is that call's
  result), then records the step;
- every later call copies the batch into the buffers, syncs the
  learning rate into the optimizer's rate tensor and replays, and returns
  a fresh loss tensor (a replay overwrites the graph's own);
- the parameters, their grads, the model's buffers (BatchNorm's running
  statistics, which the step writes in place), the f32 masters, moments,
  beta powers, the rate and the device RNG state that dropout draws from
  (``_core/random.py``) stay at fixed addresses, updated in place, so
  each replay draws fresh masks, the eager step's from the same state.
  A state tensor rebound between calls (``p.data = ...``, a buffer
  reassigned, an accumulator created by ``set_state_dict``) makes the
  step record again, never replay stale addresses.

After a replay the visible state is the eager step's: grads are None
and ``state_dict()["step_count"]`` counts the steps run.  On the CPU the
same step runs eagerly at every call, as everywhere in this package.
With an enabled ``amp.GradScaler`` (``scaler=``) the body is
``scaler.scale(loss).backward(); scaler.step(optimizer)``, and the
scaler's scale and step counts join the state at fixed addresses: a
skipped step is a select on the device, the same eager and recorded.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch._core import graphs
from paddle_tpu_torch._core import random as rng

__all__ = ["TrainStep"]


def _batch_sig(batch):
    """The batch's signature: each leaf's shape and dtype."""
    return tuple((tuple(b.shape), b.dtype) for b in batch)


def _leaves(batch):
    return tuple(b if isinstance(b, torch.Tensor) else torch.as_tensor(b) for b in batch)


class _CapturedStep:
    """One signature's recorded step: fixed batch buffers, the state key
    it was recorded over, and the ``graphs.Captured`` step returning the
    loss.  ``first_loss`` is the warm-up call's loss (None on the CPU,
    where nothing runs before the first replay)."""

    def __init__(self, train_step, batch, device, rolled_back):
        self.inputs = [torch.empty(b.shape, dtype=b.dtype, device=device) for b in batch]
        for buf, b in zip(self.inputs, batch):
            buf.copy_(b)
        opt = train_step.optimizer
        count = opt._step_count
        snapshot = train_step._snapshot() if rolled_back else None
        try:
            self.step = graphs.capture(lambda: train_step._eager_step(*self.inputs), device)
        finally:
            # recording runs the step's Python, not a step: the count is
            # the warm-up call's (rolled back with the rest for a warmup)
            opt._step_count = count + (device.type == "cuda" and not rolled_back)
            if snapshot is not None:
                train_step._restore(snapshot)
        self.state_key = train_step._state_key()
        self.first_loss = None
        if self.step.warm_outputs is not None and not rolled_back:
            self.first_loss = self.step.warm_outputs.clone()

    def run(self, batch, optimizer):
        for buf, b in zip(self.inputs, batch):
            buf.copy_(b)
        optimizer._sync_lr()
        loss = self.step.replay()
        if self.step._graph is not None:
            optimizer._step_count += 1  # the eager body counts its own
        return loss.clone()


class Lowered:
    """``TrainStep.lower``'s result: the step for one batch signature,
    with the optimizer's accumulators created; ``compile()`` records it
    (the JAX ``Lowered.compile()``) and returns the recorded step, which
    ``TrainStep.warmup`` stores under the signature."""

    def __init__(self, train_step, batch):
        self._train_step = train_step
        self._batch = batch
        self.signature = _batch_sig(batch)

    def compile(self):
        """Record the step on zeros of the signature: the warm-up call
        runs for real and is rolled back, so no state advances."""
        ts = self._train_step
        zeros = [torch.zeros(b.shape, dtype=b.dtype, device=ts.device) for b in self._batch]
        return _CapturedStep(ts, zeros, ts.device, rolled_back=True)


class TrainStep:
    """``step = TrainStep(model, optimizer, loss_fn)``; ``step(*batch)`` runs
    ``loss_fn(model, *batch)``, its backward, ``optimizer.step()`` and
    ``optimizer.clear_grad()``, and returns the detached 0-d loss.  On the
    card the step is a CUDA graph per batch signature (module docstring);
    a replay starts from no grads, so clear any ``.grad`` set outside the
    step first (a replay raises otherwise).  ``lower(*batch)`` and
    ``warmup(*batch)`` take tensors or ``meta`` tensors (the signature
    only)."""

    def __init__(self, model, optimizer, loss_fn, scaler=None):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.scaler = scaler if scaler is not None and scaler.is_enable() else None
        self._steps: dict = {}  # batch signature -> _CapturedStep
        self.captures = 0  # steps recorded, re-recordings included

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ----------------------------------------------------------------- state
    def _params(self):
        return [p for p in self.optimizer._parameter_list if p.requires_grad]

    def _buffers(self):
        """The model's buffers in its ``state_dict`` (BatchNorm's running
        statistics), as the JAX package's step state holds the whole
        state dict; non-persistent ones (caches) are left out."""
        return [t for t in self.model.state_dict(keep_vars=True).values()
                if not isinstance(t, torch.nn.Parameter)]

    def _state(self):
        """Every tensor a recorded step reads at a fixed address: the
        parameters, the model's buffers, then the optimizer's accumulators
        and rate, then the scaler's scale and counts, then the device's RNG
        state."""
        scaler = [] if self.scaler is None else self.scaler.state_tensors()
        return (self._params() + self._buffers() + self.optimizer.opt_state_tensors() + scaler
                + [rng.state_tensor(self.device)])

    def _state_key(self):
        return (tuple(self.optimizer._accumulators),
                tuple((id(t), t.data_ptr()) for t in self._state()))

    def _snapshot(self):
        """Copies of the state, and the grads, which are taken off the
        parameters (a rolled-back step must not add into them)."""
        grads = [(p, p.grad) for p in self._params()]
        for p, _ in grads:
            p.grad = None
        return [(t, t.detach().clone()) for t in self._state()], grads

    @staticmethod
    @torch.no_grad()
    def _restore(snapshot):
        values, grads = snapshot
        for t, v in values:
            t.copy_(v)
        for p, g in grads:
            p.grad = g

    # ------------------------------------------------------------------ step
    def _eager_step(self, *batch):
        loss = self.loss_fn(self.model, *batch)
        if self.scaler is not None:
            self.scaler.scale(loss).backward()
            self.scaler.step(self.optimizer)
        else:
            loss.backward()
            self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()

    def __call__(self, *batch):
        batch = _leaves(batch)
        sig = _batch_sig(batch)
        entry = self._steps.get(sig)
        if entry is not None and entry.state_key == self._state_key():
            if entry.step._graph is not None and any(
                    p.grad is not None for p in self._params()):
                raise RuntimeError(
                    "TrainStep: a parameter holds a .grad set outside the step; a recorded "
                    "step starts from no grads (call optimizer.clear_grad() first)")
            return entry.run(batch, self.optimizer)
        entry = self._steps[sig] = _CapturedStep(self, batch, self.device, rolled_back=False)
        self.captures += 1
        loss = entry.first_loss
        if loss is None:  # the CPU: the body's first call
            loss = entry.run(batch, self.optimizer)
            entry.state_key = self._state_key()  # with the accumulators it created
        return loss

    def lower(self, *batch):
        """Create the optimizer's accumulators (a rolled-back step on zero
        grads) and return the ``Lowered`` step for ``batch``'s signature;
        nothing is stored and no state advances."""
        self.optimizer._journaled_step(self._params())
        return Lowered(self, _leaves(batch))

    def warmup(self, *batch):
        """Record the step for ``batch``'s signature ahead of traffic:
        ``lower(...).compile()``, stored under the signature.  Every
        parameter, master, moment, beta power, the rate, the step count
        and every ``.grad`` are left bit for bit as they were.  Returns
        ``self``."""
        lowered = self.lower(*batch)
        self._steps[lowered.signature] = lowered.compile()
        self.captures += 1
        return self
