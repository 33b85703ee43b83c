"""paddle_tpu_torch.jit — the training step (counterpart of paddle_tpu/jit).

The JAX package traces the step into one XLA program; PyTorch runs
eagerly, so ``TrainStep`` is the JAX package's eager step: the same
semantics with no tracing.  Capturing the step in a CUDA graph, AMP's
``scaler``, and ahead-of-time ``lower``/``warmup`` are not ported yet.
"""

from __future__ import annotations

__all__ = ["TrainStep"]


class TrainStep:
    """``step = TrainStep(model, optimizer, loss_fn)``; ``step(*batch)`` runs
    ``loss_fn(model, *batch)``, its backward, ``optimizer.step()`` and
    ``optimizer.clear_grad()``, and returns the detached 0-d loss."""

    def __init__(self, model, optimizer, loss_fn, scaler=None):
        if scaler is not None:
            raise NotImplementedError(
                "TrainStep(scaler=): amp (auto_cast, GradScaler) is not ported yet "
                "(ROADMAP.md queue A item 2)")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn

    def __call__(self, *batch):
        loss = self.loss_fn(self.model, *batch)
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()

    def lower(self, *batch):
        raise NotImplementedError(
            "TrainStep.lower: capturing the step (a CUDA graph over it) is not ported yet "
            "(ROADMAP.md queue A item 2)")

    def warmup(self, *batch):
        raise NotImplementedError(
            "TrainStep.warmup: capturing the step (a CUDA graph over it) is not ported yet "
            "(ROADMAP.md queue A item 2)")
