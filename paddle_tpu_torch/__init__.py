"""paddle_tpu_torch — the PyTorch and CUDA port of paddle_tpu for the H100.

The package mirrors paddle_tpu's layout so each counterpart sits at the
same path, in PyTorch idiom: ``nn.Module``s and plain functions on
``torch.Tensor``, an explicit ``device`` argument, explicit
``torch.Generator``s for sampling.  The TPU's Pallas kernels become
kernels written by hand for Hopper (``ops``), each beside a plain
PyTorch version that the CPU tests hold against the JAX package.

It imports neither JAX nor anything of paddle_tpu.  Entry points
(``models.LlamaForCausalLM``, ``models.BertForSequenceClassification``,
``serving.GenerationEngine``, ``static.Executor``,
``device.time_step_ms``) run on the CUDA card unless the caller passes
``device="cpu"`` (``place="cpu"`` for the Executor).  Training runs
``jit.TrainStep`` over ``LlamaForCausalLM(ids, labels=)`` with
``optimizer.AdamW``; ``static.program_guard`` captures a model into a
``static.Program`` that ``static.Executor`` runs through the fusion pass.
"""

from . import (_core, convert, device, jit, models, nn, ops, optimizer, serving,  # noqa: F401
               static)
from ._core.flags import get_flags, set_flags  # noqa: F401

__version__ = "0.1.0"
