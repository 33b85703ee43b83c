"""paddle_tpu_torch — the PyTorch and CUDA port of paddle_tpu for the H100.

The package mirrors paddle_tpu's layout so each counterpart sits at the
same path, in PyTorch idiom: ``nn.Module``s and plain functions on
``torch.Tensor``, an explicit ``device`` argument, explicit
``torch.Generator``s for sampling.  The TPU's Pallas kernels become
kernels written by hand for Hopper (``ops``), each beside a plain
PyTorch version that the CPU tests hold against the JAX package.

It imports neither JAX nor anything of paddle_tpu.  Entry points
(``models.LlamaForCausalLM``, ``models.GPTForCausalLM``,
``models.BertForSequenceClassification``,
``serving.GenerationEngine``, ``static.Executor``,
``device.time_step_ms``) run on the CUDA card unless the caller passes
``device="cpu"`` (``place="cpu"`` for the Executor).  Training runs
``jit.TrainStep`` over ``LlamaForCausalLM(ids, labels=)`` or
``GPTForCausalLM(ids, labels=)`` (dropout in training, its masks drawn
from the device RNG state that ``seed`` resets) with ``optimizer.AdamW``
or any of the other optimizers, in mixed precision under ``amp.auto_cast`` (with an
``amp.GradScaler`` for f16); ``LlamaForCausalLM.generate`` decodes
without an engine; ``vision.models.resnet50`` (and the rest of the
ResNet family) trains through the same ``TrainStep``, its BatchNorms'
running statistics part of the recorded step; ``static.program_guard`` captures a model into a
``static.Program`` that ``static.Executor`` runs through the fusion pass.
"""

from . import (_core, amp, convert, device, jit, models, nn, ops, optimizer,  # noqa: F401
               regularizer, serving, static, vision)
from ._core.flags import get_flags, set_flags  # noqa: F401
from ._core.random import get_rng_state, seed, set_rng_state  # noqa: F401
from .nn import ParamAttr  # noqa: F401

__version__ = "0.1.0"
