"""paddle_tpu_torch.vision (counterpart of paddle_tpu/vision): the ResNet
family of ``vision.models``.  ``transforms``, ``datasets``, ``ops`` and
the image backends are ROADMAP.md A.4."""

from . import models  # noqa: F401
