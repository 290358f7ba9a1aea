"""Vision of the port (port of paddle_tpu/vision): the models and the
image transforms.  ``vision.ops`` is not ported yet (ROADMAP Queue 1 item
2b)."""
from paddle_tpu_torch.vision import models, transforms  # noqa: F401

__all__ = ["models", "transforms"]
