"""Functional ops of the port: attention, linear, dropout, activations,
layer and batch norm, convolutions, pooling and cross-entropy."""
from paddle_tpu_torch.nn.functional.activation import gelu, relu  # noqa: F401
from paddle_tpu_torch.nn.functional.attention import (  # noqa: F401
    flash_attention, scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import dropout, linear  # noqa: F401
from paddle_tpu_torch.nn.functional.conv import (  # noqa: F401
    conv1d, conv2d, conv3d)
from paddle_tpu_torch.nn.functional.loss import cross_entropy  # noqa: F401
from paddle_tpu_torch.nn.functional.norm import (  # noqa: F401
    batch_norm, layer_norm)
from paddle_tpu_torch.nn.functional.pooling import (  # noqa: F401
    adaptive_avg_pool2d, avg_pool2d, max_pool2d)
