"""Functional ops of the port: attention, and what the transformer layers
need (linear, dropout, relu, gelu, layer_norm)."""
from paddle_tpu_torch.nn.functional.activation import gelu, relu  # noqa: F401
from paddle_tpu_torch.nn.functional.attention import (  # noqa: F401
    flash_attention, scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import dropout, linear  # noqa: F401
from paddle_tpu_torch.nn.functional.norm import layer_norm  # noqa: F401
