"""Layers of the port: what the transformer encoder needs."""
from paddle_tpu_torch.nn.layer.common import Dropout, Linear  # noqa: F401
from paddle_tpu_torch.nn.layer.norm import LayerNorm  # noqa: F401
from paddle_tpu_torch.nn.layer.transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoder, TransformerEncoderLayer)
