"""Neural-network layers, functionals and gradient clipping of the port."""
from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn.clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_)
from paddle_tpu_torch.nn.layer import (  # noqa: F401
    AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D, BatchNorm2D,
    BatchNorm3D, Conv1D, Conv2D, Conv3D, Dropout, Flatten, LayerNorm, Linear,
    MaxPool2D, MultiHeadAttention, ReLU, Sequential, TransformerEncoder,
    TransformerEncoderLayer)
