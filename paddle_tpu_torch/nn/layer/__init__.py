"""Layers of the port: the base class ``Layer`` and the containers
``Sequential``, ``LayerList`` and ``ParameterList``; ``ParamAttr``,
linear, the dropouts, embedding, flatten, upsampling, bilinear, the
distances, pads, fold / unfold, pixel shuffle, the activations, norms,
convolutions and their transposes, pooling, the loss layers, the
recurrent layers and the transformer.  Every layer derives from
``Layer``."""

from paddle_tpu_torch.nn.layer.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign, Swish, Tanh,
    Tanhshrink, ThresholdedReLU)
from paddle_tpu_torch.nn.layer.common import (  # noqa: F401
    AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D, Dropout3D,
    Embedding, Flatten, Fold, Identity, Linear, Pad1D, Pad2D, Pad3D,
    PairwiseDistance, ParamAttr, PixelShuffle, Unfold, Upsample,
    UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D)
from paddle_tpu_torch.nn.layer.conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose)
from paddle_tpu_torch.nn.layer.layers import (  # noqa: F401
    HookRemoveHelper, Layer, LayerList, ParameterList, Sequential)
from paddle_tpu_torch.nn.layer.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, HingeEmbeddingLoss, HSigmoidLoss, KLDivLoss, L1Loss,
    MarginRankingLoss, MSELoss, NCELoss, NLLLoss, SigmoidFocalLoss,
    SmoothL1Loss, SoftMarginLoss, TripletMarginLoss)
from paddle_tpu_torch.nn.layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from paddle_tpu_torch.nn.layer.pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D)
from paddle_tpu_torch.nn.layer.rnn import (  # noqa: F401
    GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase, SimpleRNN,
    SimpleRNNCell)
from paddle_tpu_torch.nn.layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)
