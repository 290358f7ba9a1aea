"""Neural-network layers (on the base class ``Layer``), functionals,
initializers, ``utils``, decoding and gradient clipping of the port."""
from paddle_tpu_torch.nn import functional, initializer, utils  # noqa: F401
from paddle_tpu_torch.nn.clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_)
from paddle_tpu_torch.nn.decode import (  # noqa: F401
    BeamSearchDecoder, Decoder, dynamic_decode, gather_tree)
from paddle_tpu_torch.nn.layer import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AlphaDropout,
    AvgPool1D, AvgPool2D, AvgPool3D, BatchNorm, BatchNorm1D, BatchNorm2D,
    BatchNorm3D, BCELoss, BCEWithLogitsLoss, Bilinear, BiRNN, CELU, Conv1D,
    Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D, Conv3DTranspose,
    CosineEmbeddingLoss, CosineSimilarity, CrossEntropyLoss, CTCLoss,
    Dropout, Dropout2D, Dropout3D, ELU, Embedding, Flatten, Fold, GELU,
    GLU, GroupNorm, GRU, GRUCell, Hardshrink, Hardsigmoid, Hardswish,
    Hardtanh, HingeEmbeddingLoss, HookRemoveHelper, HSigmoidLoss, Identity,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, KLDivLoss, L1Loss,
    Layer, LayerList, LayerNorm, LeakyReLU, Linear, LocalResponseNorm,
    LogSigmoid, LogSoftmax, LSTM, LSTMCell, MarginRankingLoss, Maxout,
    MaxPool1D, MaxPool2D, MaxPool3D, Mish, MSELoss, MultiHeadAttention,
    NCELoss, NLLLoss, Pad1D, Pad2D, Pad3D, PairwiseDistance, ParamAttr,
    ParameterList, PixelShuffle, PReLU, ReLU, ReLU6, RNN, RNNCellBase,
    SELU, Sequential, Sigmoid, SigmoidFocalLoss, Silu, SimpleRNN,
    SimpleRNNCell, SmoothL1Loss, SoftMarginLoss, Softmax, Softplus,
    Softshrink, Softsign, SpectralNorm, Swish, SyncBatchNorm, Tanh,
    Tanhshrink,
    ThresholdedReLU, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
    TripletMarginLoss, Unfold, Upsample, UpsamplingBilinear2D,
    UpsamplingNearest2D, ZeroPad2D)
