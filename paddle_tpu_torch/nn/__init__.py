"""Neural-network layers, functionals, initializers, decoding and
gradient clipping of the port."""
from paddle_tpu_torch.nn import functional, initializer  # noqa: F401
from paddle_tpu_torch.nn.clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_)
from paddle_tpu_torch.nn.decode import (  # noqa: F401
    BeamSearchDecoder, Decoder, dynamic_decode, gather_tree)
from paddle_tpu_torch.nn.layer import (  # noqa: F401
    CELU, ELU, GELU, GLU, GRU, LSTM, RNN, SELU, AdaptiveAvgPool2D, AvgPool2D,
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, BiRNN, Conv1D, Conv2D,
    Conv3D, CrossEntropyLoss, Dropout, Embedding, Flatten, GRUCell,
    Hardshrink, Hardsigmoid, Hardswish, Hardtanh, LayerNorm, LeakyReLU,
    Linear, LogSigmoid, LogSoftmax, LSTMCell, Maxout, MaxPool2D, Mish,
    MultiHeadAttention, NLLLoss, ParamAttr, PReLU, ReLU, ReLU6, RNNCellBase,
    Sequential, Sigmoid, Silu, SimpleRNN, SimpleRNNCell, Softmax, Softplus,
    Softshrink, Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU,
    Transformer, TransformerDecoder, TransformerDecoderLayer,
    TransformerEncoder, TransformerEncoderLayer)
