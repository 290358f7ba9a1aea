"""Layers of the port: ``ParamAttr``, linear, dropout, embedding, flatten,
the activations,
norms, convolutions, pooling, the loss layers, the recurrent layers and
the transformer.  ``Sequential`` is ``torch.nn.Sequential``, whose
children are named ``0``, ``1``, ... as the reference's are."""
from torch.nn import Sequential  # noqa: F401

from paddle_tpu_torch.nn.layer.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, SELU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign, Swish, Tanh,
    Tanhshrink, ThresholdedReLU)
from paddle_tpu_torch.nn.layer.common import (  # noqa: F401
    Dropout, Embedding, Flatten, Linear, ParamAttr)
from paddle_tpu_torch.nn.layer.conv import Conv1D, Conv2D, Conv3D  # noqa: F401
from paddle_tpu_torch.nn.layer.loss import (  # noqa: F401
    CrossEntropyLoss, NLLLoss)
from paddle_tpu_torch.nn.layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm)
from paddle_tpu_torch.nn.layer.pooling import (  # noqa: F401
    AdaptiveAvgPool2D, AvgPool2D, MaxPool2D)
from paddle_tpu_torch.nn.layer.rnn import (  # noqa: F401
    GRU, LSTM, RNN, BiRNN, GRUCell, LSTMCell, RNNCellBase, SimpleRNN,
    SimpleRNNCell)
from paddle_tpu_torch.nn.layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer)
