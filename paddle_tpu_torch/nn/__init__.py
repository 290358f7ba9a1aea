"""Neural-network layers, functionals, decoding and gradient clipping of
the port."""
from paddle_tpu_torch.nn import functional  # noqa: F401
from paddle_tpu_torch.nn.clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_)
from paddle_tpu_torch.nn.decode import (  # noqa: F401
    BeamSearchDecoder, Decoder, dynamic_decode, gather_tree)
from paddle_tpu_torch.nn.layer import (  # noqa: F401
    GRU, LSTM, RNN, AdaptiveAvgPool2D, AvgPool2D, BatchNorm, BatchNorm1D,
    BatchNorm2D, BatchNorm3D, BiRNN, Conv1D, Conv2D, Conv3D,
    CrossEntropyLoss, Dropout, Embedding, Flatten, GRUCell, LayerNorm,
    Linear, LSTMCell, MaxPool2D, MultiHeadAttention, NLLLoss, ReLU,
    RNNCellBase, Sequential, SimpleRNN, SimpleRNNCell, Transformer,
    TransformerDecoder, TransformerDecoderLayer, TransformerEncoder,
    TransformerEncoderLayer)
