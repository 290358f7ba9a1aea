"""Functional ops of the port: attention, linear, dropout, embedding,
one-hot and label smoothing, the activations and softmaxes, layer and batch
norm, convolutions, pooling and the losses."""
from paddle_tpu_torch.nn.functional.activation import (  # noqa: F401
    celu, elu, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid, hardswish,
    hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout, mish, prelu,
    relu, relu6, relu_, rrelu, selu, sigmoid, silu, softmax, softplus,
    softshrink, softsign, swish, tanh, tanh_, tanhshrink, thresholded_relu)
from paddle_tpu_torch.nn.functional.attention import (  # noqa: F401
    flash_attention, scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import (  # noqa: F401
    dropout, embedding, label_smooth, linear, one_hot)
from paddle_tpu_torch.nn.functional.conv import (  # noqa: F401
    conv1d, conv2d, conv3d)
from paddle_tpu_torch.nn.functional.loss import (  # noqa: F401
    cross_entropy, nll_loss, softmax_with_cross_entropy)
from paddle_tpu_torch.nn.functional.norm import (  # noqa: F401
    batch_norm, layer_norm)
from paddle_tpu_torch.nn.functional.pooling import (  # noqa: F401
    adaptive_avg_pool2d, avg_pool2d, max_pool2d)
