"""Functional ops of the port: attention, linear, the dropouts, embedding,
one-hot and label smoothing, padding, interpolation, fold / unfold, the
distances and shuffles, the activations and softmaxes, the norms,
convolutions and their transposes, pooling, the losses, the long tail
of ``extras.py``, and ``embedding_bag``, ``segment_softmax`` and the
``sequence_*`` ops, the same objects as ``tensor.sequence``'s."""
from paddle_tpu_torch.nn.functional.activation import (  # noqa: F401
    celu, elu, gelu, glu, gumbel_softmax, hardshrink, hardsigmoid, hardswish,
    hardtanh, leaky_relu, log_sigmoid, log_softmax, maxout, mish, prelu,
    relu, relu6, relu_, rrelu, selu, sigmoid, silu, softmax, softplus,
    softshrink, softsign, swish, tanh, tanh_, tanhshrink, thresholded_relu)
from paddle_tpu_torch.nn.functional.attention import (  # noqa: F401
    flash_attention, scaled_dot_product_attention)
from paddle_tpu_torch.nn.functional.common import (  # noqa: F401
    alpha_dropout, bilinear, channel_shuffle, class_center_sample,
    cosine_similarity, dropout, dropout2d, dropout3d, embedding, fold,
    interpolate, label_smooth, linear, one_hot, pad, pairwise_distance,
    pixel_shuffle, pixel_unshuffle, unfold, upsample, zeropad2d)
from paddle_tpu_torch.nn.functional.conv import (  # noqa: F401
    conv1d, conv1d_transpose, conv2d, conv2d_transpose, conv3d,
    conv3d_transpose)
from paddle_tpu_torch.nn.functional.extras import (  # noqa: F401
    affine_grid, bilinear_tensor_product, box_coder, diag_embed, erf, fc,
    grid_sample, hsigmoid_loss, image_resize, linear_chain_crf, pool2d,
    prior_box, resize_bilinear, resize_nearest, roi_align, roi_pool,
    sequence_conv, smooth_l1, temporal_shift, viterbi_decode, warpctc,
    yolo_box)
from paddle_tpu_torch.nn.functional.loss import (  # noqa: F401
    binary_cross_entropy, binary_cross_entropy_with_logits,
    cosine_embedding_loss, cross_entropy, ctc_loss, dice_loss,
    hinge_embedding_loss, kl_div, l1_loss, log_loss, margin_ranking_loss,
    mse_loss, nll_loss, npair_loss, sigmoid_focal_loss, smooth_l1_loss,
    soft_margin_loss, softmax_with_cross_entropy, square_error_cost,
    triplet_margin_loss)
from paddle_tpu_torch.nn.functional.norm import (  # noqa: F401
    batch_norm, group_norm, instance_norm, layer_norm, local_response_norm,
    normalize)
from paddle_tpu_torch.nn.functional.pooling import (  # noqa: F401
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
    avg_pool1d, avg_pool2d, avg_pool3d, max_pool1d, max_pool2d, max_pool3d,
    max_unpool2d)
from paddle_tpu_torch.tensor.sequence import (  # noqa: F401
    embedding_bag, segment_softmax, sequence_concat, sequence_enumerate,
    sequence_expand_as, sequence_first_step, sequence_last_step,
    sequence_mask, sequence_pad, sequence_pool, sequence_reverse,
    sequence_softmax, sequence_unpad)
