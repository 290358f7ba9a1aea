"""ResNet and LeNet (port of paddle_tpu/vision/models)."""
from paddle_tpu_torch.vision.models.lenet import LeNet  # noqa: F401
from paddle_tpu_torch.vision.models.resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152)
