"""ResNet, LeNet, MobileNetV1/V2 and VGG (port of
paddle_tpu/vision/models)."""
from paddle_tpu_torch.vision.models.lenet import LeNet  # noqa: F401
from paddle_tpu_torch.vision.models.mobilenet import (  # noqa: F401
    MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2)
from paddle_tpu_torch.vision.models.resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152)
from paddle_tpu_torch.vision.models.vgg import (  # noqa: F401
    VGG, vgg11, vgg13, vgg16, vgg19)
