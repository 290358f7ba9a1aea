"""Vision of the port (port of paddle_tpu/vision): the models, the image
transforms, the datasets (local files only), the detection ops (``ops``:
box utilities, RoI ops, the NMS family, the proposal and target stages)
and the image-backend switch."""
from paddle_tpu_torch.vision import datasets, models, ops, transforms  # noqa: F401,E501

__all__ = ["models", "datasets", "transforms", "ops", "set_image_backend",
           "get_image_backend"]


def set_image_backend(backend):
    """Checks the name ("pil", "cv2", "tensor" or "numpy") and keeps
    nothing, as the reference (``:12-15``): the backend stays numpy."""
    if backend not in ("pil", "cv2", "tensor", "numpy"):
        raise ValueError(f"unsupported backend {backend}")


def get_image_backend():
    return "numpy"
