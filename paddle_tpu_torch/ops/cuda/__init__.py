"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch
version, a launch counter and a checked ctypes wrapper.  Sources live in
paddle_tpu_torch/csrc; _build.py compiles them at first use."""
