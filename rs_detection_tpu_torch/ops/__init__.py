"""PyTorch ops of the port: plain versions and their CUDA kernels."""

from . import dcn_pool  # noqa: F401,E402  (registers DCNPooling in BRICKS)
