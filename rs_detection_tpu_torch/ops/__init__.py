"""PyTorch ops of the port: plain versions and their CUDA kernels."""
