"""PyTorch/CUDA port of rs_detection_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``ops/``, ``models/...``); the JAX
package stays the reference it is tested against. Imports torch and
numpy only.
"""
