"""mvster_tpu_torch — the PyTorch/CUDA port of mvster_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout so each module has a named counterpart:

  * config.py  MVS4NetConfig (same fields and defaults as the JAX dataclass)
  * core/      geometry, bilinear sampling, depth-hypothesis samplers
  * kernels/   the cost volume: plain PyTorch and the hand-written CUDA kernel
  * nn/        the pyramids (FPN4, ConvNeXt, ASFF, DCN), the regularisers
               (Reg2d and its attention blocks, Reg3d), the depth
               encodings and the mono decoder (nn.Modules, NCHW inside)
  * models/    the MVS4Net eval cascade
  * tools/     weight loading and the inference tool

Public functions keep the JAX package's channels-last layouts: features
(B, H, W, C), volumes (B, D, H, W, G), hypotheses (B, D, H, W).  Importing
this package imports neither jax nor the JAX package.
"""

__version__ = "0.1.0"
