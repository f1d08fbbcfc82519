"""The cost volume: plain PyTorch formulation and the hand-written CUDA kernel."""
