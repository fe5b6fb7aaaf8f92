"""Ops of the port: plain tensor code, and the hand-written CUDA kernels
(``csrc/``) with their plain PyTorch versions beside them."""
