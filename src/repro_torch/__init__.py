"""PyTorch/CUDA port of the ATLAS out-of-core GNN inference engine.

Mirrors the layout of the JAX package ``repro`` module for module; the
host side (storage, spill formats, eviction, orchestration) is carried
over unchanged, and the two accelerator steps of the main path run as
hand-written CUDA kernels (``repro_torch.kernels``).  Entry points run on
the GPU unless the caller asks for the CPU (``repro_torch.device``).
"""
