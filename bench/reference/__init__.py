"""The plain reference: the published layer equations in plain PyTorch.
Imports nothing of the program (``repro_torch``) and nothing of JAX."""
