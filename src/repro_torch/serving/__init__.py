"""LM serving of the port: the aligned-batching ``ServingEngine``."""

from repro_torch.serving.engine import Request, ServingEngine  # noqa: F401
