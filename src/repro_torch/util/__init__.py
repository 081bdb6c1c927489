from repro_torch.util.offload import OffloadWorker

__all__ = ["OffloadWorker"]
