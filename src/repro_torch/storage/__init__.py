from repro_torch.storage.iostats import IOStats, QueueStats
from repro_torch.storage.spill import SpillFile, SpillSet, write_spill
from repro_torch.storage.io_scheduler import WritebackIOScheduler, make_scheduler
from repro_torch.storage.layout import GraphStore
from repro_torch.storage.reader import Chunk, ChunkReader
from repro_torch.storage.writer import EmbeddingWriter
from repro_torch.storage.coldstore import ColdStore

__all__ = [
    "IOStats",
    "QueueStats",
    "SpillFile",
    "SpillSet",
    "write_spill",
    "WritebackIOScheduler",
    "make_scheduler",
    "GraphStore",
    "Chunk",
    "ChunkReader",
    "EmbeddingWriter",
    "ColdStore",
]
