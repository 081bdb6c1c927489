"""Architecture and shape registry of the port.

Each ported architecture has its own module exporting ``config()`` (the
published configuration) and ``smoke_config()`` (a reduced same-family
config for CPU tests); ``get_config(name)`` and ``list_archs()`` are the
public entry points used by ``--arch`` flags.
"""

from repro_torch.configs.registry import (  # noqa: F401
    SHAPES,
    ShapeSpec,
    get_config,
    get_smoke_config,
    list_archs,
    shape_applicable,
)
