"""How a cell drives the program: one module per path, found by the
traffic's ``path``.  Each has ``run(spec) -> dict`` with ``ctx`` (what the
metric readers read), ``checks`` (the numbers compared), ``attempted``
(the passes run) and ``device``."""
