"""CPU tests of the benchmark (``python -m pytest bench/tests``); those
that need the card carry the ``gpu`` marker and skip without one."""
