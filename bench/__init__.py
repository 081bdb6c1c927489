"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One command runs one cell once: ``python3 bench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.  See ``bench/README.md``.
"""
