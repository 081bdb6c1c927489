"""Run one benchmark cell once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Exits non-zero without printing a result
when the cell's CUDA devices are missing, when the program under test
(``src/repro_torch``) is absent, or when JAX or the JAX package was
loaded.  Kernel builds and caches stay inside the checkout.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench"

if __name__ == "__main__":
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    sys.path[0] = str(ROOT)  # the package ``bench``, not this file's folder
    sys.path.insert(1, str(ROOT / "src"))
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the program under test is missing: no {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        sys.exit(2)
    from bench import harness

    sys.exit(harness.main(sys.argv[1:], t0=T0))
