"""Run one cell of the benchmark (see ``gpubench/__init__.py``)."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "gpubench"

if __name__ == "__main__":
    # fixed directories inside the checkout, set before torch is imported,
    # so that only a cell's first run compiles
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(CACHE / "inductor")
    # the checkout's root, not this folder (whose trace.py would shadow
    # the standard library's)
    sys.path[0] = str(ROOT)
    from gpubench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
