"""Run one cell of the benchmark once; see ``harness.py``.

    python3 dmrbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>
"""
import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from dmrbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(started=STARTED))
