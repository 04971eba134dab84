"""Run one cell of the benchmark once (see benchmark/README.md).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of stdout is the result's JSON object; the numbers
the check compared are the last lines of stderr.
"""

import os
import sys
import time


def process_age() -> float:
    """Seconds since this process started (Linux's /proc), so that set-up
    counts the interpreter's own start too; 0 where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


START = time.perf_counter() - process_age()

# the checkout's root: the program and this harness are imported from it
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# a library that could load JAX by itself is kept from it
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

from benchmark.harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], start=START))
