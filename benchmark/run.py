"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds `BENCHMARK.json`. The cell names
a configuration (`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/traffic/<traffic>.json`); the mix names the runner that runs it
(`benchmark/runners/<runner>.py`). With `--trace 0` the line carries the
cell's end-to-end metrics; with `--trace 1` its per-layer metrics, each
read by `benchmark/metrics/<metric>.py`. The last line of standard output
is one JSON object; the numbers that decided `correct` are the last lines
of standard error and the last key of that object.
"""

from __future__ import annotations

import os
import sys
import time

T_IMPORT = time.time()


def _process_start() -> float:
    """Wall-clock time at which this process started (Linux), else the
    time this module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        ticks = int(fields[19])  # field 22, starttime, in clock ticks since boot
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


T_PROCESS = _process_start()

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark.lib.harness import main

    sys.exit(main(sys.argv[1:], root, T_PROCESS))
