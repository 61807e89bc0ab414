"""Run one cell traced with the port's own spans in its trace, and print
what they read.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

``run.py``'s ``--trace 1`` run, with the runner's ``Ranges`` installed as
the port's span recorder: the harness's result line (its idle gaps named by
the spans), then a line of ``program_spans.readings``.  Run from the root of
a checkout, on the card.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import program_spans  # noqa: E402

if __name__ == "__main__":
    sys.exit(program_spans.main(sys.argv[1:], T0))
