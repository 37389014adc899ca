"""``python -m wam_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell; the last line of standard output is
the result object, the last lines of standard error the compared numbers
beside their limits."""

import time

_T0 = time.perf_counter()

import sys  # noqa: E402

from wam_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=_T0))
