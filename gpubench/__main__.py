"""``python -m gpubench --workload <name> --seed <n> --seconds <s> --trace <0|1>``"""

import time

T0 = time.perf_counter()  # set-up runs from here to the first timed action

import sys  # noqa: E402

from gpubench.run import main  # noqa: E402

sys.exit(main(sys.argv[1:], T0))
