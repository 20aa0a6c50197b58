import time

T0 = time.perf_counter()  # the process's start, as near as the harness can take it

import sys  # noqa: E402

from simbench.run import main  # noqa: E402

sys.exit(main(t0=T0))
