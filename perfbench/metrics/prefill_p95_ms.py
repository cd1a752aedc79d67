"""prefill_p95_ms: the 95th percentile (linear between order statistics),
over every request completed inside the window, of the time from its
group's dispatch to its first token on the host."""
import sys

import numpy as np


def read(ctx):
    times = [t for t, _ in ctx.record["done"]]
    if not times:
        return None
    print(f"prefill_p95_ms: {len(times)} requests, median "
          f"{1e3 * float(np.median(times))!r} ms", file=sys.stderr)
    return 1e3 * float(np.percentile(times, 95))
