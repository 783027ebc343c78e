"""95th percentile of one analysis's wall, from its construction until
its results are on the host, over the window's requests (the harness's
host clock, ``statistics.quantiles`` with n = 20), in s."""

import statistics


def read(record):
    walls = [r["wall_s"] for r in record["requests"]]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=20)[-1]
