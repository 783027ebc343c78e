"""Share of the traced window that no device interval (kernel, copy or
memset) covers, in %."""

from perfbench import tracing


def read(record):
    if record["window_s"] <= 0 or not record["device"]:
        return None
    return 100.0 * (1.0 - tracing.busy_s(record) / record["window_s"])
