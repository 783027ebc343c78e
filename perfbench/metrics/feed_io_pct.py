"""Share of the window the program spent in its host feed: the sum over
the window's requests of ``analysis.timing["io"]`` (``models/base.py``
``run``: ``read_frames_batch`` and ``select_series``), in %."""


def read(record):
    requests = record["requests"]
    if not requests or record["window_s"] <= 0:
        return None
    return 100.0 * sum(r["io_s"] for r in requests) / record["window_s"]
