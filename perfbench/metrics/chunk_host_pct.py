"""Share of the traced window the program spent on the host work of its
atom chunks: the summed durations of the window's ``ta.chunk.gather``
spans (the host copy that makes a chunk's columns contiguous) and
``ta.chunk.merge`` spans (the running particle sum, the scatter of each
chunk's result into the (L, P) result, Helfand's division of it), in %.
None where no run chunked, as in a program that streams no chunks by
itself."""

SPANS = ("ta.chunk.gather", "ta.chunk.merge")


def read(record):
    seconds = sum(s["dur"] for s in record["spans"] if s["name"] in SPANS)
    if seconds <= 0 or record["window_s"] <= 0:
        return None
    return 100.0 * seconds / record["window_s"]
