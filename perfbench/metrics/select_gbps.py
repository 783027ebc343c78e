"""Rate of the program's host selection gather: the bytes its runs'
selections copied (``select_bytes``, counted by the program in its
``ta.feed.select`` spans) over the summed duration of the window's
``ta.feed.select`` spans, in GB/s; None where no selection copied or the
program has no such spans and counters (``program_spans.runs``)."""

from perfbench import program_spans


def read(record):
    found = program_spans.runs(record)
    if not found:
        return None
    nbytes = program_spans.total(found, "select_bytes")
    seconds = sum(s["dur"] for s in record["spans"]
                  if s["name"] == "ta.feed.select")
    if nbytes <= 0 or seconds <= 0:
        return None
    return nbytes / seconds / 1e9
