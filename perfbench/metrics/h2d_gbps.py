"""Host-to-device copy rate: bytes over the summed duration of the
trace's Memcpy HtoD intervals, in GB/s."""


def read(record):
    copies = [d for d in record["device"] if d["kind"] == "HtoD"]
    seconds = sum(d["dur"] for d in copies)
    if not copies or seconds <= 0:
        return None
    return sum(d["bytes"] for d in copies) / seconds / 1e9
