"""A path's share of its roofline, read from the traced run's record:
the summed least time of the path's requests over the summed time of
every kernel, copies and memsets left out, that ran inside their spans.
The kernels are not matched by name, so a fused or renamed kernel still
counts."""

from __future__ import annotations


def share(record: dict, fft: bool):
    """In %, for the requests with ``fft`` as given; None where the
    window has none of them or no kernel ran in them."""
    chosen = {r["index"]: r for r in record["requests"] if r["fft"] == fft}
    kernel_s = sum(d["dur"] for d in record["device"]
                   if d["cat"] == "kernel" and d["request"] in chosen)
    if not chosen or kernel_s <= 0:
        return None
    return 100.0 * sum(r["least_s"] for r in chosen.values()) / kernel_s
