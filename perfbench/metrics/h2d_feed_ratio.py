"""Host-to-device bytes over the feed: Σ ``h2d_bytes`` of the window's
runs (counted by the program at each host-to-device copy) over Σ of
their requests' feeds, ``work.FEED_ARRAYS[kind] · work.FEED_ITEM · N · P
· d`` from the run's frames N and particles P and the request's kind;
d = 3, since the harness builds every analysis with its default
``dim_type``, xyz. 1 where each request's feed crosses to the card
once (a little above it: the masses and the fit's small tables); 2 for
a feed copied twice; below 1 only where the feed stays on the card.
None where the program has no such counters (``program_spans.runs``)."""

from perfbench import program_spans, work

DIMS = 3


def read(record):
    found = program_spans.runs(record)
    if not found:
        return None
    kinds = {r["index"]: r["kind"] for r in record["requests"]}
    # the runs of the requests that were answered
    answered = {rid: run for rid, run in found.items()
                if run["request"] in kinds}
    feed = 0
    for run in answered.values():
        sizes = run["timing"].sizes
        feed += (work.FEED_ARRAYS[kinds[run["request"]]] * work.FEED_ITEM
                 * DIMS * sizes.get("n_frames", 0)
                 * sizes.get("n_particles", 0))
    if feed <= 0:
        return None
    return program_spans.total(answered, "h2d_bytes") / feed
