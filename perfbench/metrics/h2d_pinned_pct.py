"""Share of the host-to-device bytes that crossed from page-locked host
memory: 100 · Σ ``h2d_pinned_bytes`` over Σ ``h2d_bytes`` of the
window's answered runs, both counted by the program at each copy to the
card (a run's pinned bytes are 0 where every copy was pageable). None
where no answered run holds the counter, as in a program that does not
count it, or the runs are not found (``program_spans.runs``)."""

from perfbench import program_spans

COUNTER = "h2d_pinned_bytes"


def read(record):
    found = program_spans.runs(record)
    if not found:
        return None
    answered = {r["index"] for r in record["requests"]}
    counts = [run["timing"].counts() for run in found.values()
              if run["request"] in answered]
    if not any(COUNTER in c for c in counts):
        return None
    copied = sum(c["h2d_bytes"] for c in counts)
    if copied <= 0:
        return None
    return 100.0 * sum(c[COUNTER] for c in counts) / copied
