"""Share of the result bytes copied back into a recycled page-locked
host block: 100 · Σ ``d2h_pool_hit_bytes`` over Σ ``d2h_bytes`` of the
window's answered runs, both counted by the program at each result
copy (a run's hits are 0 where every block was new). None where no
answered run holds the counter, as in a program without the pool, or
the runs are not found (``program_spans.runs``)."""

from perfbench import program_spans

COUNTER = "d2h_pool_hit_bytes"


def read(record):
    found = program_spans.runs(record)
    if not found:
        return None
    answered = {r["index"] for r in record["requests"]}
    counts = [run["timing"].counts() for run in found.values()
              if run["request"] in answered]
    if not any(COUNTER in c for c in counts):
        return None
    copied = sum(c["d2h_bytes"] for c in counts)
    if copied <= 0:
        return None
    return 100.0 * sum(c.get(COUNTER, 0) for c in counts) / copied
