"""Rate of the merge of the program's atom chunks: the bytes its runs'
merges passed over (``chunk_merge_bytes``, counted by the program: each
chunk's (L, chunk) result summed and scattered into the (L, P) result,
and the whole result again where Helfand divides it) over the summed
duration of the window's ``ta.chunk.merge`` spans, in GB/s. None where
no run chunked or the program has no such spans and counters
(``program_spans.runs``)."""

from perfbench import program_spans

COUNTER = "chunk_merge_bytes"
SPAN = "ta.chunk.merge"


def read(record):
    found = program_spans.runs(record)
    if not found:
        return None
    nbytes = sum(run["timing"].counts().get(COUNTER, 0)
                 for run in found.values())
    seconds = sum(s["dur"] for s in record["spans"] if s["name"] == SPAN)
    if nbytes <= 0 or seconds <= 0:
        return None
    return nbytes / seconds / 1e9
