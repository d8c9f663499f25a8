"""The data loader's parquet reads per season: the program's `frames.read`
counter (a session frame read from disk, not found in the process-wide
frame cache) in the traced window, over its seasons."""

from perfbench import program_spans


def read(run):
    return program_spans.counted_per_unit(run, "frames.read")
