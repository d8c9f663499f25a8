"""The races the sweep ran on the kernels' packed instance (three
simulations a warp, fields of up to 20 drivers), per sweep: the program's
`race.packed` counter (raised by each K1 launch of the packed instance, and
by each K2 launch by its races) in the traced window, over its sweeps. A
2024 sweep of ten launches of 20 races reads 200. Nothing is read where the
program never counted it (a program without the packed instance)."""

from perfbench import program_spans


def read(run):
    found = program_spans.events(run)
    if not found or not any(e.name == "race.packed" for e in found):
        return None
    return program_spans.counted_per_unit(run, "race.packed")
