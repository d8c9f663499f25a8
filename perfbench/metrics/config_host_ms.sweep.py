"""The host's own work per configuration of the sweep, milliseconds: the
mean over the traced window's `tune.config` spans of each span less the
`simulate.readback` spans inside it (the host's wait for the season
launch), so what is left is the overrides, the upload and launch, and the
scoring, which an overlap with the card's work would hide. Nothing is read
where the program has no such span."""

from perfbench import program_spans


def read(run):
    found = program_spans.events(run) or ()
    configs = [e for e in found if e.name == "tune.config"]
    if not configs:
        return None
    waits = [e for e in found if e.name == "simulate.readback"]
    own = [(c.end_ns - c.start_ns)
           - sum(w.end_ns - w.start_ns for w in waits
                 if c.start_ns <= w.start_ns and w.end_ns <= c.end_ns)
           for c in configs]
    return 1e-6 * sum(own) / len(own)
