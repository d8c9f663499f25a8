"""The data a run serves: the synthetic F1 world made from the run's seed
and written to the users' offline parquet cache, by the reference's frozen
copies of the port's synthetic generator and cache writer, so the program
reads inputs the benchmark made. One directory per run under `TMPDIR`,
removed when the run ends.
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

from perfbench.reference import loader as ref_loader
from perfbench.reference import synthetic


class World:
    """A world's offline cache (`cache_dir`, as `F1Predictor(cache_dir=...,
    offline=True)` reads it) and its calendar."""

    def __init__(self, world_seed: int, seasons: list[int]):
        self.cache_dir = Path(tempfile.mkdtemp(prefix="perfbench-world-"))
        backend = synthetic.SyntheticBackend(seed=world_seed)
        ref_loader.F1DataLoader(cache_dir=self.cache_dir, offline=True,
                                backend=backend).build_cache(seasons)
        self.races = {s: [ev["Location"] for ev in backend.get_schedule(s)] for s in seasons}

    def close(self) -> None:
        shutil.rmtree(self.cache_dir, ignore_errors=True)
