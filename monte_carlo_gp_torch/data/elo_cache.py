"""Elo rating persistence with the 3-level cache priority the reference
README describes but never implements (reference README.md:85-97,
SURVEY.md §5 checkpoint/resume):

    1. external cache (explicit path, read-only, e.g. shipped ratings)
    2. local cache (written by this framework after Elo builds)
    3. compute from session data

Stored as JSON: driver names, (quali, race) ratings, and the processed-event
log so incremental season updates never double-apply an event.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from monte_carlo_gp_torch.models.elo import F1EloSystem

CACHE_VERSION = 1


def save_elo(
    system: F1EloSystem,
    path: str | Path,
    processed_seasons: list[int] | None = None,
) -> None:
    state = system.state_dict()
    payload = {
        "version": CACHE_VERSION,
        "k_factor": state["k_factor"],
        "initial_rating": state["initial_rating"],
        "processed_seasons": sorted(processed_seasons or []),
        "ratings": {
            name: [float(q), float(r)]
            for name, (q, r) in zip(state["names"], state["ratings"])
        },
    }
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(payload, indent=1))


def load_elo(path: str | Path) -> tuple[F1EloSystem, list[int]] | None:
    p = Path(path)
    if not p.exists():
        return None
    try:
        payload = json.loads(p.read_text())
    except (json.JSONDecodeError, OSError):
        return None
    if payload.get("version") != CACHE_VERSION:
        return None
    names = list(payload["ratings"].keys())
    ratings = np.array([payload["ratings"][n] for n in names], np.float32)
    system = F1EloSystem.from_state_dict(
        {
            "names": names,
            "ratings": ratings,
            "k_factor": payload.get("k_factor", 32.0),
            "initial_rating": payload.get("initial_rating", 1500.0),
        }
    )
    return system, list(payload.get("processed_seasons", []))


def load_with_priority(
    external_path: str | Path | None,
    local_path: str | Path,
) -> tuple[F1EloSystem, list[int], str] | None:
    """Try external cache, then local cache. Returns (system, processed
    seasons, source) or None when both miss (caller computes level 3)."""
    if external_path is not None:
        loaded = load_elo(external_path)
        if loaded is not None:
            return loaded[0], loaded[1], "external"
    loaded = load_elo(local_path)
    if loaded is not None:
        return loaded[0], loaded[1], "local"
    return None
