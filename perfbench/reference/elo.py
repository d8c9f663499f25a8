"""Dual qualifying/race Elo rating system.

Per-driver (quali, race) ratings initialized at 1500, K=32 pairwise
round-robin updates per event with deltas computed against the pre-update
snapshot and normalized by (n-1), ties scored 0.5, the expected-score
exponent clamped to [-10, 10], recency-weighted K (current-season race-index
ramp 0.75->1.5; 1.0/0.7/0.5 for 1/2/3+ year-old data), and a softmax
pole-probability predictor with scale 100.

Ratings live in a dense (n_drivers, 2) float32 array keyed by an interning
table. One event update is a vectorized O(n^2) pairwise expected/actual
score matrix in torch; a history is a Python loop over events
(`scan_update`), run on the CPU: it is a few hundred events over a few
dozen drivers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

QUALI, RACE = 0, 1


@dataclasses.dataclass(frozen=True)
class EloParams:
    k_factor: float = 32.0
    initial_rating: float = 1500.0
    softmax_scale: float = 100.0
    exponent_clamp: float = 10.0


def recency_k(
    base_k: float, years_ago: float, race_index: int = 0, total_races: int = 24
) -> float:
    """K-factor schedule: the current season ramps 0.75x -> 1.5x across the
    season; older seasons decay 1.0/0.7/0.5."""
    if years_ago <= 0:
        race_weight = 0.75 + (0.75 * race_index / max(1, total_races - 1))
        return base_k * race_weight
    if years_ago <= 1:
        return base_k * 1.0
    if years_ago <= 2:
        return base_k * 0.7
    return base_k * 0.5


def event_update(
    ratings: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    k: float,
    clamp: float = 10.0,
) -> torch.Tensor:
    """One pairwise Elo event update, vectorized.

    Args:
      ratings: (N,) float32 current ratings for the relevant discipline.
      values: (N,) outcome values; LOWER is better (lap time or position).
      mask: (N,) bool, True for event participants.
      k: the K-factor for this event.

    Returns updated (N,) ratings. Events with fewer than 2 participants are
    no-ops. Deltas are computed against the pre-update snapshot and applied
    together.
    """
    n = int(mask.sum())
    if n < 2:
        return ratings
    r_i = ratings[:, None]
    r_j = ratings[None, :]
    exponent = ((r_j - r_i) / 400.0).clamp(-clamp, clamp)
    expected = 1.0 / (1.0 + torch.pow(10.0, exponent))
    v_i = values[:, None]
    v_j = values[None, :]
    actual = torch.where(v_i < v_j, 1.0, torch.where(v_i > v_j, 0.0, 0.5))
    eye = torch.eye(mask.shape[0], dtype=torch.bool)
    pair = mask[:, None] & mask[None, :] & ~eye
    delta = k * torch.where(pair, actual - expected, 0.0).sum(1) / (n - 1)
    return torch.where(mask, ratings + delta, ratings)


def scan_update(
    ratings: torch.Tensor,
    values: torch.Tensor,
    masks: torch.Tensor,
    ks: torch.Tensor,
    disciplines: torch.Tensor,
) -> torch.Tensor:
    """Apply a chronological sequence of events in order.

    Args:
      ratings: (N, 2) [driver, {quali, race}] float32 ratings.
      values: (E, N) outcome values (lower better), garbage where unmasked.
      masks: (E, N) participant masks.
      ks: (E,) per-event K factors.
      disciplines: (E,) QUALI=0 or RACE=1 — which column updates.

    Returns the final (N, 2) ratings.
    """
    r = ratings.clone()
    for vals, mask, k, disc in zip(values, masks, ks.tolist(), disciplines.tolist()):
        r[:, disc] = event_update(r[:, disc], vals, mask, torch.tensor(k, dtype=torch.float32))
    return r


class F1EloSystem:
    """Host-side wrapper over dense ratings plus a driver interning table.

    `update_*` calls buffer events and `flush` applies them through
    `scan_update`; `predict_quali_probs` and `get_rating` flush first.
    """

    def __init__(self, k_factor: float = 32.0, initial_rating: float = 1500.0):
        self.params = EloParams(k_factor=k_factor, initial_rating=initial_rating)
        self.k = float(k_factor)
        self._names: list[str] = []
        self._ids: dict[str, int] = {}
        self._ratings = np.zeros((0, 2), np.float32)
        self._pending: list[tuple[np.ndarray, np.ndarray, float, int]] = []

    # -- interning ----------------------------------------------------------

    def _intern(self, drivers) -> np.ndarray:
        new = [d for d in drivers if d not in self._ids]
        if new:
            for d in new:
                self._ids[d] = len(self._names)
                self._names.append(d)
            grown = np.full((len(new), 2), self.params.initial_rating, np.float32)
            self._ratings = np.concatenate([self._ratings, grown], axis=0)
        return np.array([self._ids[d] for d in drivers], np.int64)

    @property
    def names(self) -> list[str]:
        return list(self._names)

    # -- public API ---------------------------------------------------------

    def set_recency_weight(
        self, years_ago: float, race_index: int = 0, total_races: int = 24
    ) -> None:
        self.k = recency_k(self.params.k_factor, years_ago, race_index, total_races)

    @staticmethod
    def _normalize_event(results) -> tuple[list[str], np.ndarray]:
        """Accept list[(driver, value)], or an ordered list[str] (best
        first), which becomes positions 1..n."""
        if not results:
            return [], np.zeros((0,), np.float32)
        if isinstance(results[0], str):
            drivers = list(results)
            values = np.arange(1, len(drivers) + 1, dtype=np.float32)
        else:
            drivers = [d for d, _ in results]
            values = np.array([v for _, v in results], np.float32)
        return drivers, values

    def _queue(self, results, discipline: int) -> None:
        """Buffer one event. Duplicate-driver rows collapse to the LAST
        occurrence (dense mask keyed by interned id)."""
        drivers, values = self._normalize_event(results)
        if len(drivers) < 2:
            return
        ids = self._intern(drivers)
        self._pending.append((ids, values, self.k, discipline))

    def update_quali_ratings(self, quali_results) -> None:
        """(driver, best_lap_time) pairs or an ordered driver list."""
        self._queue(quali_results, QUALI)

    def update_race_ratings(self, race_results) -> None:
        """(driver, finish_position) pairs or an ordered driver list."""
        self._queue(race_results, RACE)

    def flush(self) -> None:
        """Apply buffered events through `scan_update`."""
        if not self._pending:
            return
        n = len(self._names)
        e = len(self._pending)
        values = np.zeros((e, n), np.float32)
        masks = np.zeros((e, n), bool)
        ks = np.zeros((e,), np.float32)
        discs = np.zeros((e,), np.int64)
        for i, (ids, vals, k, disc) in enumerate(self._pending):
            values[i, ids] = vals
            masks[i, ids] = True
            ks[i] = k
            discs[i] = disc
        self._ratings = scan_update(
            torch.from_numpy(self._ratings),
            torch.from_numpy(values),
            torch.from_numpy(masks),
            torch.from_numpy(ks),
            torch.from_numpy(discs),
        ).numpy()
        self._pending.clear()

    def predict_quali_probs(self, drivers: list[str]) -> dict[str, float]:
        """Softmax pole probabilities over `drivers`, in float64 NumPy."""
        if not drivers:
            return {}
        self.flush()
        ratings = np.array(
            [self._rating_of(d, QUALI) for d in drivers], np.float64
        )
        scaled = ratings / self.params.softmax_scale
        e = np.exp(scaled - scaled.max())
        probs = e / e.sum()
        total = probs.sum()
        if total <= 0:
            return {d: 1.0 / len(drivers) for d in drivers}
        return {d: float(p) for d, p in zip(drivers, probs)}

    def _rating_of(self, driver: str, discipline: int) -> float:
        if driver in self._ids:
            return float(self._ratings[self._ids[driver], discipline])
        return self.params.initial_rating

    def has_rating(self, driver: str) -> bool:
        """True once the driver has appeared in any rated (or rookie-
        initialized) event."""
        return driver in self._ids

    def initialize_rookie(
        self, driver: str, team: str | None, driver_teams: dict[str, str] | None = None
    ) -> float:
        """Seed a new driver from a teammate prior; see `initialize_rookies`."""
        return self.initialize_rookies({driver: team}, driver_teams)[driver]

    def initialize_rookies(
        self,
        rookies: dict[str, str | None],
        driver_teams: dict[str, str] | None = None,
    ) -> dict[str, float]:
        """Prior = mean QUALI rating of the driver's teammates (unknown
        teammates count at the initial rating), or 1400 for a team with no
        other drivers; both disciplines are set to prior - 50. A driver whose
        team is unknown stays at the initial rating and is not interned.
        Every prior comes from the ratings as they were before this batch,
        so two unrated teammates do not see each other's new rating."""
        self.flush()
        if driver_teams is None:
            from perfbench.reference import config as cfg

            driver_teams = cfg.DRIVER_TEAMS
        applied: dict[str, float] = {}
        for driver, team in rookies.items():
            if team is None:
                applied[driver] = self.params.initial_rating
                continue
            teammates = [
                d for d, t in driver_teams.items() if t == team and d != driver
            ]
            if teammates:
                prior = float(
                    np.mean([self._rating_of(t, QUALI) for t in teammates])
                )
            else:
                prior = 1400.0
            applied[driver] = prior - 50.0
        for driver, team in rookies.items():
            if team is None:
                continue
            (idx,) = self._intern([driver])
            self._ratings[idx, QUALI] = applied[driver]
            self._ratings[idx, RACE] = applied[driver]
        return applied

    def get_rating(self, driver: str, rating_type: str = "quali") -> float:
        self.flush()
        return self._rating_of(driver, QUALI if rating_type == "quali" else RACE)

    # -- persistence hooks (data/elo_cache.py) -------------------------------

    def state_dict(self) -> dict:
        self.flush()
        return {
            "names": list(self._names),
            "ratings": self._ratings.copy(),
            "k_factor": self.params.k_factor,
            "initial_rating": self.params.initial_rating,
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "F1EloSystem":
        sys_ = cls(
            k_factor=float(state.get("k_factor", 32.0)),
            initial_rating=float(state.get("initial_rating", 1500.0)),
        )
        names = list(state["names"])
        sys_._names = names
        sys_._ids = {d: i for i, d in enumerate(names)}
        sys_._ratings = np.asarray(state["ratings"], np.float32).reshape(len(names), 2)
        return sys_
