"""Data layer: session loading (FastF1 when available), offline/cached
operation, synthetic data generation, and Elo rating persistence. Host code
(pandas/numpy); its outputs become tensors at the predictor boundary."""

from monte_carlo_gp_torch.data.loader import F1DataLoader  # noqa: F401
from monte_carlo_gp_torch.data.synthetic import SyntheticBackend  # noqa: F401
