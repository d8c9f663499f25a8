"""Model layer: Elo ratings, feature engineering, and the weekend predictor."""

from monte_carlo_gp_torch.models.elo import EloParams, F1EloSystem  # noqa: F401
from monte_carlo_gp_torch.models.safety import (  # noqa: F401
    InsufficientDataError,
    PredictionError,
    generate_fallback_predictions,
    safe_predict,
)
