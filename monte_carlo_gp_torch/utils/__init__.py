"""Utilities: structured logging and phase timers."""

from monte_carlo_gp_torch.utils.profiling import Phase, phase_report  # noqa: F401
