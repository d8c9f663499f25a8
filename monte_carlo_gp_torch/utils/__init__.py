"""Utilities: structured logging and the span and counter recorder."""

from monte_carlo_gp_torch.utils.profiling import Phase, phase_report  # noqa: F401
