"""The benchmark of monte_carlo_gp_torch on an NVIDIA H100: `python -m perfbench --help`
and README.md."""
