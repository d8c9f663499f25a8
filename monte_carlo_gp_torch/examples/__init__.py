"""Worked examples of the PyTorch port, run as modules
(`python -m monte_carlo_gp_torch.examples.<name>`)."""
