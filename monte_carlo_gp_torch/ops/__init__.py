"""The race Monte Carlo: the Philox stream and the whole-race kernel with its
plain PyTorch version."""
