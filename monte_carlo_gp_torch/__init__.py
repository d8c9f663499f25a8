"""monte_carlo_gp_torch — the F1 race simulator and weekend predictor on
PyTorch, with the whole-race Monte Carlo as a CUDA kernel for Hopper.

Module names mirror `monte_carlo_gp_tpu`, the JAX package this one is held
against in the tests:

  - `config`            static F1 tables and `SimParams` (a dataclass of
                        tensors);
  - `data`, `models`    the host layer: loader, synthetic world, Elo,
                        features, the weekend predictor;
  - `ops.race_kernel`   the whole-race Monte Carlo: a plain PyTorch version
                        (CPU tensors) and the CUDA kernel in
                        `csrc/race_kernel.cu` (CUDA tensors);
  - `ops.philox`        the Philox4x32-10 counter stream both versions draw;
  - `ops.engine`        the lap engine (plain PyTorch), for fields over 128
                        drivers and `engine="xla"`;
  - `parallel`          meshes of devices, the split runs and the
                        multi-process runtime (`torch.distributed`).

The package imports torch and never jax.
"""

__version__ = "0.1.0"
