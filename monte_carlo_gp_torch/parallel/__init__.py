"""Scale-out over several devices and processes: device meshes, the sharded
lap engine and the multi-process runtime. The sharded race kernels are in
`ops/race_kernel.py` (`race_counts_sharded`, `season_counts_sharded`).

Simulations are split over a mesh's shards; the only cross-device traffic is
the sum of the (D, D) integer finish histograms (one all-reduce across
processes), and the probabilities are bitwise those of one device.
"""

from monte_carlo_gp_torch.parallel.mesh import make_mesh, sharded_monte_carlo  # noqa: F401
from monte_carlo_gp_torch.parallel.sharded import simulate_season_sharded, stack_params  # noqa: F401
