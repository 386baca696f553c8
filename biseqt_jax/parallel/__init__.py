"""Mesh-parallel layer: sharded all-vs-all discovery, band-parallel DP.

The reference has no distributed runtime (single-machine SQLite library);
this layer is the multi-device scaling story required by the north star:
data-parallel query sharding over a ``jax.sharding.Mesh``, index-shard
all-gather between devices for all-vs-all overlap discovery, and band-axis model
parallelism with neighbor exchange for giant single-pair DP.
"""

from .mesh import make_mesh, DATA_AXIS, BAND_AXIS  # noqa: F401
from .allvsall import all_vs_all_overlaps, overlap_matrix_sharded  # noqa: F401
