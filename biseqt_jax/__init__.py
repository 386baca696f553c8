"""biseqt_jax: a JAX seed-and-extend sequence similarity framework.

A from-scratch rebuild of the capabilities of the reference bioinformatics
library ``amirkdv/biseqt`` (Word-Blot similar-segment discovery, k-mer/seed
indexing, affine-gap banded alignment, mutation-model simulation), designed
for accelerators: packed integer sequences, radix-sorted on-device k-mer
tables, segmented-reduction band statistics, a banded DP engine (lax.scan
on the CPU, a CUDA kernel on NVIDIA GPUs), and mesh-sharded all-vs-all
discovery via jax collectives.
"""

__version__ = "0.1.0"

from . import matrices  # noqa: F401
from . import sequence  # noqa: F401
from . import stochastics  # noqa: F401
from . import pw  # noqa: F401
