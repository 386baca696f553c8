"""Device-mesh helpers.

Axis conventions of the framework (the biseqt-jax analog of dp/tp/sp):

  * ``data``  — queries / alignment pairs (embarrassingly parallel axis;
    the reference's "run experiments in parallel" becomes sharded batches).
  * ``band``  — lanes of a single DP band (model/sequence parallelism for
    giant pairs; neighbor halo exchange + cross-shard scan each row).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
BAND_AXIS = "band"

__all__ = ["make_mesh", "DATA_AXIS", "BAND_AXIS"]


def make_mesh(n_data: int = None, n_band: int = 1, devices=None) -> Mesh:
    """A (data, band) mesh over the available devices.

    Defaults to all devices on the data axis — the right layout whenever
    the workload is many pairs (the links carry the index all-gather).  Give
    ``n_band > 1`` to trade data parallelism for band parallelism on giant
    single pairs.
    """
    devices = list(jax.devices()) if devices is None else list(devices)
    if n_data is None:
        n_data = len(devices) // n_band
    if n_data < 1 or n_band < 1 or n_data * n_band > len(devices):
        # a plain assert would vanish under -O, and n_band > device
        # count would otherwise floor n_data to 0 and build an empty
        # mesh that fails far from the real cause
        raise ValueError(
            "mesh %dx%d does not fit %d devices"
            % (n_data, n_band, len(devices))
        )
    devs = np.asarray(devices[: n_data * n_band]).reshape(n_data, n_band)
    return Mesh(devs, (DATA_AXIS, BAND_AXIS))
