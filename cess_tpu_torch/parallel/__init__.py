"""Device-mesh scale-out (SURVEY.md §7 L5), over torch devices.

The port of `cess_tpu/parallel/`.  The JAX package shards the audit
round's proof batch across a `jax.sharding.Mesh` with `shard_map` and
reduces with `psum`.  Here a `Mesh` is one process over a tuple of torch
devices: each rank's shard runs on its device, and the partials are
summed on the first device (parallel/verify.py) or, for points, folded
on the host in rank order (parallel/msm.py).  There is no process group.
"""

from .verify import (
    Mesh,
    audit_data_plane_step,
    combine_mu_sharded,
    make_mesh,
    pad_batch_rows,
)
from .msm import msm_sharded
from .epoch_sim import EpochReport, run_epoch

__all__ = [
    "audit_data_plane_step",
    "combine_mu_sharded",
    "make_mesh",
    "msm_sharded",
    "pad_batch_rows",
    "run_epoch",
    "EpochReport",
    "Mesh",
]
