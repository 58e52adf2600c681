"""The multi-device layer on torch.distributed (halo2_tpu/parallel/)."""
from .mesh import (AXIS, make_mesh, sharded_msm, sharded_msm_mont,
                   sharded_ntt, ShardedNttPlan, sharded_inclusive_product,
                   sharded_batch_inv)
from .context import ProverMesh, active, shard_rows
