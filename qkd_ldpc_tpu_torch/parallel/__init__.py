"""Distribution: device meshes, sharded sweeps, multi-process bring-up.

Counterpart of ``qkd_ldpc_tpu/parallel``: the trial mesh and the sharded
point and sweep runners (``sweep``), the general node-sharded flooding
decoder (``node_sharded``), the QC node-sharded decoder, flooding and
layered (``qc_node_sharded``), and the process group (``mesh``, gloo over
``torch.distributed``).  A mesh row's node shards may span processes.
"""

from qkd_ldpc_tpu_torch.parallel.mesh import (
    NODE_AXIS,
    TRIAL_AXIS,
    Mesh,
    initialize_distributed,
    make_mesh,
    make_trial_mesh,
    replicated,
    trial_sharding,
)
from qkd_ldpc_tpu_torch.parallel.node_sharded import (
    bp_decode_node_sharded,
    decode_node_sharded,
)
from qkd_ldpc_tpu_torch.parallel.qc_node_sharded import (
    QCShardPlan,
    bp_decode_qc_node_sharded,
    build_qc_shard_plan,
    decode_qc_node_sharded,
)
from qkd_ldpc_tpu_torch.parallel.sweep import (
    make_point_dispatcher,
    run_point_node_sharded,
    run_point_sharded,
    run_sweep_sharded,
)

__all__ = [
    "bp_decode_node_sharded",
    "decode_node_sharded",
    "QCShardPlan",
    "build_qc_shard_plan",
    "bp_decode_qc_node_sharded",
    "decode_qc_node_sharded",
    "NODE_AXIS",
    "TRIAL_AXIS",
    "Mesh",
    "initialize_distributed",
    "make_mesh",
    "make_trial_mesh",
    "make_point_dispatcher",
    "replicated",
    "trial_sharding",
    "run_point_node_sharded",
    "run_point_sharded",
    "run_sweep_sharded",
]
