"""Distribution: device meshes, sharded sweeps, multi-process bring-up.

Counterpart of ``qkd_ldpc_tpu/parallel``: the trial mesh and the sharded
point and sweep runners (``sweep``), the general node-sharded flooding
decoder (``node_sharded``) and the process group (``mesh``, gloo over
``torch.distributed``).  The QC node-sharded decoder of the JAX package
(``bp_decode_qc_node_sharded``, ``decode_qc_node_sharded``, with its layered
composition) is not ported yet and not exported: ROADMAP item 11b.  A node
axis that spans processes is item 11c.
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
from qkd_ldpc_tpu_torch.parallel.sweep import (
    make_point_dispatcher,
    run_point_node_sharded,
    run_point_sharded,
    run_sweep_sharded,
)

__all__ = [
    "bp_decode_node_sharded",
    "decode_node_sharded",
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
