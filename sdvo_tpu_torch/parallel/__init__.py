"""The port's parallelism axes: ``seq`` (N sequences in one batched
superstep) and ``shard`` (landmark-sharded Schur BA and the edge-sharded pose
graph, over the mesh's shard devices and a process group)."""

from sdvo_tpu_torch.parallel.batched_vo import batched_align_step  # noqa: F401
from sdvo_tpu_torch.parallel.dist_ba import (  # noqa: F401
    ba_with_pose_graph_refine,
    distributed_local_ba,
    shard_observations,
)
from sdvo_tpu_torch.parallel.mesh import SeqShards, VOMesh, make_vo_mesh, shard_devices  # noqa: F401
from sdvo_tpu_torch.parallel.multi_seq import (  # noqa: F401
    MultiSequenceSystem,
    multi_chunk_fn,
    stack_states,
    unstack_states,
    vmap_fallbacks,
)
from sdvo_tpu_torch.parallel.pose_graph import (  # noqa: F401
    PoseGraphEdges,
    distributed_pose_graph,
    optimize_pose_graph,
)
