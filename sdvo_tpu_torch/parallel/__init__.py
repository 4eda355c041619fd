"""The port's ``seq`` parallelism axis: N sequences in one batched superstep."""

from sdvo_tpu_torch.parallel.batched_vo import batched_align_step  # noqa: F401
from sdvo_tpu_torch.parallel.mesh import SeqShards, VOMesh, make_vo_mesh  # noqa: F401
from sdvo_tpu_torch.parallel.multi_seq import (  # noqa: F401
    MultiSequenceSystem,
    multi_chunk_fn,
    stack_states,
    unstack_states,
    vmap_fallbacks,
)
