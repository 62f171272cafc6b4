"""Data- and sequence-parallel analysis over torch.distributed (the JAX
package's parallel/): mesh.py builds the (data, seq) mesh, seqshard.py
runs the sequence-sharded analysis, dryrun.py certifies both on CPU ranks."""

from soundscope_tpu_torch.parallel.mesh import (  # noqa: F401
    data_sharding,
    global_batch,
    init_distributed,
    make_mesh,
    make_multihost_mesh,
    replicated,
    seq_sharding,
)
from soundscope_tpu_torch.parallel.seqshard import (  # noqa: F401
    pad_for_mesh,
    shard_granularity,
    sharded_analyze_fn,
)
