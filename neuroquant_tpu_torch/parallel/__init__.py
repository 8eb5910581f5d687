from neuroquant_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, all_reduce_grads, all_reduce_sum, data_parallel_step, is_main,
    launch, make_mesh, replicate, run_rank, shard_batch,
)
