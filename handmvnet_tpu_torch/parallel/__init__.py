"""Parallelism over devices (counterpart of handmvnet_tpu/parallel/): one
process a device, ``torch.distributed`` collectives. Data parallelism is in
mesh.py (the step's own collectives are in train_step.py), view-parallel
inference in view_parallel.py."""

from handmvnet_tpu_torch.parallel.mesh import (  # noqa: F401
    StopSignal,
    all_reduce_mean_,
    barrier,
    broadcast_module_,
    check_device_count,
    init_data_parallel,
    is_main,
    launched,
    rank_and_world,
    spawn_local_ranks,
    start_local_ranks,
    warmup_collectives,
)
from handmvnet_tpu_torch.parallel.view_parallel import (  # noqa: F401
    InferenceMesh,
    gather_outputs,
    gather_views,
    make_inference_mesh,
    make_replication_check,
    make_view_parallel_forward,
    view_block,
)
