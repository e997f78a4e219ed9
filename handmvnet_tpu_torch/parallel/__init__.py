"""Data parallelism over devices (counterpart of the data-parallel half of
handmvnet_tpu/parallel/): one process a device, ``torch.distributed``
collectives. The step's own collectives are in train_step.py."""

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
    warmup_collectives,
)
