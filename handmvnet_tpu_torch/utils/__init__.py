from handmvnet_tpu_torch.utils.misc import param_count, param_size  # noqa: F401
from handmvnet_tpu_torch.utils.profiling import StepTimer, trace  # noqa: F401
