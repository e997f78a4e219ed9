"""Device milliseconds a step of the kernels launched inside the optimizer's
step (a range opened and closed by the global optimizer step hooks): AdamW's
update, not the clipping before it."""

from hmvbench.readers import range_device_ms

read = range_device_ms("optimizer")
