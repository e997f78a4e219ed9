"""Device milliseconds a frame of the kernels launched inside the backbone's
forward (a range opened and closed by module hooks on ``model.backbone``)."""

from hmvbench.readers import range_device_ms

read = range_device_ms("backbone")
