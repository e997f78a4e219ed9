"""Device milliseconds a step of the operations launched inside the
program's ``backward`` spans (both microbatches' backward)."""

from hmvbench.spans import span_device_ms

read = span_device_ms("backward")
