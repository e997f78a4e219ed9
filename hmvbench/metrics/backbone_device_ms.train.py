"""Device milliseconds a step of the operations launched inside the
program's ``backbone`` spans (both microbatches' backbone forward)."""

from hmvbench.spans import span_device_ms

read = span_device_ms("backbone")
