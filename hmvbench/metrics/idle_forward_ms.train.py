"""The device's idle milliseconds a step inside the program's ``forward``
spans (each microbatch's model forward and loss), in the device-only slice."""

from hmvbench.spans import span_idle_ms

read = span_idle_ms("forward")
