"""The device's idle milliseconds a step inside the program's ``backward``
spans (each microbatch's ``.backward()``), in the device-only slice."""

from hmvbench.spans import span_idle_ms

read = span_idle_ms("backward")
