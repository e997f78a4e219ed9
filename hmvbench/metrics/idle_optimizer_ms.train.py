"""The device's idle milliseconds a step inside the program's ``clip`` and
``adamw`` spans (gradient clipping, then AdamW's step), in the device-only
slice."""

from hmvbench.spans import span_idle_ms

read = span_idle_ms("clip", "adamw")
