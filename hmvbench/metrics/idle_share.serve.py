"""The device's idle share in serving's traced slice."""

from hmvbench.readers import idle_share as read  # noqa: F401
