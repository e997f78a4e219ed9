"""K2's share of its roofline on a frame's views."""

from hmvbench.readers import k2_roofline as read  # noqa: F401
