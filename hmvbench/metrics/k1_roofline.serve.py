"""K1's share of its roofline over a frame's five forward calls."""

from hmvbench.readers import k1_roofline as read  # noqa: F401
