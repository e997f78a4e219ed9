"""K1's share of its roofline over a step's forward calls, every microbatch's five."""

from hmvbench.readers import k1_roofline as read  # noqa: F401
