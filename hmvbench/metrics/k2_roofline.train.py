"""K2's share of its roofline on each microbatch's images, forward only."""

from hmvbench.readers import k2_roofline as read  # noqa: F401
