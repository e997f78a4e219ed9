"""A frame's forward operations (the frozen reference's count) x frames a second,
over the peak of the work's precision."""

from hmvbench.readers import mfu as read  # noqa: F401
