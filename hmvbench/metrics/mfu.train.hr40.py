"""An optimizer step's forward and backward operations over its microbatches
(the frozen reference's count) x steps a second, over the peak."""

from hmvbench.readers import mfu as read  # noqa: F401
