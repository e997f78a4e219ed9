"""Training's peak of allocated device memory over the window, in GB."""

from hmvbench.readers import peak_mem_gb as read  # noqa: F401
