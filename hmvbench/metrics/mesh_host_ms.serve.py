"""Host milliseconds a frame in the mesh stage's call (``joints_to_vertices_fn``)."""

from hmvbench.readers import mesh_host_ms as read  # noqa: F401
