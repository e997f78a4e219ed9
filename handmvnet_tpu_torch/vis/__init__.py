from handmvnet_tpu_torch.vis.visualizer import HandPoseVisualizer, reverse_transform  # noqa: F401
