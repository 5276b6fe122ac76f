"""Device placement for the port: a serving "mesh" is a tuple of
``torch.device`` (``mesh.make_serving_mesh``, ``mesh.shard_devices``)."""
