"""Launch-time policies (mirror of ``repro.launch``). Only the render
mesh's shard policy is ported so far (``mesh.render_mesh_shards``)."""
