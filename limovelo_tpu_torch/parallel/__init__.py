from .sharding import AXIS, Mesh, make_mesh, make_sharded_step

__all__ = ["AXIS", "Mesh", "make_mesh", "make_sharded_step"]
