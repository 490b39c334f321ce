from .mesh import make_particle_mesh, shard_current, shard_history

__all__ = ["make_particle_mesh", "shard_current", "shard_history"]
