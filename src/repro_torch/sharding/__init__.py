"""The sharding policy: how parameters, caches and batches lie on a mesh."""
