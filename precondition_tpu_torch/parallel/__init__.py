"""Distribution substrate: device meshes, shardings and rank groups.

`mesh` builds `torch.distributed` device meshes and the port's sharding
objects, the counterparts of the JAX package's `jax.sharding.Mesh` and
`NamedSharding`; `local` runs a function on a few processes of this host
joined by a process group, as the tests and `chip_smoke.py` do.
"""
