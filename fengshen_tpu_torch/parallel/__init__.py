"""Parallelism: only the one-device losses so far (see
:mod:`.cross_entropy`); the mesh and sharding rules are not yet ported."""
