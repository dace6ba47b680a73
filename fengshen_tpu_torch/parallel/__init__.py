"""Parallelism: only the one-device loss so far (see
:mod:`.cross_entropy`); the mesh and sharding rules are not yet ported."""
