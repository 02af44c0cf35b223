"""Sharding rules and activation annotations (twin of ``repro/parallel``)."""
