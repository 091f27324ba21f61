"""Processes, the device mesh and sharding (``mesh``)."""
