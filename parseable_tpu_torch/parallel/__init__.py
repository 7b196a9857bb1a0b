"""Distributed query execution over a device mesh (`parallel/mesh.py`)."""
