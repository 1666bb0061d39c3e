"""Meshes of devices and values sharded over them."""
