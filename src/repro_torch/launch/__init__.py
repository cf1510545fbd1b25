"""Drivers of the port (serving so far)."""
