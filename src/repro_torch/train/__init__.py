"""Serving steps of the port (training waits for its slice, ROADMAP.md)."""
