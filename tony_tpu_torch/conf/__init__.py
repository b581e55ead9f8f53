"""Configuration keys the port reads (``keys``)."""
