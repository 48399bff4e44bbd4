"""Measurement scripts of the port, run as ``python3 -m``."""
