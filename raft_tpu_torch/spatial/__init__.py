"""Nearest-neighbour search of the port."""
