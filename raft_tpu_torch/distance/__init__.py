"""Distances of the port."""
