"""Clustering of the port (the IVF coarse quantizer's k-means)."""
