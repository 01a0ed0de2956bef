"""Tile merge, submission packaging and the VOC-style AP evaluation."""
