"""Tile merge and submission packaging."""
