"""Utilities of the port that belong to no layer (image files)."""
