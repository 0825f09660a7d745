"""Utilities of the port that belong to no layer (image, HDF5 and mesh files,
cv2's camera models, plots, profiling)."""
