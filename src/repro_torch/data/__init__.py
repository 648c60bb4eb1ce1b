"""Synthetic image data and federated partitions (numpy, copied from the
reference so the same seed gives the same bytes)."""
