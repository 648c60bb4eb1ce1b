"""Synthetic image data, federated partitions and the synthetic LM corpus
(numpy, copied from the reference so the same seed gives the same bytes)."""
