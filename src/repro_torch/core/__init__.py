"""The DFL / C-DFL algorithm on stacked per-node tensors."""
