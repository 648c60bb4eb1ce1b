"""The paper's CNNs."""
