"""Model configs, layers, attention and the dense transformer."""
