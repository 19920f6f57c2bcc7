"""The LM model stack: the dense family's serving path and forward pass."""
