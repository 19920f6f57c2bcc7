"""The LM model stack: the dense and hybrid families' serving path and forward."""
