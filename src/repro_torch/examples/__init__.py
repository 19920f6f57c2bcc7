"""Runnable examples of the port's workflow (``python -m
repro_torch.examples.quickstart``, ``python -m
repro_torch.examples.profile_comm_patterns``)."""
