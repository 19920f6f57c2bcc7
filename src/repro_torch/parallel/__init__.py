"""Sharding over a device mesh: plans, the activation context, the pipeline."""
