"""Launchers: training on one device or across ranks, and the meshes."""
