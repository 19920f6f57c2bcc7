"""Launchers: training on one device."""
