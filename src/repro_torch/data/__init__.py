"""Synthetic data for the port's serving paths."""
