"""Functional ops of the port (attention)."""
