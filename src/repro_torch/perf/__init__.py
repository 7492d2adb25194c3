"""Analytic performance terms of the port (FLOP counts)."""
