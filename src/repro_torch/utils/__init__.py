"""Helpers shared across the port's model stack."""
