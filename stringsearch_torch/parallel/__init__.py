"""Partitioned suffix arrays."""
