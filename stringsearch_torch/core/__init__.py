"""Core types, comparison, verification and queries."""
