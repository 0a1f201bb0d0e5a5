"""Corpus generators (numpy only)."""
