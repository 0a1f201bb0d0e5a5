"""Text generators, one a configuration `generator` names."""
