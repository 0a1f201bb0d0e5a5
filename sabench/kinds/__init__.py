"""Traffic loops, one a mix `kind` names."""
