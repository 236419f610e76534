"""Data generators (numpy), kept as the port's own copy."""
