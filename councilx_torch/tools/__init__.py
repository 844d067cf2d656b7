"""Tools of the port that run end to end (counterparts of ``tools/``)."""
