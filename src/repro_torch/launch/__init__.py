"""Step builders for the serving path."""
