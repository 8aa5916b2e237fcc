"""Layer graphs of the models the port plans splits for."""
