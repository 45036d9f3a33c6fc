"""Models of the port: the dense transformer family."""
