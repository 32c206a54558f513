"""Model families of the port: the base trunk, token clustering and the
multistate encoder."""
