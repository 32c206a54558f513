"""Model families of the port (the base trunk so far)."""
