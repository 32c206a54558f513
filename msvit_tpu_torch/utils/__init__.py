"""Utilities of the port: explicit random streams and metrics logging."""
