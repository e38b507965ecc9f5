"""Config sections of the port."""
