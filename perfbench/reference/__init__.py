"""The plain references that decide each cell's ``correct``."""
