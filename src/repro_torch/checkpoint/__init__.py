"""checkpoint subpackage."""
