"""runtime subpackage."""
