"""subpackage."""
