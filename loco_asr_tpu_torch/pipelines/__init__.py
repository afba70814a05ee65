"""CLI entry points of the port."""
