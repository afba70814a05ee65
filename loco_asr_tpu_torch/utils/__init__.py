"""Device resolution and metrics."""
