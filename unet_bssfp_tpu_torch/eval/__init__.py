"""Volume inference."""
