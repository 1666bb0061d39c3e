"""Model construction and the serving step."""
