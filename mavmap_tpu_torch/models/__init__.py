"""Camera models."""
