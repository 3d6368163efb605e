"""Cost-matrix families (numpy only)."""
