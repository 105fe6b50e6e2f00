"""Float64 goldens of the port (numpy only)."""
