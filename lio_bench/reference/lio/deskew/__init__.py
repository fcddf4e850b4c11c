"""Per-point motion compensation."""
