"""Console reporting helpers."""
