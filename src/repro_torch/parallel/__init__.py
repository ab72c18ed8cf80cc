"""Logical-axis sharding of the port (DTensor placements)."""
