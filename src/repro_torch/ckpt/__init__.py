"""Checkpoint manager and the sweep journal (crc-framed, resumable)."""
