"""Model configuration dataclasses of the port (`config.py`)."""
