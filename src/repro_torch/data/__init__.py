"""The deterministic token pipeline of the port (`pipeline.py`)."""
