"""The train and eval steps of the port (`steps.py`)."""
