"""AdamW and the learning-rate schedules of the port (`adamw.py`)."""
