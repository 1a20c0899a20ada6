"""SAS subprocess wrappers and PPS directory handling (`pipeline.py`)."""
