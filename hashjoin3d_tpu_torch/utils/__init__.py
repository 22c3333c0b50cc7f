"""Data generation, CSV writer and repetition protocol of the port."""
