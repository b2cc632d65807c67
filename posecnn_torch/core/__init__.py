"""Configuration and weight I/O of the port."""
