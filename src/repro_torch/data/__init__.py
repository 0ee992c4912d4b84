"""Training data of the port: ``data/pipeline.py``."""
