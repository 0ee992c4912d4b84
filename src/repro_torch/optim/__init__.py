"""Optimizers of the port: AdamW as plain functions on nested dicts."""
