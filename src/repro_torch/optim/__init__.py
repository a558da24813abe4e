"""Optimizers of the port: AdamW and LR schedules."""
