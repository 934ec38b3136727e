"""Optimizer: AdamW with fp32 master weights."""
