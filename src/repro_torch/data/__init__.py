"""Synthetic token data for the trainer."""
