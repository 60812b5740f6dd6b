"""Checkpointing: train states into the coded tier and back (host and device-direct)."""
