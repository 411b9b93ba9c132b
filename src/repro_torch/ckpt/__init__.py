"""Durable checkpoints in the reference's on-disk format (``checkpoint``)."""
