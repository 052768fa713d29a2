"""Checkpoints in the reference's ``repro/ckpt@1`` format (numpy only)."""
