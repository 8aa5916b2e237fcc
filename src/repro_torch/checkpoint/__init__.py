"""Checkpoints: save, restore, retention."""
