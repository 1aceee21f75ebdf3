"""Checkpoints of the whole train state (``store``)."""
from .store import latest_step, load_checkpoint, save_checkpoint  # noqa: F401
