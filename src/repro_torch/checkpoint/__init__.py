"""Checkpointing (counterpart of :mod:`repro.checkpoint`): ``manager``."""
