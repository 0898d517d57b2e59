"""Data layer (counterpart of :mod:`repro.data`): ``dedup`` and ``pipeline``."""
