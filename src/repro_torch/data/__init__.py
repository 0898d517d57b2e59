"""Data layer (counterpart of :mod:`repro.data`); ``dedup`` is ported."""
