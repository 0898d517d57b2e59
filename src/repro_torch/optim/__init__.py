"""Optimizer (counterpart of :mod:`repro.optim`): ``adamw``, ``compression``
and ``schedule``."""
