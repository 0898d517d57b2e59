"""Training (counterpart of :mod:`repro.train`): ``losses``, ``train_step``
and ``trainer``."""
