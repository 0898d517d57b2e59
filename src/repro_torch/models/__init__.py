"""Models (counterpart of :mod:`repro.models`); only ``lm.embed_hidden`` is
ported so far."""
