"""Serving (counterpart of :mod:`repro.serve`): the kNN-LM datastore and the
continuous-batching front end.  The decode engine (``serve/engine.py``)
waits for the model slice."""
from repro_torch.serve.frontend import ContinuousBatcher
from repro_torch.serve.knnlm import KNNDatastore

__all__ = ["ContinuousBatcher", "KNNDatastore"]
