"""Serving (counterpart of :mod:`repro.serve`): the decode engine, the
kNN-LM datastore and the continuous-batching front end."""
from repro_torch.serve.frontend import ContinuousBatcher
from repro_torch.serve.knnlm import KNNDatastore

__all__ = ["ContinuousBatcher", "KNNDatastore"]
