"""Distribution utilities (counterpart of :mod:`repro.dist`).

  collectives — small exact-search collectives (top-k all-gather merges)
                over ``torch.distributed``

The reference's ``sharding``, ``elastic`` and ``compat`` modules are not
ported yet (ROADMAP Queue 1).
"""
from repro_torch.dist import collectives  # noqa: F401
