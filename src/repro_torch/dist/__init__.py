"""Distribution utilities (counterpart of :mod:`repro.dist`).

  sharding    — logical-name -> mesh-axis rules, ``shard``, ``param_spec``
  placement   — DTensor parameters on a ``DeviceMesh`` and the collectives
                of the mesh train step (gathers, Megatron's f and g)
  collectives — small exact-search collectives (top-k all-gather merges)
                over ``torch.distributed``
  elastic     — rebuild a mesh from surviving ranks after node loss
  compat      — process-local array assembly (the reference's jax shims
                have no torch counterpart)
"""
from repro_torch.dist import collectives, compat, elastic, placement, sharding  # noqa: F401
