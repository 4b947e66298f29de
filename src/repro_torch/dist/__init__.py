"""The distribution layer on ``torch.distributed``: logical-axis rules
mapped onto a ``DeviceMesh`` as DTensor placements (``sharding``) and
the activation constraints the models call (``context``).  Importing it
touches no process group."""
from . import context, sharding

__all__ = ["context", "sharding"]
