"""Expert parallelism over ``torch.distributed``: the EP context (the
port's ``DistContext``), the token-block rule of the JAX package's
``batch_spec`` and the collectives the S-ETP and ETP bodies use."""
from .context import DistContext, make_mesh
from .sharding import TokenBlock, batch_axes, token_block

__all__ = ["DistContext", "make_mesh", "TokenBlock", "batch_axes",
           "token_block"]
