"""Weight loading (``from_numpy``: the JAX package's parameter tree to and
from the port's modules) and npz checkpoints (``io``)."""
from .io import latest_step, restore_checkpoint, save_checkpoint  # noqa: F401
