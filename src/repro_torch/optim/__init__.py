"""AdamW, the cosine schedule and global-norm clipping."""
from .adamw import (AdamWState, Optimizer, adamw, clip_by_global_norm,  # noqa: F401
                    cosine_schedule)
