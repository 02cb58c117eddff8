"""Comparing the port's configs with the JAX package's copies: the port's
own fields, which the JAX package's ``ModelConfig`` does not have (a
leading dense layer and YaRN, DeepSeek-V2-Lite's), left out; at their
defaults the block is the one the JAX package builds."""
import dataclasses

PORT_ONLY_FIELDS = ("leading_dense_layers", "rope_scaling_factor",
                    "rope_original_max_pos", "rope_beta_fast",
                    "rope_beta_slow", "rope_mscale", "rope_mscale_all_dim")


def shared_fields(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without ``PORT_ONLY_FIELDS``."""
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in PORT_ONLY_FIELDS}
