"""Learned models of the control plane: the profile corrector and the
performance surrogate it trains.

Port of `inferno_tpu/models/__init__.py` for the surrogate; the linear
profile fit and the transformer profiling blocks go with the
profiling-blocks slice.
"""

from inferno_tpu_torch.models.surrogate import (
    Surrogate,
    SurrogateConfig,
    featurize,
    surrogate_forward,
    surrogate_params_from_jax,
)

__all__ = [
    "Surrogate",
    "SurrogateConfig",
    "featurize",
    "surrogate_forward",
    "surrogate_params_from_jax",
]
