"""Learned and measured models of the control plane: the linear profile
fit, the profile corrector and the performance surrogate it trains, and
the transformer profiling blocks (`llama_block`, `gemma_block`) whose
timings `profiles` turns into linear profiles.

Port of `inferno_tpu/models/__init__.py`: the same linear-fit exports, and
the port's surrogate names in place of the reference's jax functions.
"""

from inferno_tpu_torch.models.linear import FittedProfile, fit_profile
from inferno_tpu_torch.models.surrogate import (
    Surrogate,
    SurrogateConfig,
    featurize,
    surrogate_forward,
    surrogate_param_specs,
    surrogate_params_from_jax,
)

__all__ = [
    "FittedProfile",
    "fit_profile",
    "Surrogate",
    "SurrogateConfig",
    "featurize",
    "surrogate_forward",
    "surrogate_param_specs",
    "surrogate_params_from_jax",
]
