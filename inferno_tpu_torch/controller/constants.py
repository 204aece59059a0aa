"""Shared controller constants (kept dependency-free so the watch module
and tooling can import them without pulling in the solver/jax stack).

ConfigMap names mirror the reference's configuration surface
(upstream internal/controller/variantautoscaling_controller.go:
490-514, 584-594) on this build's naming.

Port copy of `inferno_tpu/controller/constants.py`, verbatim apart from its imports.
"""

CM_CONFIG = "inferno-autoscaler-config"
CM_ACCELERATOR_COSTS = "accelerator-unit-costs"
CM_SERVICE_CLASSES = "service-classes-config"

# Truthy-string parsing shared by env knobs (config.defaults.env_bool)
# and ConfigMap knobs (reconciler) so accepted spellings cannot diverge.
# The definition moved to config/defaults.py with the typed env
# accessors; re-exported here for the existing importers.
from inferno_tpu_torch.config.defaults import parse_bool  # noqa: E402,F401
