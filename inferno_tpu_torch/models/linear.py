"""Offline fitting of linear performance profiles.

The reference derives per-accelerator decode/prefill parameters
(alpha/beta/gamma/delta) by hand from two benchmark points
(upstream docs/tutorials/parameter-estimation.md:241-266). Here the
same profiles are fit by least squares over arbitrarily many measured
(batch, in_tokens, latency) samples from a TPU serving engine
(JetStream / vLLM-TPU), so profiles improve as telemetry accumulates.

Port copy of `inferno_tpu/models/linear.py`, verbatim apart from its
imports (numpy over the port's `config.types`) and the docstring's path
to the upstream tutorial.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from inferno_tpu_torch.config.types import DecodeParms, ModelPerfSpec, PrefillParms


@dataclasses.dataclass(frozen=True)
class FittedProfile:
    decode: DecodeParms
    prefill: PrefillParms
    decode_rmse: float  # msec
    prefill_rmse: float  # msec

    def to_perf_spec(
        self, model: str, acc: str, max_batch_size: int, at_tokens: int,
        slices_per_replica: int = 1,
    ) -> ModelPerfSpec:
        return ModelPerfSpec(
            name=model,
            acc=acc,
            slices_per_replica=slices_per_replica,
            max_batch_size=max_batch_size,
            at_tokens=at_tokens,
            decode_parms=self.decode,
            prefill_parms=self.prefill,
        )


def _fit_line(x: np.ndarray, y: np.ndarray) -> tuple[float, float, float]:
    """y ~ a + b x with non-negative base and slope; returns (a, b, rmse)."""
    a_mat = np.stack([np.ones_like(x), x], axis=1)
    coef, *_ = np.linalg.lstsq(a_mat, y, rcond=None)
    a, b = float(coef[0]), float(coef[1])
    a, b = max(a, 0.0), max(b, 0.0)
    rmse = float(np.sqrt(np.mean((a + b * x - y) ** 2)))
    return a, b, rmse


def fit_profile(
    decode_batch: np.ndarray,
    decode_itl_ms: np.ndarray,
    prefill_batch: np.ndarray,
    prefill_in_tokens: np.ndarray,
    prefill_ms: np.ndarray,
) -> FittedProfile:
    """Fit decode ITL(batch) = alpha + beta*batch and
    prefill(batch, in_tokens) = gamma + delta*in_tokens*batch.

    Inputs are 1-D sample arrays (decode and prefill samples independent).
    """
    decode_batch = np.asarray(decode_batch, dtype=np.float64)
    decode_itl_ms = np.asarray(decode_itl_ms, dtype=np.float64)
    if decode_batch.size < 2:
        raise ValueError("need at least two decode samples")
    alpha, beta, d_rmse = _fit_line(decode_batch, decode_itl_ms)

    x = np.asarray(prefill_in_tokens, dtype=np.float64) * np.asarray(
        prefill_batch, dtype=np.float64
    )
    prefill_ms = np.asarray(prefill_ms, dtype=np.float64)
    if x.size < 2:
        raise ValueError("need at least two prefill samples")
    gamma, delta, p_rmse = _fit_line(x, prefill_ms)

    return FittedProfile(
        decode=DecodeParms(alpha=alpha, beta=beta),
        prefill=PrefillParms(gamma=gamma, delta=delta),
        decode_rmse=d_rmse,
        prefill_rmse=p_rmse,
    )
