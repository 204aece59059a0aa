"""Synthetic fixtures for the port's tests and `chip_smoke.py`.

Port of `inferno_tpu/testing/`: `fleet` (N-variant fleets, scrape
targets, fake Prometheus tables), `apiserver.MiniApiServer` (a Kubernetes
API server over real sockets, the envtest analogue: resourceVersions,
merge and JSON patches, subresources, watch streams with 410 resync,
lease optimistic concurrency, CRD schema validation from the committed
manifest) and `hpa` (the prometheus-adapter, HPA and KEDA actuators that
close the production loop over the controller's gauges).
"""

from inferno_tpu_torch.testing.apiserver import MiniApiServer

__all__ = ["MiniApiServer"]
