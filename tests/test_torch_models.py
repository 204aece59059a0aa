"""Port of tests/test_models.py, on the port's imports: the learned
surrogate's shapes and parameter layout, `featurize`, and its fit of its
own teacher (the scalar queueing analyzer), each held to the reference.

tests/test_torch_linear.py carries the reference file's three
`fit_profile` cases. The teacher case trains on one CPU device at the
batch of dp 4 (`dp_batch_size`), the dp of the reference's (4, 2) mesh of
its 8 virtual devices; the (dp, tp) mesh of ranks runs it in
tests/test_torch_train_mesh.py.

Tolerances: the forward pass within 1e-5 absolute (outputs of order 1,
f32 sums in another order), `featurize` within 1e-6 relative (f32
columns), the teacher fit's first 20 step losses within 1e-4 relative of
the reference's, as in tests/test_torch_surrogate.py (the same batches;
tp splits only the reference's sums).
"""

import numpy as np
import torch

from inferno_tpu.models import surrogate as r_sur
from inferno_tpu_torch.models.surrogate import (
    N_FEATURES,
    N_OUTPUTS,
    Surrogate,
    SurrogateConfig,
    featurize,
    surrogate_forward,
    surrogate_param_specs,
    surrogate_params_from_jax,
)
from inferno_tpu_torch.parallel.train import dp_batch_size, fit_surrogate

FWD_ATOL = 1e-5
FEAT_RTOL = 1e-6
LOSS_RTOL = 1e-4


def test_surrogate_forward_shapes_and_specs():
    import jax

    cfg = SurrogateConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64)
    model = Surrogate(cfg)
    x = np.zeros((5, N_FEATURES), np.float32)
    out = surrogate_forward(model, x)
    assert out.shape == (5, N_OUTPUTS)
    # partition specs mirror the parameters exactly
    specs = surrogate_param_specs(cfg)
    assert set(specs) == {name for name, _ in model.named_parameters()}
    # the reference's weights at this config give the reference's output
    r_cfg = r_sur.SurrogateConfig(d_model=32, n_heads=4, n_layers=2, d_ff=64)
    params = r_sur.init_surrogate(jax.random.key(0), r_cfg)
    model.load_state_dict(surrogate_params_from_jax(params))
    x = np.random.default_rng(0).normal(size=(5, N_FEATURES)).astype(np.float32)
    np.testing.assert_allclose(
        surrogate_forward(model, x).numpy(),
        np.asarray(r_sur.surrogate_forward(params, x, r_cfg)), rtol=0, atol=FWD_ATOL)


def test_featurize_shape():
    n = 7
    cols = [np.ones(n)] * 10
    x = featurize(*cols)
    assert x.shape == (n, N_FEATURES)
    assert np.all(np.isfinite(x))
    cols = [np.random.default_rng(i).uniform(0.5, 60.0, n) for i in range(10)]
    np.testing.assert_allclose(featurize(*cols), np.asarray(r_sur.featurize(*cols)),
                               rtol=FEAT_RTOL)


def test_surrogate_learns_queueing_surface():
    """The surrogate must be able to fit its own teacher: targets produced
    by the scalar queueing analyzer."""
    from inferno_tpu.parallel import train as r_train
    from inferno_tpu_torch.analyzer import RequestSize, build_analyzer
    from inferno_tpu_torch.config.types import DecodeParms, PrefillParms

    rng = np.random.default_rng(1)
    rows, targets = [], []
    for _ in range(256):
        alpha = rng.uniform(5, 20)
        beta = rng.uniform(0.05, 0.4)
        in_tok, out_tok = int(rng.integers(64, 512)), int(rng.integers(16, 128))
        qa = build_analyzer(16, 160, DecodeParms(alpha, beta),
                            PrefillParms(3.0, 0.02), RequestSize(in_tok, out_tok))
        rate = rng.uniform(0.1, 0.9) * qa.max_rate
        m = qa.analyze(rate)
        rows.append([4, 1.2, alpha, beta, 3.0, 0.02, 16, in_tok, out_tok, rate])
        targets.append([m.avg_token_time, m.ttft, m.throughput])
    x = featurize(*np.array(rows, np.float32).T)
    y = np.log1p(np.array(targets, np.float32))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, losses = fit_surrogate(x, y, device="cpu", batch_size=dp_batch_size(256, 256, 4),
                                  epochs=200, learning_rate=3e-3)
    finally:
        torch.set_num_threads(threads)
    assert losses[-1] < losses[0] * 0.2  # clear learning signal
    assert np.isfinite(losses[-1])
    mesh = r_train.train_mesh()  # 8 virtual devices -> (4, 2) dp x tp
    assert dict(mesh.shape) == {"dp": 4, "tp": 2}
    _, ref = r_train.fit_surrogate(x, y, mesh=mesh, epochs=20, learning_rate=3e-3)
    np.testing.assert_allclose(losses[:20], ref, rtol=LOSS_RTOL, atol=0)
