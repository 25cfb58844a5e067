"""(g) The port's microbatch pipeline (petals_tpu_torch/parallel/
pipeline.py) against petals_tpu's SPMD ``pipeline_apply`` on the CPU,
float32: an 8-layer llama span of random weights cut into pp stages (over
tests/conftest.py's host devices in JAX, a list of CPU stage devices in the
port), M microbatches, at (pp, M) = (4, 4), (2, 6) and (1, 2). The outputs,
and the gradients of sum(y * g) at the input and at every weight, agree
within 2e-5 (the JAX test's 2e-5 on values); the schedule takes M + pp - 1
steps; and both refuse a batch that does not split and a stack that does
not divide, with the same messages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from petals_tpu.models.llama.block import block_apply as jax_block_apply
from petals_tpu.models.llama.config import LlamaBlockConfig as JaxConfig
from petals_tpu.parallel.mesh import make_mesh
from petals_tpu.parallel.pipeline import microbatch_split as jax_split
from petals_tpu.parallel.pipeline import pipeline_apply as jax_pipeline
from petals_tpu_torch.models.llama.block import block_apply
from petals_tpu_torch.models.llama.config import LlamaBlockConfig
from petals_tpu_torch.parallel import pipeline

TOL = 2e-5
WIDTHS = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16, intermediate_size=128,
              num_hidden_layers=8, rms_norm_eps=1e-6, vocab_size=128)
NAMES = ("ln1", "wq", "wk", "wv", "wo", "ln2", "wg", "wu", "wd")


def _weights(seed: int = 0) -> dict:
    """Stacked [8, ...] float32 leaves of an 8-layer span (norms near 1)."""
    rng = np.random.RandomState(seed)
    h, q, kv, m = 64, 64, 32, 128
    shapes = {"ln1": (h,), "wq": (h, q), "wk": (h, kv), "wv": (h, kv), "wo": (q, h), "ln2": (h,), "wg": (h, m),
              "wu": (h, m), "wd": (m, h)}
    out = {}
    for name in NAMES:
        w = rng.randn(8, *shapes[name]).astype(np.float32) * 0.05
        out[name] = w + 1.0 if name.startswith("ln") else w
    return out


def _jax_run(weights, hidden, grad, pp, num_micro):
    cfg = JaxConfig(**WIDTHS)
    mesh = make_mesh((pp,), ("pp",))

    def stage_fn(stage_params, h):
        def body(h, p_block):
            out, _ = jax_block_apply(p_block, h, None, 0, cfg)
            return out, None

        return jax.lax.scan(body, h, stage_params)[0]

    def loss(params, x):
        y = jax_pipeline(stage_fn, params, jax_split(x, num_micro), mesh=mesh)
        return (y.reshape(x.shape) * grad).sum(), y

    params = {k: jnp.asarray(v) for k, v in weights.items()}
    with mesh:
        (_, y), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(hidden))
    return np.asarray(y), np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


def _port_run(weights, hidden, grad, pp, num_micro):
    cfg = LlamaBlockConfig(**WIDTHS)
    layers = [{k: torch.tensor(v[i], requires_grad=True) for k, v in weights.items()} for i in range(8)]
    x = torch.tensor(hidden, requires_grad=True)

    def stage_fn(stage_params, h):
        for p in stage_params:
            h, _ = block_apply(p, h, None, 0, cfg)
        return h

    pipeline.reset_schedule_steps()
    y = pipeline.pipeline_apply(stage_fn, layers, pipeline.microbatch_split(x, num_micro), ["cpu"] * pp)
    assert pipeline.schedule_steps() == num_micro + pp - 1
    (y.reshape(x.shape) * torch.from_numpy(grad)).sum().backward()
    gp = {k: np.stack([layer[k].grad.numpy() for layer in layers]) for k in NAMES}
    return y.detach().numpy(), x.grad.numpy(), gp


@pytest.mark.timeout(300)
@pytest.mark.parametrize("pp,num_micro", [(4, 4), (2, 6), (1, 2)])
def test_pipeline_and_its_gradients_match_jax(pp, num_micro):
    weights = _weights()
    rng = np.random.RandomState(1)
    batch, seq = num_micro * 2, 8
    hidden = rng.randn(batch, seq, 64).astype(np.float32) * 0.1
    grad = rng.randn(batch, seq, 64).astype(np.float32) * 0.1
    jy, jgx, jgp = _jax_run(weights, hidden, grad, pp, num_micro)
    y, gx, gp = _port_run(weights, hidden, grad, pp, num_micro)
    np.testing.assert_allclose(y, jy, atol=TOL, rtol=0, err_msg="outputs")
    np.testing.assert_allclose(gx, jgx, atol=TOL, rtol=0, err_msg="input gradient")
    for name in NAMES:
        np.testing.assert_allclose(gp[name], jgp[name], atol=TOL, rtol=0, err_msg=f"{name} gradient")


def test_refusals_match_jax():
    x = np.zeros((6, 2, 4), np.float32)
    with pytest.raises(ValueError, match="batch 6 does not divide into 4 microbatches"):
        jax_split(jnp.asarray(x), 4)
    with pytest.raises(ValueError, match="batch 6 does not divide into 4 microbatches"):
        pipeline.microbatch_split(torch.from_numpy(x), 4)
    with pytest.raises(ValueError, match="layer stack 8 does not divide 3 stages"):
        pipeline.stage_params([{}] * 8, ["cpu"] * 3)
