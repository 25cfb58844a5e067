"""Sequence classification over the swarm (CPU, float32): the port's
``DistributedModelForSequenceClassification`` over a port server against
petals_tpu's over a petals_tpu server, for Llama, BLOOM and Falcon
(40b-style) classification checkpoints.

- The pooled logits (each row at its last non-pad token) equal petals_tpu's
  and HF's *ForSequenceClassification (atol 2e-4, tests/test_classification.py's
  bound against HF).
- ``compute_cls_loss_and_grads`` under "ptune" and "deep_ptune" equals
  ``petals_tpu.client.training``'s from the same prompts: the loss within
  1e-5, the grads atol 1e-4 (petals_tpu's float32 backward bound). The port
  server's backward runs each family's block under autograd.
- Every family with a client carries the classification hooks, and the
  classifier refuses a batch without a pad token as HF does.

Every wait is bounded."""

import numpy as np
import pytest
import torch

from petals_tpu.client.model import AutoDistributedModelForSequenceClassification as JaxCls
from petals_tpu.client.ptune import PTuneConfig as JaxPTuneConfig
from petals_tpu.client.training import compute_cls_loss_and_grads as jax_cls_loss_and_grads
from petals_tpu_torch.client import PTuneConfig
from petals_tpu_torch.client.model import AutoDistributedModelForSequenceClassification as PortCls
from petals_tpu_torch.client.training import compute_cls_loss_and_grads, sgd_step
from tests.test_torch_training import MiniSwarm
from tests.utils import make_tiny_bloom_cls, make_tiny_llama_cls

ATOL = 1e-4
HF_ATOL = 2e-4
PRE_SEQ = 2

pytestmark = pytest.mark.timeout(600)


def _make_falcon_cls(root):
    from transformers import FalconConfig, FalconForSequenceClassification

    cfg = FalconConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
        layer_norm_epsilon=1e-5, new_decoder_architecture=True, num_kv_heads=2,
        multi_query=False, parallel_attn=True, bias=False, alibi=False,
        num_labels=3, pad_token_id=0,
    )
    torch.manual_seed(6)
    path = f"{root}/tiny-falcon-cls"
    FalconForSequenceClassification(cfg).eval().save_pretrained(path, safe_serialization=True)
    return path


MAKERS = {"llama": (make_tiny_llama_cls, 4), "bloom": (make_tiny_bloom_cls, 3), "falcon": (_make_falcon_cls, 3)}


@pytest.fixture(scope="module", params=sorted(MAKERS))
def family_swarms(request, tmp_path_factory):
    maker, n = MAKERS[request.param]
    path = maker(str(tmp_path_factory.mktemp("models")))
    jax_swarm = MiniSwarm(path, [("jax", 0, n, {})], str(tmp_path_factory.mktemp("cache"))).start()
    port_swarm = MiniSwarm(path, [("port", 0, n, {})], str(tmp_path_factory.mktemp("cache"))).start()
    yield request.param, path, jax_swarm, port_swarm
    port_swarm.stop()
    jax_swarm.stop()


def _ids():
    ids = np.random.RandomState(4).randint(1, 100, (2, 6)).astype(np.int64)
    ids[0, 4:] = 0  # a padded tail: row 0 pools at position 3
    return ids


def test_cls_logits_equal_petals_tpu_and_hf(family_swarms):
    from transformers import AutoModelForSequenceClassification

    name, path, jax_swarm, port_swarm = family_swarms
    ids = _ids()
    jmodel = JaxCls.from_pretrained(path, initial_peers=jax_swarm.initial_peers)
    pmodel = PortCls.from_pretrained(path, initial_peers=port_swarm.initial_peers, device="cpu")
    try:
        assert (pmodel.num_labels, pmodel.pad_token_id) == (jmodel.num_labels, jmodel.pad_token_id) == (3, 0)
        np.testing.assert_array_equal(pmodel.pool_positions(ids), jmodel.pool_positions(ids))
        got = pmodel.forward(ids).detach().numpy()
        assert got.shape == (2, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(jmodel.forward(ids)), rtol=0, atol=ATOL)
        hf = AutoModelForSequenceClassification.from_pretrained(path, dtype=torch.float32).eval()
        with torch.no_grad():
            np.testing.assert_allclose(got, hf(torch.from_numpy(ids)).logits.numpy(), rtol=0, atol=HF_ATOL)
    finally:
        pmodel.close()
        jmodel.close()


@pytest.mark.parametrize("mode", ["ptune", "deep_ptune"])
def test_cls_loss_and_grads_equal_petals_tpu(family_swarms, mode):
    name, path, jax_swarm, port_swarm = family_swarms
    ids, labels = _ids(), np.array([2, 0])
    jmodel = JaxCls.from_pretrained(path, initial_peers=jax_swarm.initial_peers, ptune=JaxPTuneConfig(PRE_SEQ, mode))
    pmodel = PortCls.from_pretrained(path, initial_peers=port_swarm.initial_peers, device="cpu",
                                     ptune=PTuneConfig(PRE_SEQ, mode))
    try:
        pmodel.set_trainable_params({k: np.array(v) for k, v in jmodel.trainable_params().items()})
        want_loss, want = jax_cls_loss_and_grads(jmodel, ids, labels)
        loss, grads = compute_cls_loss_and_grads(pmodel, ids, labels)
        assert abs(loss - want_loss) <= 1e-5
        assert set(grads) == set(want)
        for key in want:
            np.testing.assert_allclose(grads[key].numpy(), np.asarray(want[key]), rtol=0, atol=ATOL, err_msg=key)
        if mode == "deep_ptune":  # one classification step lowers the loss
            sgd_step(pmodel, grads, lr=0.5)
            assert compute_cls_loss_and_grads(pmodel, ids, labels)[0] < loss
    finally:
        pmodel.close()
        jmodel.close()


def test_every_client_family_has_cls_hooks_and_pooling_needs_a_pad_token():
    from petals_tpu_torch.models.registry import get_family

    for name in ("llama", "mistral", "qwen2", "mixtral", "bloom", "falcon", "gemma", "phi3"):
        family = get_family(name)
        assert family.cls_head is not None and family.hf_to_cls_params is not None, name
        assert any(p.startswith("score") for p in family.hf_cls_prefixes), name
    from petals_tpu_torch.client.model import DistributedModelForSequenceClassification

    model = DistributedModelForSequenceClassification.__new__(DistributedModelForSequenceClassification)
    model.pad_token_id, model.ptune = None, PTuneConfig()
    with pytest.raises(ValueError, match="without a pad token"):
        model.pool_positions(np.zeros((2, 3), np.int64))
    np.testing.assert_array_equal(model.pool_positions(np.zeros((1, 3), np.int64)), [2])
