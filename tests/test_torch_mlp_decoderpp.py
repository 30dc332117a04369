"""Whole mit_b0 / mit_tiny models with the MLPDecoder++ head against the
JAX package on the CPU in fp32: the checks of tests/test_torch_mask2former.py
(eval output, one train step's loss and gradients, Trainer.step against the
JAX make_train_step, the evaluator), with their tolerances; the head alone
is in tests/test_torch_heads.py."""
import pytest
import torch

from rgbx_semantic_segmentation_tpu_torch.models.decoders import (
    mlp_decoderpp as tmlppp)
from tests.test_torch_mask2former import (
    check_evaluate, check_model_eval, check_train_step, check_trainer_steps,
    whole_model)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def case():
    return whole_model("MLPDecoderpp")


def test_head_layout(case):
    """The original repo's key layout: 1x1 conv embeddings, the fuse and
    the SE gate as Sequentials (the gate's convs at indices 1 and 3), both
    GELUs exact, channel-wise dropout at the config's rate."""
    cfg, _, _, model, _, _ = case
    head = model.decode_head
    assert isinstance(head, tmlppp.MLPDecoderpp)
    keys = {k.rsplit(".", 1)[0] for k in head.state_dict()}
    assert keys == {"linear_c1", "linear_c2", "linear_c3", "linear_c4",
                    "linear_fuse.0", "linear_fuse.1", "attention.1",
                    "attention.3", "linear_pred"}
    gelus = [m for m in head.modules() if isinstance(m, torch.nn.GELU)]
    assert len(gelus) == 2 and {m.approximate for m in gelus} == {"none"}
    assert head.dropout.rate == 0.1
    assert head.linear_fuse[1].eps == cfg.model.bn_eps


def test_model_matches_jax(case):
    check_model_eval(case)


def test_train_step_matches_jax(case, monkeypatch):
    out = check_train_step(case, monkeypatch)
    assert out.shape == (2, 64, 80, 5)


def test_trainer_steps_match_jax(monkeypatch):
    check_trainer_steps("MLPDecoderpp", monkeypatch)


def test_evaluate_matches_jax(tmp_path):
    check_evaluate("MLPDecoderpp", tmp_path)
