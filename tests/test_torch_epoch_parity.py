"""The first epoch of the port's training path against the JAX package's on
the CPU: the port's TrainLoader (native image ops) into Trainer.fit_epoch
against the JAX TrainLoader into the JAX Trainer.fit_epoch, from the same
weights, on a synthetic MFNet-shaped dataset (mit_tiny at 32x32). fp32,
drop rates 0; losses within rtol 1e-4 (the batches themselves are held
bit-equal in tests/test_torch_data.py).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import rgbx_semantic_segmentation_tpu.native as jnative
from rgbx_semantic_segmentation_tpu import config as jconfig
from rgbx_semantic_segmentation_tpu import train as jtrain
from rgbx_semantic_segmentation_tpu.data.loader import (
    TrainLoader as JTrainLoader)
from rgbx_semantic_segmentation_tpu.models.builder import (
    EncoderDecoder as JaxEncoderDecoder)
from rgbx_semantic_segmentation_tpu.parallel import mesh as jmesh
from rgbx_semantic_segmentation_tpu_torch.convert import (
    flax_to_torch_state_dict)
from rgbx_semantic_segmentation_tpu_torch.data.loader import TrainLoader
from rgbx_semantic_segmentation_tpu_torch.data.synthetic import (
    make_synthetic_dataset)
from rgbx_semantic_segmentation_tpu_torch.train import Trainer
from tests.test_torch_cli import small_cfg

torch.set_num_threads(2)


def test_first_epoch_losses_match_jax(tmp_path):
    """The first epoch of the port's training path (TrainLoader on the
    native ops -> Trainer.fit_epoch) against the JAX Trainer.fit_epoch fed
    by the JAX TrainLoader (on the JAX package's own native build), from
    the same weights (numpy from a seed on the JAX tree, carried across):
    fp32, drop rates 0, the preset's lr and warm-up, losses within rtol
    1e-4. (AdamW moves every coordinate by about the lr whatever the size
    of its gradient, so coordinates whose true gradient is 0 follow each
    framework's rounding noise: tests/test_torch_train.py's trajectory test
    holds five steps at lr 1e-3 to rtol 1e-3.)"""
    from tests.test_torch_layers import random_variables

    ds = make_synthetic_dataset(str(tmp_path), num_train=5, num_val=1,
                                hw=(32, 32), num_classes=5, seed=8)
    tcfg = small_cfg(ds)
    tcfg = tcfg.replace(
        model=dataclasses.replace(tcfg.model, drop_path_rate=0.0,
                                  decoder_dropout_ratio=0.0),
        train=dataclasses.replace(tcfg.train, niters_per_epoch=4, nepochs=2))
    jcfg = jconfig.Config(
        dataset=jconfig.DatasetConfig(**dataclasses.asdict(tcfg.dataset)),
        model=jconfig.ModelConfig(**dataclasses.asdict(tcfg.model)),
        train=jconfig.TrainConfig(**dataclasses.asdict(tcfg.train)),
        eval=jconfig.EvalConfig(**dataclasses.asdict(tcfg.eval)))
    x = np.zeros((1, 32, 32, 3), np.float32)
    var = random_variables(lambda: JaxEncoderDecoder(cfg=jcfg).init(
        jax.random.PRNGKey(0), x, x), seed=5)

    def recording(trainer, losses):
        real = trainer.step

        def step(batch):
            out = real(batch)
            losses.append(float(np.asarray(out["loss"])))
            return out
        trainer.step = step

    mesh = jmesh.make_mesh(n_devices=1)
    jt = jtrain.Trainer(jcfg, mesh=mesh, seed=0, init_values=False)
    jt.state = jt.state.replace(
        params=jmesh.replicate(mesh, var["params"]),
        batch_stats=jmesh.replicate(mesh, var["batch_stats"]))
    jlib = jnative.ensure_built()
    assert jlib is not None, "the JAX package's native/libcvops.so: g++ failed"
    saved = jnative._lib, jnative._tried
    jnative._lib, jnative._tried = jlib, True
    try:
        jl = JTrainLoader(jcfg, num_workers=2)
        jlosses = []
        recording(jt, jlosses)
        jt.epoch = 1
        jmean = jt.fit_epoch(iter(jl.epoch(1)), jl.niters)
    finally:
        jnative._lib, jnative._tried = saved
    tt = Trainer(tcfg, device="cpu", init_values=False)
    tt.model.load_state_dict(flax_to_torch_state_dict(var), strict=True)
    tl = TrainLoader(tcfg, num_workers=2)
    tlosses = []
    recording(tt, tlosses)
    tt.epoch = 1
    tmean = tt.fit_epoch(tl.epoch(1), tl.niters)
    assert len(tlosses) == len(jlosses) == 4
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tmean == pytest.approx(jmean, rel=1e-4)
    assert tlosses[-1] != tlosses[0]
