"""The port's six lr schedules (and CyclicLR's momentum schedule) against
the JAX package's build_schedule on the CPU, over steps that cross every
boundary: the warm-up's end, MultiStageLR's stage boundaries, StepLR's
epoch periods, CyclicLR's restarts, each epoch's first and last step, and
past the last epoch. Both sides compute in fp32: rel 1e-6 (pow and cos may
differ in the last bit; read: bit-equal)."""
import numpy as np
import pytest

from rgbx_semantic_segmentation_tpu import lr_schedules as jsched
from rgbx_semantic_segmentation_tpu.config import TrainConfig
from rgbx_semantic_segmentation_tpu_torch import lr_schedules as tsched

NITERS = 7
# epochs 0..11 of 7 steps: each epoch's first, second and last step, and
# beyond the 10 epochs of the run
STEPS = sorted({e * NITERS + k for e in range(12) for k in (0, 1, NITERS - 1)})


def _train(warm_up_epoch):
    return TrainConfig(lr=2e-3, nepochs=10, niters_per_epoch=NITERS,
                       warm_up_epoch=warm_up_epoch, lr_power=0.9,
                       lr_stages=((2, 2e-3), (5, 6e-4), (8, 1e-4)),
                       end_lr=5e-3, min_lr=1e-5, cycle_epochs=3,
                       lr_step_size=3, lr_gamma=0.3)


CASES = [(name, 2) for name in ("WarmUpPolyLR", "PolyLR", "MultiStageLR",
                                "LinearIncreaseLR", "CyclicLR", "StepLR")]
# CyclicLR without warm-up: JAX computes its warm-up branch as inf / nan
# and discards it; the port takes the cyclic branch at every step.
CASES += [("CyclicLR", 0), ("CyclicLR-momentum", 2),
          ("CyclicLR-momentum", 0), ("WarmUpPolyLR", 0)]


@pytest.mark.parametrize("name,warm", CASES)
def test_schedule_matches_jax(name, warm):
    tc = _train(warm)
    if name == "CyclicLR-momentum":
        want = jsched.cyclic_lr(tc.min_lr, tc.lr, tc.cycle_epochs,
                                tc.warm_up_epoch, tc.total_iters,
                                tc.niters_per_epoch)[1]
        got = tsched.cyclic_schedules(tc)[1]
    else:
        want = jsched.build_schedule(name, tc)
        got = tsched.build_schedule(name, tc)
    ref = np.array([float(want(s)) for s in STEPS])
    out = np.array([got(s) for s in STEPS])
    assert all(isinstance(got(s), float) for s in STEPS[:3])
    assert np.all(np.isfinite(ref)) and np.all(np.isfinite(out))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    # the schedule does change over the steps (boundaries crossed)
    assert len(set(out.tolist())) > 2
