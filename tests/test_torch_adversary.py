"""The port's c-GAN adversary training (``privacy/reconstruct.py:
train_adversary``) against the reference's on the CPU, at the arguments
of the reference's ``test_adversary_reconstructs_shallow_layer`` (smoke
VGG-16, layer 1, 60 steps, batch 8, n_eval 32, seed 0) with the same VGG
weights (the reference's ``init_params(PRNGKey(0))``, carried across).

The SSIM is held within 0.05 of the reference's, the final G loss within
1.5 and the D loss within 0.6. Sixty GAN steps amplify float rounding,
and the losses are one batch's readings. The reference reads SSIM
0.2717, G 8.07, D 1.55; twelve port runs (1, 2, 3, 4, 6 and 8 torch
threads, the reference's weights and the keyed ones) read SSIM
0.264-0.283, G 7.80-8.74, D 1.16-1.54. Each tolerance is 1.5 times the
widest spread among those thirteen runs (SSIM 0.019, G 0.94, D 0.39),
rounded up, the SSIM's kept at 0.05. The same tolerances gate the card
against the CPU in chip_smoke.py.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (before kernels: circular import)
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.privacy import reconstruct as JR  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.privacy import reconstruct as TR  # noqa: E402

SSIM_TOL = 0.05
G_LOSS_TOL = 1.5
D_LOSS_TOL = 0.6
# the port's 60 steps on 4 intra-op threads (~7 s, ~21 s on one): the
# reference's run takes the whole machine anyway, and 4 threads are among
# the runs that set the tolerances
PORT_THREADS = 4


@pytest.fixture(scope="module")
def smoke_vgg():
    """The reference test's VGG weights (``init_params(PRNGKey(0))``, run
    eagerly as that test runs it) as numpy, and both smoke configs."""
    jcfg = jget_smoke("vgg16")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp), get_smoke("vgg16"), jcfg


def test_train_adversary_matches_reference_ssim(smoke_vgg):
    """The reference's own test arguments and seed: the port reproduces
    the reference's SSIM (the reference's assertion on it, SSIM above the
    noise floor + 0.1, fails in the reference itself and is not held
    here)."""
    np_params, cfg, jcfg = smoke_vgg
    kw = dict(layer=1, steps=60, batch=8, n_eval=32)
    want = JR.train_adversary(np_params, jcfg, **kw)
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        got = TR.train_adversary(V.params_from_numpy(np_params, "cpu"), cfg,
                                 device="cpu", **kw)
    finally:
        torch.set_num_threads(threads)
    assert (got.layer, got.steps) == (want.layer, want.steps) == (1, 60)
    assert abs(got.ssim - want.ssim) <= SSIM_TOL, (got, want)
    assert abs(got.g_loss - want.g_loss) <= G_LOSS_TOL, (got, want)
    assert abs(got.d_loss - want.d_loss) <= D_LOSS_TOL, (got, want)
    assert got.step_ms > 0 and got.collect_ms > 0
