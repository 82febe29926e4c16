"""PyTorch port vs the JAX package: a whole DAC training run.

``train(steps=2)`` in both packages from one seed on the CPU, at the
float32 config of ``test_torch_dac_train.py`` (512 samples, batch 2, no
held-out evaluations): one ``ae`` step, the codebooks from data and one
``proj`` step (rvq only, EMA; the encoder and decoder only decayed), every
random number from the same key chain (the ``vq`` phase's step is
``ema_loss_fn`` and ``ema_codebook_update``, which
``test_torch_dac_train.py`` holds to the JAX package's).  Each trained
leaf relative L2 1e-3 and its update (trained minus its package's
initial) 5e-2 (measured 8.9e-7 and 4.4e-4), a leaf the JAX run left unmoved unmoved here too (Adam's
first steps are near ``lr * sign(g)``, so the gradients' 1e-6
differences can flip whole steps on components whose gradient is near
zero).  The JAX
package's ``init_params`` runs compiled (its values equal the op-by-op
run's; the op-by-op flax init of this config takes ~20 s on the CPU).
"""
import jax
import numpy as np

from egregora_tpu.models.dac import model as J
from egregora_tpu.models.dac import train as j_train
from egregora_tpu_torch.models.dac import model as T
from egregora_tpu_torch.models.dac import train as t_train
from egregora_tpu_torch.utils.weights import _flatten
from test_torch_dac_train import JCFG, TCFG, jax_init
from test_torch_rnnoise_train import rel, tree_np

TRAIN_TOL = 1e-3
UPDATE_TOL = 5e-2


def test_train_matches_jax(monkeypatch):
    monkeypatch.setattr(J.DACModel, "init_params", lambda self, seed=0: jax_init(seed))
    kw = dict(steps=2, batch=2, length=512, seed=3, log_every=0, eval_every=False,
              model_type="16khz")
    _, ref = j_train.train(cfg=JCFG, **kw)
    model, got = t_train.train(cfg=TCFG, device="cpu", **kw)
    t_init = _flatten(t_train.params_tree(T.DACModel(TCFG).init_params(3)))
    ref, got, init = _flatten(tree_np(ref)), _flatten(got), _flatten(jax_init(3))
    assert set(ref) == set(got)
    for k in ref:
        # each package's update from its own init (the two inits differ by
        # an ulp on some kernel elements)
        du_j, du_t = ref[k] - init[k], got[k] - t_init[k]
        assert rel(got[k], ref[k]) <= TRAIN_TOL, k
        if np.linalg.norm(du_j) == 0:          # frozen so far: not moved here either
            assert not du_t.any(), k
        else:
            assert rel(du_t, du_j) <= UPDATE_TOL, k
    assert _flatten(t_train.params_tree(model)).keys() == got.keys()
