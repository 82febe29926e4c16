"""PyTorch port vs the JAX package: the RNNoise trainer and the shared
optimizer chain (``egregora_tpu_torch.models.optim.AdamChain``).

Same seeds and batches through ``egregora_tpu`` and ``egregora_tpu_torch``
on the CPU, float32, at batch 2 and 12 frames.  Tolerances:

* ``synth_batch``: bit for bit;
* ``synth_batch_device``: every uniform draw bit for bit, the noise's
  normals within 1e-6 (XLA:CPU's float32 ``log1p`` inside ``erf_inv`` is
  its own polynomial); the waves relative L2 1e-5 (measured 3.2e-7) and
  the VAD targets equal;
* ``loss_fn`` and its gradient against ``jax.value_and_grad``: loss
  relative 1e-5, each leaf's gradient relative L2 5e-3 (measured 5e-4: the
  two packages' float32 DC blockers are ~1e-4 relative apart, and the GRU
  chain carries that).  The batch starts with a quiet lead-in that fades
  in: on a frame whose pitch windows hold no energy (frame 0's zero
  history) the period follows FFT roundoff in both packages and differs
  (a divergence of the reference, pinned by ``test_torch_rnnoise.py::
  test_period_divergence_is_pinned``); without the lead-in the gains of
  the first frames differ by 2e-2 and the gradients by 1-6%;
* ``AdamChain`` against optax for two steps of each chain the trainers
  use (``clip_by_global_norm`` + ``adam``, triggered and not; plain
  ``adam``; ``adamw`` with zero-gradient leaves, which it decays, at the
  DAC trainer's decay and at one large enough to show in float32): max
  |d| 1e-6 relative to the largest parameter;
* ``train(steps=2)`` in both packages from one seed (the batches given the
  same lead-in in both): each trained leaf relative L2 5e-3 (measured
  1.3e-3), and its update (trained minus initial) relative L2 0.1
  (measured 5.5e-2: Adam's first steps are near ``lr * sign(g)``, so the
  gradients' 5e-4 differences flip whole steps on the few components
  whose gradient is near zero);
* the CLI at two steps writes only under ``EGREGORA_TPU_WEIGHTS``, and no
  file under ``egregora_tpu/`` changes.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import package_digest
from egregora_tpu.models.rnnoise import model as j_model
from egregora_tpu.models.rnnoise import train as j_train
from egregora_tpu_torch.models.flashsr import prng
from egregora_tpu_torch.models.optim import AdamChain, cosine_decay
from egregora_tpu_torch.models.rnnoise import train as t_train
from egregora_tpu_torch.utils.weights import sorted_leaves

ROOT = Path(__file__).resolve().parents[1]
BATCH, FRAMES = 2, 12
LEAD, FADE = 960, 480              # samples of the quiet lead-in and its fade
WAVE_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 5e-3
OPT_TOL = 1e-6
TRAIN_TOL = 5e-3
UPDATE_TOL = 0.1


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def lead_in(x: np.ndarray) -> np.ndarray:
    """``x`` with a quiet (1e-6 noise) lead-in of ``LEAD`` samples and a
    raised-cosine fade over the next ``FADE``."""
    i = np.arange(x.shape[-1])
    env = 0.5 - 0.5 * np.cos(np.pi * np.clip((i - LEAD) / FADE, 0.0, 1.0))
    quiet = 1e-6 * np.random.default_rng(9).standard_normal(x.shape)
    return (x * env + quiet).astype(np.float32)


def led_batch(rng, batch, frames, synth=j_train.synth_batch):
    noisy, clean, vad = synth(rng, batch, frames)
    return lead_in(noisy), lead_in(clean), vad


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_batch_bit_for_bit(seed):
    got = t_train.synth_batch(np.random.default_rng(seed), BATCH, FRAMES)
    ref = j_train.synth_batch(np.random.default_rng(seed), BATCH, FRAMES)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)


def jax_draws(key, batch, frames):
    """The random numbers the JAX ``synth_batch_device`` draws (its calls,
    in its order)."""
    out = []
    for k in jax.random.split(key, batch):
        ks = jax.random.split(k, 8)
        u = jax.random.uniform
        out.append({"f0": u(ks[0], (), minval=100.0, maxval=300.0),
                    "amps": u(ks[1], (8,), minval=0.05, maxval=0.3),
                    "ph": u(ks[2], (8,), maxval=6.28),
                    "env_rate": u(ks[3], (), minval=2.0, maxval=6.0),
                    "env_ph": u(ks[4], (), maxval=6.28),
                    "noise": jax.random.normal(ks[5], (frames * j_model.FRAME,), jnp.float32),
                    "coin": u(ks[6], ()),
                    "snr_db": u(ks[7], (), minval=0.0, maxval=15.0)})
    return {n: np.stack([np.asarray(d[n]) for d in out]) for n in out[0]}


@pytest.mark.parametrize("seed", [1, 7])
def test_synth_batch_device_matches_jax(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    tkey = prng.fold_in(prng.prng_key(seed), 3)
    got, ref = t_train.synth_draws(tkey, BATCH, FRAMES), jax_draws(key, BATCH, FRAMES)
    assert set(got) == set(ref)
    for name in ref:
        if name == "noise":
            np.testing.assert_allclose(got[name], ref[name], rtol=0, atol=1e-6)
        else:
            assert np.array_equal(got[name], ref[name]), name
    jn, jc, jv = (np.asarray(a) for a in j_train.synth_batch_device(key, BATCH, FRAMES))
    tn, tc, tv = (a.numpy() for a in t_train.synth_batch_device(tkey, BATCH, FRAMES, "cpu"))
    assert tn.shape == jn.shape == (BATCH, FRAMES * j_model.FRAME)
    assert rel(tn, jn) <= WAVE_TOL and rel(tc, jc) <= WAVE_TOL
    assert np.array_equal(tv, jv)


def test_loss_and_gradients_match_jax():
    noisy, clean, vad = led_batch(np.random.default_rng(3), BATCH, FRAMES)
    params = j_model.init_params(0)
    lj, gj = jax.jit(jax.value_and_grad(j_train.loss_fn))(
        params, jnp.asarray(noisy), jnp.asarray(clean), jnp.asarray(vad))
    tp = t_train.trainable(params, "cpu")
    lt = t_train.loss_fn(tp, *(torch.from_numpy(a) for a in (noisy, clean, vad)))
    gt = torch.autograd.grad(lt, t_train.leaves(tp))
    assert abs(float(lt.detach()) - float(lj)) <= LOSS_TOL * abs(float(lj))
    ref = list(sorted_leaves(tree_np(gj)))
    assert len(ref) == len(gt) == 15
    for (path, g), t in zip(ref, gt):
        assert np.linalg.norm(g) > 0 and rel(t.numpy(), g) <= GRAD_TOL, "/".join(path)


def _grads(params, scale, zero=()):
    rng = np.random.default_rng(int(scale * 1000))
    return {k: (np.zeros_like(v) if k in zero else
                (scale * rng.standard_normal(v.shape)).astype(np.float32))
            for k, v in params.items()}


CHAINS = {
    # name: (optax chain, AdamChain keywords, gradient scale)
    "clip+adam, clipped": (lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
        optax.cosine_decay_schedule(3e-3, 4, 0.05))), dict(lr=3e-3, steps=4, alpha=0.05, clip=1.0),
        2.0),
    "clip+adam, unclipped": (lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adam(
        optax.cosine_decay_schedule(3e-3, 4, 0.05))), dict(lr=3e-3, steps=4, alpha=0.05, clip=1.0),
        0.01),
    "adam": (lambda: optax.adam(optax.cosine_decay_schedule(1e-3, 3, 0.05)),
             dict(lr=1e-3, steps=3, alpha=0.05, clip=None), 0.5),
    "clip+adamw": (lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.cosine_decay_schedule(3e-4, 2, 0.1), weight_decay=1e-5)),
        dict(lr=3e-4, steps=2, alpha=0.1, clip=1.0, weight_decay=1e-5), 3.0),
    # a decay large enough to move the zero-gradient leaf in float32
    "clip+adamw, visible decay": (lambda: optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.cosine_decay_schedule(3e-2, 2, 0.1), weight_decay=0.5)),
        dict(lr=3e-2, steps=2, alpha=0.1, clip=1.0, weight_decay=0.5), 3.0),
}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_adam_chain_matches_optax(name):
    make_tx, kw, scale = CHAINS[name]
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((4, 6)).astype(np.float32),
              "b": rng.standard_normal((6,)).astype(np.float32),
              "frozen": rng.standard_normal((3, 3)).astype(np.float32)}
    tx = make_tx()
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = tx.init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = AdamChain([tp[k] for k in sorted(tp)], **kw)
    for step in range(2):
        g = _grads(params, scale * (step + 1), zero=("frozen",))
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        # the frozen leaf's gradient is None here: it steps as a zero
        opt.step([None if k == "frozen" else torch.from_numpy(g[k]) for k in sorted(tp)])
    peak = max(float(np.abs(v).max()) for v in params.values())
    for k in params:
        assert np.abs(tp[k].numpy() - np.asarray(jp[k])).max() <= OPT_TOL * peak, k
    if kw.get("weight_decay", 0) > 0.1:
        assert not np.array_equal(tp["frozen"].numpy(), params["frozen"])   # decayed
    assert cosine_decay(kw["lr"], kw["steps"], kw["alpha"], 1) == pytest.approx(
        float(optax.cosine_decay_schedule(kw["lr"], kw["steps"], kw["alpha"])(1)), rel=1e-6)


def test_train_matches_jax(monkeypatch):
    j_synth, t_synth = j_train.synth_batch, t_train.synth_batch
    monkeypatch.setattr(j_train, "synth_batch", lambda rng, b, f: led_batch(rng, b, f, j_synth))
    monkeypatch.setattr(t_train, "synth_batch", lambda rng, b, f: led_batch(rng, b, f, t_synth))
    ref = tree_np(j_train.train(steps=2, batch=BATCH, frames=FRAMES, seed=4, log_every=0))
    got = t_train.train(steps=2, batch=BATCH, frames=FRAMES, seed=4, log_every=0, device="cpu")
    init = j_model.init_params(4)
    for (path, r), (_, g), (_, p0) in zip(sorted_leaves(ref), sorted_leaves(got),
                                          sorted_leaves(init)):
        assert rel(g, r) <= TRAIN_TOL and rel(g - p0, r - p0) <= UPDATE_TOL, "/".join(path)


def test_cli_writes_under_the_weights_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    before = package_digest()
    t_train.main(["--steps", "2", "--batch", "2", "--cpu"])
    out = tmp_path / "rnnoise" / "pretrained.npz"
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == [out]
    from egregora_tpu.utils.weights import load_params
    tree = load_params(out)
    assert set(dict(sorted_leaves(tree))) == set(dict(sorted_leaves(j_model.init_params(0))))
    assert package_digest() == before
    assert t_train.pretrained_path() == ROOT / "egregora_tpu" / "models" / "rnnoise" / "pretrained.npz"
    if not torch.cuda.is_available():     # the entry points run on the card or raise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_train.train_device(steps=1)
