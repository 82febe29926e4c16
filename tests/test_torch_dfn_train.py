"""PyTorch port vs the JAX package: the DeepFilterNet trainer and the
differentiable GRU.

Same seeds and batches through ``egregora_tpu`` and ``egregora_tpu_torch``
on the CPU, float32, at the published DFN2 / DFN3 widths, batch 2 and 12
frames.  Tolerances:

* ``loss_fn`` and its gradient against ``jax.value_and_grad`` for both
  variants: loss relative 1e-5, each leaf's gradient relative L2 5e-5
  (measured 4e-6); every leaf's gradient is nonzero, the GRUs' and the
  encoder's included (with the GRU run under ``no_grad``, as it was, they
  get none and this test fails);
* ``_torch_gru`` (one ``torch.nn.GRU`` recurrence on the reordered
  weights) against a step loop of plain operations, outputs and the
  gradients of its three weights and its input: max |d| 1e-5 relative to
  the largest; DFN2's block-diagonal grouped GRU against its eight GRUs
  run one by one, the same;
* ``train(steps=2)`` (Adam without clipping on ``synth_batch``) in both
  packages from one seed: each trained leaf relative L2 1e-2 and its
  update (trained minus initial) 2e-2 (measured 1e-4 and 3.9e-3: Adam's
  first steps are near ``lr * sign(g)``, so the gradients' 4e-6
  differences flip whole steps on components whose gradient is near zero,
  and a zero-initialised bias is all update);
* ``train_device`` of DFN3 for two steps against the JAX ``train_device``'s
  loop with its synthesis run op by op (``jax_train_device_loop``;
  measured 1.7e-3), on
  ``synth_batch_device``'s data (host draws, CPU synthesis): the same
  limits;
* the CLI at two steps writes only under ``EGREGORA_TPU_WEIGHTS``, and no
  file under ``egregora_tpu/`` changes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chip_smoke import package_digest
from egregora_tpu.models.deepfilternet import model as j_model
from egregora_tpu.models.deepfilternet import train as j_train
from egregora_tpu.models.rnnoise import train as j_rn_train
from egregora_tpu_torch.models.deepfilternet import model as t_model
from egregora_tpu_torch.models.deepfilternet import train as t_train
from egregora_tpu_torch.models.rnnoise import train as t_rn_train
from egregora_tpu_torch.utils.weights import sorted_leaves
from test_torch_rnnoise_train import ROOT, rel, tree_np

VARIANTS = ("DeepFilterNet2", "DeepFilterNet3")
BATCH, FRAMES = 2, 12
LOSS_TOL = 1e-5
GRAD_TOL = 5e-5
GRU_TOL = 1e-5
TRAIN_TOL = 1e-2
UPDATE_TOL = 2e-2


@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_and_gradients_match_jax(variant):
    noisy, clean, _ = j_rn_train.synth_batch(np.random.default_rng(3), BATCH, FRAMES)
    params = j_model.init_params(0, j_model.DFNConfig.for_variant(variant))
    lj, gj = jax.jit(jax.value_and_grad(j_train.loss_fn))(params, jnp.asarray(noisy),
                                                           jnp.asarray(clean))
    tp = t_rn_train.trainable(params, "cpu")
    lt = t_train.loss_fn(tp, torch.from_numpy(noisy), torch.from_numpy(clean))
    gt = torch.autograd.grad(lt, t_rn_train.leaves(tp), allow_unused=True)
    assert abs(float(lt.detach()) - float(lj)) <= LOSS_TOL * abs(float(lj))
    ref = list(sorted_leaves(tree_np(gj)))
    assert len(ref) == len(gt)
    for (path, g), t in zip(ref, gt):
        name = "/".join(path)
        assert t is not None and float(t.norm()) > 0, f"{name}: no gradient"
        assert rel(t.numpy(), g) <= GRAD_TOL, name
    names = {"/".join(p) for p, _ in ref}
    assert any(n.startswith("enc/") for n in names) and any("gru" in n for n in names)


def gru_loop(kernel, recurrent, bias, xs):
    """The JAX package's GRU step (z, r, n; no recurrent bias) as a loop."""
    u = recurrent.shape[0]
    h = xs.new_zeros(xs.shape[0], u)
    out = []
    for t in range(xs.shape[1]):
        xw, hw = xs[:, t] @ kernel + bias, h @ recurrent
        z = torch.sigmoid(xw[:, :u] + hw[:, :u])
        r = torch.sigmoid(xw[:, u:2 * u] + hw[:, u:2 * u])
        n = torch.tanh(xw[:, 2 * u:] + r * hw[:, 2 * u:])
        h = (1 - z) * n + z * h
        out.append(h)
    return torch.stack(out, 1)


def _close(a, b):
    return float((a - b).abs().max()) <= GRU_TOL * max(float(b.abs().max()), 1e-30)


def test_gru_gradient_matches_a_step_loop():
    g = torch.Generator().manual_seed(0)
    i, u = 12, 16
    ws = [torch.randn(i, 3 * u, generator=g) * 0.3, torch.randn(u, 3 * u, generator=g) * 0.3,
          torch.randn(3 * u, generator=g) * 0.1, torch.randn(2, 9, i, generator=g)]
    outs = []
    for fn in (t_model._torch_gru, gru_loop):
        leaves = [w.clone().requires_grad_(True) for w in ws]
        y = fn(*leaves)
        (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        outs.append([y.detach()] + [w.grad for w in leaves])
    for a, b in zip(*outs):
        assert a is not None and _close(a, b)


def test_grouped_gru_is_the_groups_one_by_one():
    params = t_rn_train.trainable(j_model.init_params(1)["gru"], "cpu")
    x = torch.randn(2, 7, 256, generator=torch.Generator().manual_seed(1))
    got = t_model._grouped_gru(params, x)
    parts = [gru_loop(params[str(k)]["kernel"], params[str(k)]["recurrent"],
                      params[str(k)]["bias"], x[..., 32 * k: 32 * (k + 1)]) for k in range(8)]
    ref = torch.cat(parts, -1)
    assert _close(got.detach(), ref.detach())
    ga = torch.autograd.grad(got.sum(), [params["3"]["recurrent"], params["5"]["kernel"]])
    gb = torch.autograd.grad(ref.sum(), [params["3"]["recurrent"], params["5"]["kernel"]])
    for a, b in zip(ga, gb):
        assert _close(a, b)


def _compare_trees(got, ref, init):
    for (path, r), (_, g), (_, p0) in zip(sorted_leaves(ref), sorted_leaves(got),
                                          sorted_leaves(init)):
        name = "/".join(path)
        assert rel(g, r) <= TRAIN_TOL and rel(g - p0, r - p0) <= UPDATE_TOL, name


def test_train_matches_jax():
    ref = tree_np(j_train.train(steps=2, batch=BATCH, frames=FRAMES, seed=2, log_every=0))
    got = t_train.train(steps=2, batch=BATCH, frames=FRAMES, seed=2, log_every=0, device="cpu")
    _compare_trees(got, ref, j_model.init_params(2))


def jax_train_device_loop(steps, batch, frames, params, seed):
    """The JAX ``train_device``'s loop from ``params`` on its own pieces:
    ``synth_batch_device`` run op by op, then ``loss_fn``'s gradient and
    the optax chain it builds, each compiled.  Its whole-step program fuses
    the synthesis, and the compiled synthesis alone moves the batch by
    1.5e-5 relative, which two Adam steps carry to the zero-initialised
    biases at up to 4.6e-2 (measured against the whole loop run op by op,
    which this loop matches to 1.7e-4)."""
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(optax.cosine_decay_schedule(1e-3, steps, 0.05)))
    state, base = tx.init(params), jax.random.PRNGKey(seed + 1)
    grad = jax.jit(jax.grad(j_train.loss_fn))
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s)))
    for i in range(steps):
        noisy, clean, _ = j_rn_train.synth_batch_device(jax.random.fold_in(base, i), batch, frames)
        params, state = update(grad(params, noisy, clean), state, params)
    return tree_np(params)


def test_train_device_matches_jax():
    # the port's init_params is the JAX package's within 1e-6 (test_torch_dfn.py)
    init = t_model.init_params(5, t_model.DFNConfig.for_variant("DeepFilterNet3"))
    ref = jax_train_device_loop(2, BATCH, FRAMES, init, 5)
    got = t_train.train_device(steps=2, batch=BATCH, frames=FRAMES, seed=5, log_every=0,
                               cfg=t_model.DFNConfig.for_variant("DeepFilterNet3"),
                               device="cpu")
    _compare_trees(got, ref, init)


def test_cli_writes_under_the_weights_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    before = package_digest()
    t_train.main(["--variant", "DeepFilterNet3", "--steps", "2", "--batch", "1", "--cpu"])
    out = tmp_path / "deepfilternet" / "pretrained_dfn3.npz"
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == [out]
    from egregora_tpu.utils.weights import load_params
    ref = j_model.init_params(0, j_model.DFNConfig.for_variant("DeepFilterNet3"))
    assert {p for p, _ in sorted_leaves(load_params(out))} == {p for p, _ in sorted_leaves(ref)}
    assert package_digest() == before
    assert t_train.pretrained_path("DeepFilterNet3").parent == (
        ROOT / "egregora_tpu" / "models" / "deepfilternet")
    if not torch.cuda.is_available():     # the entry points run on the card or raise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_train.train(steps=1)
