"""PyTorch port vs the JAX package: the DAC codec's training pieces.

Same seeds and inputs through ``egregora_tpu`` and ``egregora_tpu_torch``
on the CPU, at a float32 config of a few channels (``encoder_dim`` 4,
strides (2, 2), ``decoder_dim`` 16, 3 books of 32 x 4; 512 samples, batch
2).  Tolerances:

* ``DACModel.init_params(seed)`` against flax's ``init_params(seed)``:
  the same leaves; biases, alphas and the zero output conv equal, the
  ``normal(1.0)`` codebooks and the truncated-normal (lecun) kernels max
  |d| 2.4e-7 (one float32 ulp at |x| < 2: XLA:CPU's ``log1p`` inside
  ``erf_inv`` is its own polynomial; most leaves are equal bit for bit);
* ``ResidualVQ`` in training mode (``with_losses``,
  ``collect_stage_data``) against flax's: codes equal, ``z_q``, the losses
  and ``r_stack`` max |d| 1e-5, the gradients of the parameters and of
  ``z`` max |d| 1e-5 of the largest;
* ``loss_fn``, ``ema_loss_fn``, ``ae_loss_fn`` (with the LSD term) and
  ``proj_loss_fn`` and their gradients against ``jax.value_and_grad``:
  loss relative 1e-5, each leaf relative L2 1e-4 (measured 1.4e-6), and
  the leaves JAX gives a zero gradient zero here too;
* ``ema_codebook_update`` from one key, with dead rows: the same rows
  restarted from the same picks, books and statistics max |d| 1e-5;
  ``init_codebooks_from_data`` from one seed on both ``choice`` branches
  (``replace=False``, a permutation, where there are at least as many
  frames as codes; ``replace=True`` where there are fewer): books max
  |d| 1e-5 (the picks equal);
* ``prng.randint`` / ``permutation`` / ``choice`` equal to ``jax.random``'s;
* ``_stft_w_schedule``, ``_target_deficit`` and ``should_ship`` equal on a
  table of cases;
* ``save_pretrained`` / ``load_pretrained`` across both packages (the JAX
  ``PRETRAINED`` pointed at a temporary directory): the same config and
  the same float16-rounded leaves;
* the CLI at two steps (a 16 kHz codec, 1024 samples) writes the
  candidate only under ``EGREGORA_TPU_WEIGHTS``, and no file under
  ``egregora_tpu/`` changes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import package_digest
from egregora_tpu.models.dac import model as J
from egregora_tpu.models.dac import train as j_train
from egregora_tpu_torch.models.dac import model as T
from egregora_tpu_torch.models.dac import train as t_train
from egregora_tpu_torch.models.flashsr import prng
from egregora_tpu_torch.utils.weights import _flatten, flax_tree
from test_torch_rnnoise_train import ROOT, rel, tree_np

TINY = dict(encoder_dim=4, strides=(2, 2), decoder_dim=16, n_codebooks=3, codebook_size=32,
            codebook_dim=4, res_scale=0.5, output_tanh=False, alpha_floor=0.05)
JCFG = J.DACConfig(sample_rate=16000, dtype=jnp.float32, **TINY)
TCFG = T.DACConfig(sample_rate=16000, dtype=torch.float32, **TINY)
INIT_ULP = 2.4e-7
VQ_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
EMA_TOL = 1e-5


FLAX_INIT = J.DACModel.init_params


@functools.lru_cache(maxsize=None)
def jax_init(seed: int):
    """flax's ``init_params(seed)`` (compiled: equal to the op-by-op run)."""
    return tree_np(jax.jit(functools.partial(FLAX_INIT, J.DACModel(JCFG)))(seed))


def port_model(seed: int = 1) -> T.DACModel:
    return T.DACModel(TCFG).load_jax(jax_init(seed))


def wav_batch(seed: int = 0, batch: int = 2, n: int = 512) -> np.ndarray:
    t = np.arange(n) / 16000
    rng = np.random.default_rng(seed)
    f = rng.uniform(200, 2000, (batch, 1))
    return (0.4 * np.sin(2 * np.pi * f * t) + 0.1 * rng.standard_normal((batch, n))
            ).astype(np.float32)


def port_grads(model: T.DACModel) -> dict:
    """The port's ``.grad``s as the JAX tree (zeros where ``None``)."""
    return _flatten({name: flax_tree(getattr(model, name), values=True, tensors={
        k: (p.grad if p.grad is not None else torch.zeros_like(p))
        for k, p in getattr(model, name).named_parameters()}) for name in ("encoder", "decoder", "rvq")})


def test_init_params_match_flax():
    for seed in (0, 3):
        ref = _flatten(jax_init(seed))
        got = _flatten(t_train.params_tree(T.DACModel(TCFG).init_params(seed)))
        assert set(got) == set(ref)
        same = 0
        for k in ref:
            if not k.endswith("kernel") and "codebook" not in k:
                assert np.array_equal(got[k], ref[k]), k
            assert np.abs(got[k] - ref[k]).max() <= INIT_ULP, k
            same += np.array_equal(got[k], ref[k])
        assert same > len(ref) // 2
        assert not ref["decoder/params/Conv_1/kernel"].any()


def test_residual_vq_training_mode_matches_flax():
    jp = jax_init(1)
    model = port_model(1)
    z = np.random.default_rng(4).standard_normal((2, 8, JCFG.latent_dim)).astype(np.float32)

    def jf(p, zz):
        zq, codes, c, cb, rs = J.ResidualVQ(JCFG).apply(p, zz, with_losses=True,
                                                         collect_stage_data=True)
        return jnp.sum(zq * 0.3) + c + 2.0 * cb, (zq, codes, c, cb, rs)

    (lj, (zq, codes, c, cb, rs)), (gp, gz) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(jp["rvq"], jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    tzq, tcodes, tc, tcb, trs = model.rvq(zt, with_losses=True, collect_stage_data=True)
    ((tzq * 0.3).sum() + tc + 2.0 * tcb).backward()
    assert np.array_equal(tcodes.numpy(), np.asarray(codes))
    for a, b in ((tzq, zq), (tc, c), (tcb, cb), (trs, rs)):
        assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= VQ_TOL
    ref = _flatten(tree_np(gp))
    got = _flatten(flax_tree(model.rvq, values=True,
                             tensors={k: p.grad for k, p in model.rvq.named_parameters()}))
    peak = max(np.abs(v).max() for v in ref.values())
    assert all(np.abs(got[k] - ref[k]).max() <= VQ_TOL * peak for k in ref)
    assert np.abs(zt.grad.numpy() - np.asarray(gz)).max() <= VQ_TOL * np.abs(gz).max()
    two = model.rvq(zt)
    assert len(two) == 2 and torch.equal(two[1], tcodes)


LOSSES = {"loss_fn": {"stft_w": 0.25, "lsd_w": 0.5}, "ema_loss_fn": {"stft_w": 0.1},
          "ae_loss_fn": {"stft_w": 0.25, "lsd_w": 0.5}, "proj_loss_fn": {}}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_and_gradients_match_jax(name):
    kw = LOSSES[name]
    aux = name in ("ema_loss_fn", "proj_loss_fn")
    jm, jp, wav = J.DACModel(JCFG), jax_init(1), wav_batch()
    fn = jax.value_and_grad(lambda p, w: getattr(j_train, name)(jm, p, w, **kw), has_aux=aux)
    lj, gj = jax.jit(fn)(jp, jnp.asarray(wav))
    model = port_model(1)
    out = getattr(t_train, name)(model, torch.from_numpy(wav), **kw)
    lt = out[0] if aux else out
    lt.backward()
    if aux:
        lj, (codes, r_stack) = lj
        assert np.array_equal(out[1][0].numpy(), np.asarray(codes))
        assert np.abs(out[1][1].numpy() - np.asarray(r_stack)).max() <= VQ_TOL
    assert abs(float(lt.detach()) - float(lj)) <= LOSS_TOL * abs(float(lj))
    ref, got = _flatten(tree_np(gj)), port_grads(model)
    assert set(ref) == set(got)
    for k in ref:
        if np.linalg.norm(ref[k]) == 0:
            assert not got[k].any(), k
        else:
            assert rel(got[k], ref[k]) <= GRAD_TOL, k


def test_ema_codebook_update_matches_jax():
    jp, model = jax_init(1), port_model(1)
    z = np.random.default_rng(5).standard_normal((2, 16, JCFG.latent_dim)).astype(np.float32)
    _, codes, _, _, r_stack = J.ResidualVQ(JCFG).apply(jp["rvq"], jnp.asarray(z), with_losses=True,
                                                        collect_stage_data=True)
    ema = j_train.init_ema_state(JCFG, jp)
    counts = np.asarray(ema["counts"]).copy()
    counts[:, ::3] = 0.01                  # dead rows: restarted from the batch
    ema = {"counts": jnp.asarray(counts), "sums": ema["sums"]}
    key = jax.random.PRNGKey(11)
    jp2, jema = jax.jit(functools.partial(j_train.ema_codebook_update, JCFG))(
        jp, ema, codes, r_stack, key)
    tema = t_train.ema_codebook_update(
        TCFG, model, {k: torch.tensor(np.asarray(v)) for k, v in ema.items()},
        torch.tensor(np.asarray(codes)), torch.tensor(np.asarray(r_stack)),
        prng.prng_key(11))
    for k in ("counts", "sums"):
        assert np.abs(tema[k].numpy() - np.asarray(jema[k])).max() <= EMA_TOL, k
    for i in range(JCFG.n_codebooks):
        ref = np.asarray(jp2["rvq"]["params"][f"codebook_{i}"])
        got = getattr(model.rvq, f"codebook_{i}").detach().numpy()
        assert np.abs(got - ref).max() <= EMA_TOL * max(1.0, np.abs(ref).max()), i
    dead = np.asarray(jema["counts"]) == 1.0
    assert dead.sum() >= JCFG.n_codebooks * JCFG.codebook_size // 3


@pytest.mark.parametrize("n", [512, 48])
def test_init_codebooks_from_data_matches_jax(n):
    """512 samples a item: 256 frames for 32 codes (a permutation); 48: 24
    frames (drawn with replacement)."""
    jp, model, wav = jax_init(1), port_model(1), wav_batch(2, n=n)
    jm = J.DACModel(JCFG)
    ref = jax.jit(lambda p, w: j_train.init_codebooks_from_data(jm, p, w, seed=3))(
        jp, jnp.asarray(wav))
    t_train.init_codebooks_from_data(model, torch.from_numpy(wav), seed=3)
    for i in range(JCFG.n_codebooks):
        r = np.asarray(ref["rvq"]["params"][f"codebook_{i}"])
        g = getattr(model.rvq, f"codebook_{i}").detach().numpy()
        assert np.abs(g - r).max() <= EMA_TOL * max(1.0, np.abs(r).max()), i


@pytest.mark.parametrize("seed", [0, 9])
def test_prng_integer_draws_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for shape, lo, hi in (((32,), 0, 256), ((7, 5), 3, 100000), ((), 0, 1)):
        assert np.array_equal(prng.randint(tk, shape, lo, hi),
                              np.asarray(jax.random.randint(jk, shape, lo, hi)))
    for n, k, replace in ((256, 32, False), (24, 32, True), (1000, 1000, False)):
        assert np.array_equal(prng.choice(tk, n, (k,), replace),
                              np.asarray(jax.random.choice(jk, n, (k,), replace=replace)))
    assert np.array_equal(prng.permutation(tk, 77), np.asarray(jax.random.permutation(jk, 77)))
    np.testing.assert_allclose(prng.truncated_normal(tk, (999,)),
                               np.asarray(jax.random.truncated_normal(jk, -2, 2, (999,))),
                               rtol=0, atol=INIT_ULP)


GATES = [
    {"mean_snr": 8.01, "worst_snr": 4.41, "mean_lsd": 7.4, "snrs": []},
    {"mean_snr": 8.2, "worst_snr": 4.3, "mean_lsd": 7.3, "snrs": []},
    {"mean_snr": 7.5, "worst_snr": 4.9, "mean_lsd": 7.9, "snrs": []},
    {"mean_snr": 6.0, "worst_snr": 3.0, "mean_lsd": 8.9, "snrs": []},
    {"mean_snr": 5.0, "worst_snr": 1.9, "mean_lsd": 9.2, "snrs": []},
    {"mean_snr": 11.23, "worst_snr": 8.18, "mean_lsd": 6.0, "snrs": []},
    {"mean_snr": 11.5, "worst_snr": 8.0, "mean_lsd": 6.1, "snrs": []},
]


def test_schedule_and_shipping_rules_match_jax():
    for steps, w, w_end in ((10, 0.25, 0.0), (10, 0.25, 0.1), (7, 0.1, 0.3), (0, 0.2, 0.4),
                            (1, 0.25, 0.05), (25, 0.25, 0.25)):
        a, b = j_train._stft_w_schedule(steps, w, w_end), t_train._stft_w_schedule(steps, w, w_end)
        assert [a(i) for i in range(steps + 3)] == [b(i) for i in range(steps + 3)]
    for m in GATES:
        assert t_train._target_deficit(m) == j_train._target_deficit(m)
        for m2 in GATES:
            assert t_train.should_ship(m, m2) == j_train.should_ship(m, m2)
    assert t_train.TARGETS == j_train.TARGETS and t_train.GATE_KEYS == j_train.GATE_KEYS
    for mt in ("44khz", "24khz", "16khz"):
        j, t = dataclasses.asdict(j_train.distilled_config(mt)), dataclasses.asdict(
            t_train.distilled_config(mt))
        j.pop("dtype"), t.pop("dtype")
        assert j == t


def test_pretrained_files_cross_packages(tmp_path, monkeypatch):
    tree = jax_init(2)
    monkeypatch.setitem(j_train.PRETRAINED, "16khz", tmp_path / "j.npz")
    j_train.save_pretrained(tree, j_train.PRETRAINED["16khz"], cfg=JCFG)
    cfg, got = t_train.load_pretrained("16khz", tmp_path / "j.npz")
    assert dataclasses.replace(cfg, dtype=torch.float32) == TCFG
    t_train.save_pretrained(T.DACModel(TCFG).load_jax(got), tmp_path / "t.npz", cfg=TCFG)
    monkeypatch.setitem(j_train.PRETRAINED, "16khz", tmp_path / "t.npz")
    jcfg, back = j_train.load_pretrained("16khz")
    assert dataclasses.replace(jcfg, dtype=jnp.float32) == JCFG
    ref, a, b = _flatten(tree), _flatten(tree_np(back)), _flatten(got)
    assert set(ref) == set(a) == set(b)
    for k in ref:
        half = ref[k].astype(np.float16).astype(np.float32)
        assert np.array_equal(a[k], half) and np.array_equal(b[k], half), k
    assert t_train.load_pretrained("16khz", tmp_path / "missing.npz") is None
    assert t_train.PRETRAINED["44khz"] == ROOT / "egregora_tpu" / "models" / "dac" / "pretrained_44khz.npz"


def test_cli_writes_under_the_weights_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    monkeypatch.setitem(t_train._RATES, "16khz", 16000)
    small = dataclasses.replace(t_train.distilled_config("16khz"), encoder_dim=4, decoder_dim=16,
                                n_codebooks=2, codebook_size=16, codebook_dim=4,
                                dtype=torch.float32)
    monkeypatch.setattr(t_train, "distilled_config", lambda mt="44khz": small)
    before = package_digest()
    assert t_train.main(["--model-type", "16khz", "--steps", "2", "--batch", "1", "--length",
                         "1024", "--cpu"]) == 0
    out = tmp_path / "dac" / "pretrained_16khz.npz"
    assert [p for p in tmp_path.rglob("*") if p.is_file()] == [out]
    cfg, tree = t_train.load_pretrained("16khz", out)
    assert dataclasses.replace(cfg, dtype=torch.float32) == small
    assert set(_flatten(tree)) == set(_flatten(t_train.params_tree(T.DACModel(small))))
    assert package_digest() == before
    if not torch.cuda.is_available():     # the entry points run on the card or raise
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_train.train(steps=1)
