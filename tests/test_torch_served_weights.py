"""What the port's trainers write is what its loaders and nodes serve.

Each trainer of the port writes under ``$EGREGORA_TPU_WEIGHTS`` (never
into the JAX package); each loader serves that file where it exists, else
the JAX package's shipped file, as the JAX package's trainers and loaders
share one file.  On the CPU, in a temporary ``EGREGORA_TPU_WEIGHTS``:

* FlashSR: seeded trios written by the port's ``save_pretrained`` where
  its trainers write them are what ``resolve_flashsr``, the node and the
  CLI serve, bit for bit (the float16 of the file); the resolver keeps the
  JAX order (converted first); ``distill(resume=True)`` and
  ``distill_vocoder()`` start from the served HiFi-GAN trio: the shipped
  one where there is no trained copy, the trained one where there is;
* RNNoise, DFN2 / DFN3: a seeded tree at the trainer's ``output_path`` is
  what ``load_pretrained`` and the node serve, bit for bit; with none,
  ``load_pretrained`` equals the JAX package's own of the shipped file;
* DAC: ``build_dac`` takes a converted checkpoint, then the trained codec
  ("trained"), then the shipped one; ``guarded_finetune`` and
  ``guarded_retrain`` run end to end at 16 kHz (a float32-sized codec of a
  few channels, one or two steps, batch 1) with the real gate, each
  judged against the codec served when it starts; and three guarded runs
  in a row in both packages, with ``gate_metrics`` scripted alike and each
  trainer standing in as the same scaling of the incumbent it loaded:
  the same decisions, the same files (leaf for leaf), nothing written by a
  run that fails the gate, and each run's incumbent the last ship.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from egregora_tpu.models.dac import model as J
from egregora_tpu.models.dac import train as j_dac_train
from egregora_tpu.models.deepfilternet import train as j_dfn_train
from egregora_tpu.models.flashsr import distill as j_distill
from egregora_tpu.models.rnnoise import train as j_rn_train
from egregora_tpu_torch import cli
from egregora_tpu_torch.models.dac import model as T
from egregora_tpu_torch.models.dac import train as t_dac_train
from egregora_tpu_torch.models.deepfilternet import train as t_dfn_train
from egregora_tpu_torch.models.flashsr import distill as t_distill
from egregora_tpu_torch.models.flashsr import pipeline as t_pipe
from egregora_tpu_torch.models.flashsr import train as t_flashsr_train
from egregora_tpu_torch.models.flashsr.unet import UNetConfig
from egregora_tpu_torch.models.flashsr.vocoder import VocoderConfig
from egregora_tpu_torch.models.rnnoise import train as t_rn_train
from egregora_tpu_torch.nodes import enhance_extras as t_nodes
from egregora_tpu_torch.nodes import super_resolution as t_node
from egregora_tpu_torch.nodes.base import DeviceNode
from egregora_tpu_torch.utils.weights import _flatten, params_from_jax, save_params

# a 16 kHz codec of a few channels (``tests/test_torch_dac_train.py``'s)
DAC_TINY = dict(sample_rate=16000, encoder_dim=4, strides=(2, 2), decoder_dim=16,
                n_codebooks=3, codebook_size=32, codebook_dim=4, res_scale=0.5,
                output_tanh=False, alpha_floor=0.05)


class Stop(Exception):
    """Raised by a stand-in to end a trainer once it has loaded its weights."""


@pytest.fixture()
def weights(tmp_path, monkeypatch):
    """A weights root of its own, every cache of a served weight emptied,
    every node on the CPU."""
    monkeypatch.setenv("EGREGORA_TPU_WEIGHTS", str(tmp_path))
    monkeypatch.delenv("EGREGORA_FLASHSR_VARIANT", raising=False)
    monkeypatch.setattr(t_node.EgregoraAudioSuperResolution, "_PIPE", None)
    monkeypatch.setattr(t_node.EgregoraAudioSuperResolution, "DEVICE", "cpu")
    monkeypatch.setattr(DeviceNode, "DEVICE", "cpu")
    monkeypatch.setattr(t_nodes.Egregora_RNNoise_Denoise, "_PARAMS", None)
    monkeypatch.setattr(t_nodes.Egregora_DeepFilterNet_Denoise, "_PARAMS", {})
    monkeypatch.setattr(t_nodes.Egregora_DAC_Encode, "_MODELS", {})
    monkeypatch.setattr(T, "_CACHE", {})
    return tmp_path


def same_trees(a, b) -> bool:
    fa, fb = _flatten(a), _flatten(b)
    return set(fa) == set(fb) and all(np.array_equal(np.asarray(fa[k]), np.asarray(fb[k]))
                                      for k in fa)


def same_state_dicts(a, b) -> bool:
    return set(a) == set(b) and all(
        set(a[n]) == set(b[n]) and all(torch.equal(a[n][k], b[n][k]) for k in a[n]) for n in a)


def state_dicts(mods) -> dict:
    return {n: {k: v.detach().float().cpu() for k, v in m.state_dict().items()}
            for n, m in mods.by_name().items()}


# ---------------------------------------------------------------- FlashSR

def tiny_trio(kind: str, seed: int) -> t_pipe.FlashSRModules:
    """A seeded trio at the distilled VAE with a narrow UNet and vocoder."""
    base = t_distill.distilled_config()
    voc = (VocoderConfig(upsample_initial=16, channel_floor=8, resblock_kernels=(3,),
                         resblock_dilations=((1,),)) if kind == "hifigan" else
           VocoderConfig(kind="istft", hidden=16, depth=1))
    cfg = dataclasses.replace(base, vocoder=voc, unet=UNetConfig(
        in_channels=32, out_channels=16, base_channels=8, channel_mults=(1,), num_res_blocks=1,
        attn_levels=(), num_heads=2, time_dim=16, groups=4))
    mods = t_pipe.FlashSRModules(cfg)
    mods.init_params(seed)
    return mods


def test_flashsr_serves_the_trained_trios(weights, monkeypatch):
    """Trained copies come before the shipped trios, in the JAX order;
    the node and the CLI serve them bit for bit; a converted cache still
    comes first."""
    trained = {}
    for name, kind, seed in (("pretrained.npz", "hifigan", 1),
                             ("pretrained_istft.npz", "istft", 2)):
        t_distill.save_pretrained(tiny_trio(kind, seed), t_distill.weights_dir() / name)
        trained[name] = t_distill.load_pretrained_with_cfg(t_distill.weights_dir() / name)
    for variant, name, source in (("", "pretrained_istft.npz", "distilled-istft"),
                                  ("hifigan", "pretrained.npz", "distilled")):
        monkeypatch.setenv("EGREGORA_FLASHSR_VARIANT", variant)
        cfg, sd, src = t_distill.resolve_flashsr()
        assert (src, cfg) == (source, trained[name][0]) and same_state_dicts(sd, trained[name][1])
        monkeypatch.setattr(t_node.EgregoraAudioSuperResolution, "_PIPE", None)
        pipe = t_node.EgregoraAudioSuperResolution()._pipeline()
        assert pipe.weight_source == source and same_state_dicts(state_dicts(pipe.modules),
                                                                 trained[name][1])
        seen = []

        def built(cfg, params, device):
            seen.append((cfg, params))
            raise Stop

        with monkeypatch.context() as m:
            m.setattr(t_pipe, "FlashSRPipeline", built)
            m.setattr(cli, "_load", lambda path: None)
            with pytest.raises(Stop):
                cli.main(["--device", "cpu", "flashsr", "--in", "in.wav", "--out", "out.wav"])
        assert seen[0][0] == trained[name][0] and same_state_dicts(seen[0][1], trained[name][1])
    (t_distill.weights_dir() / t_distill.CACHE).touch()
    with pytest.raises(EOFError):                       # the converted cache is read first
        t_distill.resolve_flashsr()


def test_flashsr_trainers_start_from_the_served_trio(weights, monkeypatch):
    """``distill(resume=True)`` and ``distill_vocoder()`` load the served
    HiFi-GAN trio: the shipped one (equal to the JAX package's own load),
    then the trained copy once there is one."""
    loaded = []
    real = t_distill.load_pretrained_with_cfg

    def recording(path):
        loaded.append(path)
        return real(path)

    def stop(*args, **kwargs):
        raise Stop

    monkeypatch.setattr(t_distill, "load_pretrained_with_cfg", recording)
    monkeypatch.setattr(t_flashsr_train, "make_optimizer", stop)
    shipped = t_distill.PRETRAINED
    j_cfg, j_tree = j_distill.load_pretrained_with_cfg(j_distill.PRETRAINED)
    assert same_state_dicts(t_distill.load_pretrained(), params_from_jax(j_cfg, j_tree))
    loaded.clear()
    for run in (lambda: t_distill.distill(resume=True, device="cpu"),
                lambda: t_distill.distill_vocoder(device="cpu", hidden=16, depth=1),
                lambda: t_distill.distill_vocoder(resume=True, device="cpu")):
        with pytest.raises(Stop):
            run()
    # the last resumes the served istft trio
    assert loaded == [shipped, shipped, shipped, t_distill.PRETRAINED_ISTFT]
    t_distill.save_pretrained(tiny_trio("hifigan", 3), t_distill.weights_dir() / shipped.name)
    loaded.clear()
    for run in (lambda: t_distill.distill(resume=True, device="cpu"),
                lambda: t_distill.distill_vocoder(device="cpu", hidden=16, depth=1)):
        with pytest.raises(Stop):
            run()
    assert loaded == [t_distill.weights_dir() / shipped.name] * 2


# ---------------------------------------------------------- RNNoise and DFN

def test_rnnoise_and_dfn_serve_the_trained_weights(weights):
    assert same_trees(t_rn_train.load_pretrained(), j_rn_train.load_pretrained())
    for v in ("DeepFilterNet2", "DeepFilterNet3"):
        assert same_trees(t_dfn_train.load_pretrained(v), j_dfn_train.load_pretrained(v))
    rn = jax.tree_util.tree_map(lambda a: np.asarray(a) * 0.5, j_rn_train.load_pretrained())
    t_rn_train.output_path().parent.mkdir(parents=True)
    save_params(rn, t_rn_train.output_path())
    assert t_rn_train.served_path() == t_rn_train.output_path()
    assert same_trees(t_rn_train.load_pretrained(), rn)
    assert same_trees(t_nodes.Egregora_RNNoise_Denoise._params(), rn)
    for i, v in enumerate(("DeepFilterNet2", "DeepFilterNet3")):
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a) * (0.25 + i),
                                      j_dfn_train.load_pretrained(v))
        out = t_dfn_train.output_path(v)
        out.parent.mkdir(parents=True, exist_ok=True)
        save_params(tree, out)
        assert t_dfn_train.served_path(v) == out
        assert same_trees(t_nodes.Egregora_DeepFilterNet_Denoise._params(v), tree)
    assert t_rn_train.pretrained_path() == t_rn_train.SHIPPED      # the fallback stays


# ---------------------------------------------------------------- DAC

def dac_cfg(dtype=torch.bfloat16) -> T.DACConfig:
    return T.DACConfig(dtype=dtype, **DAC_TINY)


def seeded_codec(seed: int) -> T.DACModel:
    cfg = dac_cfg(torch.float32)
    return T.DACModel(cfg).load_jax(chip_smoke.seeded_dac_tree(cfg, seed))


def half(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float16).astype(np.float32), tree)


def test_build_dac_serves_the_trained_codec(weights, monkeypatch):
    model, _ = T.build_dac("16khz")
    assert model.weight_source == "shipped"
    cfg, tree = j_dac_train.load_pretrained("16khz")
    assert same_trees(t_dac_train.params_tree(model), tree)
    T._CACHE.clear()
    codec = seeded_codec(4)
    path = t_dac_train.output_path("16khz")
    t_dac_train.save_pretrained(codec, path, cfg=codec.cfg)
    model, sr = T.build_dac("16khz")
    ref = half(t_dac_train.params_tree(codec))
    assert (model.weight_source, sr) == ("trained", 16000)
    assert same_trees(t_dac_train.params_tree(model), ref)
    assert t_nodes.Egregora_DAC_Encode._model("16khz")[0] is model
    assert same_trees(t_dac_train.params_tree(t_dac_train.shipped_model("16khz", "cpu")), ref)
    assert same_trees(t_dac_train.load_pretrained("16khz")[1], ref)
    T._CACHE.clear()
    monkeypatch.setitem(T.MODEL_TYPES, "16khz", dac_cfg())      # the converted geometry
    save_params(t_dac_train.params_tree(seeded_codec(5)), weights / "dac_16khz.npz")
    assert T.build_dac("16khz")[0].weight_source == "converted"


def gate_recorder(monkeypatch, module, seen: list, port: bool):
    """``module.gate_metrics`` also recording the parameters it was given."""
    real = module.gate_metrics

    def recording(model, *params):
        seen.append(t_dac_train.params_tree(model) if port else params[0])
        out = real(model, *params)
        seen.append(out)
        return out

    monkeypatch.setattr(module, "gate_metrics", recording)


def test_guarded_runs_end_to_end(weights, monkeypatch):
    """``guarded_finetune`` then ``guarded_retrain`` on the CPU with the
    real gate: each judged against the codec served when it starts, each
    written exactly where ``should_ship`` says so, and what it wrote
    served next."""
    small = dataclasses.replace(t_dac_train.distilled_config("16khz"), **{
        k: v for k, v in DAC_TINY.items() if k != "sample_rate"})
    monkeypatch.setattr(t_dac_train, "distilled_config", lambda mt="44khz": small)
    path = t_dac_train.output_path("16khz")
    incumbent = seeded_codec(6)
    t_dac_train.save_pretrained(incumbent, path, cfg=incumbent.cfg)
    seen = []
    gate_recorder(monkeypatch, t_dac_train, seen, port=True)
    kw = dict(batch=1, length=512, seed=3, scan_size=1, device="cpu")
    for run in (lambda: t_dac_train.guarded_finetune("16khz", steps=1, lr=5e-5, **kw),
                lambda: t_dac_train.guarded_retrain("16khz", steps=2, lr=3e-4, ae_frac=0.5,
                                                    **kw)):
        served = t_dac_train.load_pretrained("16khz")[1]
        mtime = path.stat().st_mtime_ns
        seen.clear()
        shipped = run()
        before_params, before, after_params, after = seen
        assert same_trees(before_params, served)              # judged against the served codec
        assert shipped == t_dac_train.should_ship(before, after)
        assert (path.stat().st_mtime_ns != mtime) == shipped
        written = t_dac_train.load_pretrained("16khz")[1]
        assert same_trees(written, half(after_params) if shipped else served)
        T._CACHE.clear()
        assert same_trees(t_dac_train.params_tree(T.build_dac("16khz")[0]), written)
    assert not path.with_suffix(".ckpt.npz").exists()          # no checkpoint at 3000 steps


SCRIPT = [  # (before, after) of three guarded runs: fails, ships, fails
    ({"mean_snr": 6.0, "worst_snr": 3.0, "mean_lsd": 8.0},
     {"mean_snr": 5.5, "worst_snr": 2.5, "mean_lsd": 8.1}),
    ({"mean_snr": 6.0, "worst_snr": 3.0, "mean_lsd": 8.0},
     {"mean_snr": 7.0, "worst_snr": 3.5, "mean_lsd": 7.8}),
    ({"mean_snr": 7.0, "worst_snr": 3.5, "mean_lsd": 7.8},
     {"mean_snr": 6.9, "worst_snr": 3.5, "mean_lsd": 7.8}),
]


def test_guarded_runs_in_a_row_match_jax(tmp_path, weights, monkeypatch):
    """Three guarded fine-tunes in a row in each package from one file,
    the gate scripted alike, each trainer the same scaling of what it
    loaded: the same decisions and files, and each incumbent the last
    ship."""
    gates = [g for pair in SCRIPT for g in pair]
    t_gates, j_gates, t_seen, j_seen = list(gates), list(gates), [], []

    def t_gate(model):
        t_seen.append(t_dac_train.params_tree(model))
        return dict(t_gates.pop(0), snrs=[])

    def j_gate(model, params):
        j_seen.append(jax.tree_util.tree_map(np.asarray, params))
        return dict(j_gates.pop(0), snrs=[])

    def t_finetune(model_type, device="cuda", out=None, **kw):
        model = t_dac_train.shipped_model(model_type, device, out)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1.125)
        return model, t_dac_train.params_tree(model)

    def j_finetune(model_type, **kw):
        cfg, params = j_dac_train.load_pretrained(model_type)
        return J.DACModel(cfg), jax.tree_util.tree_map(lambda a: np.asarray(a) * 1.125, params)

    monkeypatch.setattr(t_dac_train, "gate_metrics", t_gate)
    monkeypatch.setattr(j_dac_train, "gate_metrics", j_gate)
    monkeypatch.setattr(t_dac_train, "finetune", t_finetune)
    monkeypatch.setattr(j_dac_train, "finetune", j_finetune)
    start = seeded_codec(7)
    for pkg in (j_dac_train, t_dac_train):          # the same shipped file, in a copy each
        path = tmp_path / pkg.__name__.split(".")[0] / "pretrained_16khz.npz"
        path.parent.mkdir()
        monkeypatch.setitem(pkg.PRETRAINED, "16khz", path)
        t_dac_train.save_pretrained(start, path, cfg=start.cfg)
    t_path = t_dac_train.output_path("16khz")
    kw = dict(steps=1, batch=1, length=512, lr=5e-5, seed=3, scan_size=1)
    decisions, files = [], []
    for _ in SCRIPT:
        shipped = (j_dac_train.guarded_finetune("16khz", **kw),
                   t_dac_train.guarded_finetune("16khz", device="cpu", **kw))
        decisions.append(shipped)
        files.append((j_dac_train.load_pretrained("16khz")[1],
                      t_dac_train.load_pretrained("16khz")[1] if t_path.exists() else None))
    assert decisions == [(False, False), (True, True), (False, False)]
    assert files[0][1] is None                                  # a failed run writes nothing
    assert same_trees(files[1][0], files[1][1]) and same_trees(files[2][1], files[1][1])
    assert same_trees(files[2][0], files[1][0])
    shipped_file = half(t_dac_train.params_tree(start))
    scaled = half(jax.tree_util.tree_map(lambda a: a * np.float32(1.125), shipped_file))
    assert same_trees(files[1][1], scaled)
    for seen in (t_seen, j_seen):                  # before, after of each run
        assert same_trees(seen[0], shipped_file) and same_trees(seen[2], shipped_file)
        assert same_trees(seen[4], files[1][1])               # the third run's incumbent
    assert not t_gates and not j_gates
