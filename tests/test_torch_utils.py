"""The port's utils and the ``AudioBuffer`` gaps.

* ``utils.device``: the platforms seen and ``ensure_accelerator``'s
  message where there is no card;
* ``utils.profiling``: ``NodeTimer`` and ``trace`` writing one Chrome
  trace on the CPU;
* ``utils.fetch`` against a local ``http.server`` with Range support
  (resume, sha256 mismatch, at most one first-use attempt a directory,
  ``EGREGORA_TPU_OFFLINE``), and its wiring into
  ``distill.load_converted_flashsr``; no other host is contacted;
* ``utils.wavio.write_audio``: the bytes of the JAX package's for WAV
  PCM16 and float32 and for FLAC through the native codec, and for the
  stdlib ``wave`` fallback;
* ``AudioBuffer.duration_s``, ``mono`` and ``with_samples``.
"""
import dataclasses
import hashlib
import io
import json
import threading
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from egregora_tpu.core.audio import AudioBuffer as JaxBuffer
from egregora_tpu.utils import native as j_native
from egregora_tpu.utils import wavio as j_wavio
from egregora_tpu_torch.core.audio import AudioBuffer, pcm16_encode
from egregora_tpu_torch.utils import device, fetch, native, profiling, wavio


def test_platforms_and_cpu_device():
    assert device.available_platforms()[0] == "cpu"
    assert ("cuda" in device.available_platforms()) == torch.cuda.is_available()
    assert device.ensure_accelerator("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.ensure_accelerator("tpu")


def test_ensure_accelerator_message_without_a_card():
    if torch.cuda.is_available():
        assert device.ensure_accelerator() == torch.device("cuda:0")
        return
    with pytest.raises(RuntimeError) as e:
        device.ensure_accelerator("cuda")
    msg = str(e.value)
    assert "No CUDA device detected (available platforms: cpu" in msg
    assert "--device cpu" in msg and 'DEVICE = "cpu"' in msg


def test_node_timer():
    t = profiling.NodeTimer()
    for _ in range(3):
        with t.measure("a"):
            pass
    with pytest.raises(KeyError):
        with t.measure("b"):
            raise KeyError("x")
    s = t.summary()
    assert s["a"]["calls"] == 3.0 and s["b"]["calls"] == 1.0
    assert s["a"]["max_s"] >= s["a"]["mean_s"] >= 0.0
    t.reset()
    assert t.summary() == {}
    assert isinstance(profiling.GLOBAL_TIMER, profiling.NodeTimer)


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "tr")):
        torch.matmul(x, x)
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {ev.get("name") for ev in json.loads(files[0].read_text())["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names


# ---- fetch: a local server only ----

class _RangeHandler(SimpleHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def send_head(self):
        rng = self.headers.get("Range")
        if not rng or not rng.startswith("bytes="):
            return super().send_head()
        path = Path(self.translate_path(self.path))
        if not path.is_file():
            self.send_error(404)
            return None
        data = path.read_bytes()
        start = int(rng.split("=")[1].split("-")[0])
        self.send_response(206)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Range", f"bytes {start}-{len(data) - 1}/{len(data)}")
        self.send_header("Content-Length", str(len(data) - start))
        self.end_headers()
        return io.BytesIO(data[start:])


@pytest.fixture()
def http_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("srv")
    srv = HTTPServer(("127.0.0.1", 0), partial(_RangeHandler, directory=str(root)))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield root, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()


def _put(root: Path, name: str, size: int = 40000, seed: int = 0) -> bytes:
    data = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()
    (root / name).write_bytes(data)
    return data


def test_download_resumes_and_checks(http_root, tmp_path):
    root, base = http_root
    data = _put(root, "big.bin", size=100_000)
    dest = tmp_path / "big.bin"
    (tmp_path / "big.bin.part").write_bytes(data[:37_000])         # interrupted
    sha = hashlib.sha256(data).hexdigest()
    assert fetch.download(f"{base}/big.bin", dest, sha256=sha).read_bytes() == data
    assert not (tmp_path / "big.bin.part").exists()
    (root / "big.bin").write_bytes(b"changed on the server")
    assert fetch.download(f"{base}/big.bin", dest, sha256=sha).read_bytes() == data
    _put(root, "bad.bin")
    with pytest.raises(fetch.ChecksumError):
        fetch.download(f"{base}/bad.bin", tmp_path / "bad.bin", sha256="0" * 64)
    assert not (tmp_path / "bad.bin").exists() and not (tmp_path / "bad.bin.part").exists()


def test_fetch_trio_marker_and_one_attempt(http_root, tmp_path, monkeypatch):
    root, base = http_root
    monkeypatch.setenv("EGREGORA_FLASHSR_HF_REPO", base)
    assert fetch.flashsr_weight_urls()["vae.pth"] == f"{base}/vae.pth"
    for i, f in enumerate(fetch.FLASHSR_FILES[:2]):
        _put(root, f, seed=i)
    assert fetch.fetch_flashsr_weights(tmp_path / "m", timeout=5) == ("vae.pth",)
    _put(root, "vae.pth", seed=9)
    assert fetch.fetch_flashsr_weights(tmp_path / "m", timeout=5) == ()
    assert (tmp_path / "m" / fetch.MARKER).exists()

    monkeypatch.setattr(fetch, "_AUTO_TRIED", set())
    calls = []
    real = fetch.fetch_flashsr_weights
    monkeypatch.setattr(fetch, "fetch_flashsr_weights",
                        lambda *a, **k: calls.append(k) or real(*a, **k))
    assert fetch.auto_fetch_flashsr(tmp_path / "off") is False      # the suite is offline
    assert calls == []
    monkeypatch.delenv("EGREGORA_TPU_OFFLINE")
    assert fetch.auto_fetch_flashsr(tmp_path / "a") is True
    assert calls == [{"timeout": 5.0}]
    assert fetch.fetched_files(tmp_path / "a") == set(fetch.FLASHSR_FILES)
    for f in fetch.FLASHSR_FILES:
        (root / f).unlink()
    assert fetch.auto_fetch_flashsr(tmp_path / "b") is False
    assert fetch.auto_fetch_flashsr(tmp_path / "b") is False        # no second attempt
    assert len(calls) == 2


def test_resolver_makes_the_first_use_fetch(http_root, tmp_path, monkeypatch):
    """``load_converted_flashsr`` on a directory without the trio fetches
    it from the mirror once (then converts it, as the JAX resolver does);
    a second empty directory with the mirror gone gets one attempt and
    falls through."""
    from egregora_tpu.models.flashsr import distill as j_distill
    from egregora_tpu_torch.models.flashsr import distill
    import test_checkpoint_e2e as e2e

    root, base = http_root
    monkeypatch.setenv("EGREGORA_FLASHSR_NUM_HEADS", "2")
    cfg = distill._cfg_from_json(j_distill._cfg_to_json(e2e._reduced_cfg()))
    cfg = dataclasses.replace(cfg, vocoder=dataclasses.replace(cfg.vocoder, upsample_initial=32))
    chip_smoke.write_reference_trio(cfg, root, seed=5)
    monkeypatch.setenv("EGREGORA_FLASHSR_HF_REPO", base)
    monkeypatch.delenv("EGREGORA_TPU_OFFLINE")
    monkeypatch.setattr(fetch, "_AUTO_TRIED", set())
    got_cfg, sd = distill.load_converted_flashsr(tmp_path / "w")
    assert set(sd) == {"vae", "student_ldm", "sr_vocoder"}          # inferred geometry:
    assert got_cfg.vocoder == cfg.vocoder and got_cfg.vae.base_channels == 8   # (groups are not)
    assert all((tmp_path / "w" / f).exists() for f in fetch.FLASHSR_FILES)
    assert (tmp_path / "w" / distill.CACHE).exists()
    for f in fetch.FLASHSR_FILES:
        (root / f).unlink()
    assert distill.load_converted_flashsr(tmp_path / "v") is None
    assert str(tmp_path / "v") in fetch._AUTO_TRIED


def test_first_use_fetch_refuses_plain_http_off_loopback(tmp_path, monkeypatch):
    """A plain-http mirror on another host is refused before any request."""
    def no_network(*args, **kwargs):
        raise AssertionError("the first-use fetch tried to download")

    monkeypatch.setattr(fetch, "fetch_flashsr_weights", no_network)
    monkeypatch.setattr(fetch, "_AUTO_TRIED", set())
    monkeypatch.delenv("EGREGORA_TPU_OFFLINE")
    monkeypatch.setenv("EGREGORA_FLASHSR_HF_REPO", "http://mirror.invalid/flashsr")
    assert fetch.auto_fetch_flashsr(tmp_path / "m") is False


_PLANTED = []


def _plant(tag):
    _PLANTED.append(tag)
    return tag


class _Planted:
    def __reduce__(self):
        return (_plant, ("ran",))


def test_resolver_reads_fetched_files_as_tensors_only(http_root, tmp_path, monkeypatch):
    """A downloaded ``.pth`` that holds more than tensors is refused with
    an error, and the code it carries never runs."""
    from egregora_tpu_torch.models.flashsr import distill

    root, base = http_root
    for f in fetch.FLASHSR_FILES:
        torch.save({"w": torch.zeros(2), "planted": _Planted()}, root / f)
    monkeypatch.setenv("EGREGORA_FLASHSR_HF_REPO", base)
    monkeypatch.delenv("EGREGORA_TPU_OFFLINE")
    monkeypatch.setattr(fetch, "_AUTO_TRIED", set())
    with pytest.raises(RuntimeError, match="downloaded and holds more than tensors"):
        distill.load_converted_flashsr(tmp_path / "w")
    assert _PLANTED == []


# ---- write_audio: the JAX package's bytes ----

def _tone(c=2, n=4001, seed=0):
    rng = np.random.default_rng(seed)
    x = 0.6 * np.sin(np.arange(n) / 7.0)[None] * np.linspace(1, 0.3, c)[:, None]
    x = x + 0.05 * rng.standard_normal((c, n))
    x[0, :3] = (1.2, -1.3, 0.99999)                      # clipped and near full scale
    return x.astype(np.float32)


@pytest.mark.parametrize("name,subtype", [("a.wav", "PCM_16"), ("a.wav", "FLOAT"),
                                          ("a.flac", "PCM_16")])
def test_write_audio_bytes_equal_jax_native(tmp_path, name, subtype):
    if native.load() is None or j_native.load() is None:
        pytest.skip("no C++ toolchain for the native codec")
    x = _tone()
    wavio.write_audio(tmp_path / f"t_{name}", x, 44100, subtype)
    j_wavio.write_audio(tmp_path / f"j_{name}", x, 44100, subtype)
    assert (tmp_path / f"t_{name}").read_bytes() == (tmp_path / f"j_{name}").read_bytes()
    y, sr = wavio.read_audio(tmp_path / f"t_{name}")
    assert sr == 44100 and y.shape == x.shape
    if subtype == "FLOAT":
        np.testing.assert_array_equal(y, x)
    else:
        assert np.abs(y - np.clip(x, -1, 1 - 1 / 32768)).max() <= 0.5 / 32768 + 1e-9


def test_write_audio_bytes_equal_jax_stdlib(tmp_path, monkeypatch):
    """Without the native codec (and without soundfile) both packages write
    16-bit WAV through ``wave``, truncating ``x * 32767``."""
    def broken(*a, **k):
        raise RuntimeError("no native codec")

    monkeypatch.setattr(native, "write_wav", broken)
    monkeypatch.setattr(j_native, "write_wav", broken)
    monkeypatch.setattr(wavio, "_have_soundfile", lambda: False)
    monkeypatch.setattr(j_wavio, "_have_soundfile", lambda: False)
    x = _tone(c=1, n=999, seed=3)
    wavio.write_audio(tmp_path / "t.wav", x, 16000)
    j_wavio.write_audio(tmp_path / "j.wav", x, 16000)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    with pytest.raises(RuntimeError, match="WAV only"):
        wavio.write_audio(tmp_path / "t.ogg", x, 16000)


# ---- AudioBuffer ----

def test_audiobuffer_duration_mono_with_samples():
    x = _tone(c=2, n=48000)
    buf = AudioBuffer(torch.from_numpy(x), 16000, {"k": 1})
    jbuf = JaxBuffer(x, 16000, {"k": 1})
    assert buf.duration_s == jbuf.duration_s == 3.0
    m = buf.mono()
    assert isinstance(m, torch.Tensor) and m.shape == (48000,)
    np.testing.assert_allclose(m.numpy(), np.asarray(jbuf.mono()), atol=1e-7)
    mn = AudioBuffer(x, 16000).mono()
    assert isinstance(mn, np.ndarray) and mn.dtype == np.float32
    np.testing.assert_allclose(mn, m.numpy(), atol=1e-7)
    wire = AudioBuffer(torch.from_numpy(pcm16_encode(x)), 48000, {"wire_scale": 2.0})
    assert wire.duration_s == 1.0
    np.testing.assert_allclose(wire.mono().numpy(), 2.0 * np.clip(x, -1, 1).mean(0),
                               atol=2.0 / 32767)
    other = buf.with_samples(x[:1], sample_rate=8000)
    assert other.sample_rate == 8000 and other.meta == {"k": 1} and other.meta is not buf.meta
    assert buf.with_samples(x, meta={"z": 2}).meta == {"z": 2}
    assert buf.with_samples(x).sample_rate == 16000
