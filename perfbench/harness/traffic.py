"""One general generator of the benchmark's traffic, driven by the mix's
parameter file (``perfbench/traffic/<name>.json``).

A mix is a pool of ``pool`` input files that the measured window walks
through in order, again from the start where it runs out (a closed loop
of ``clients`` = 1).  The set of sizes is the same for every seed: file
``i`` of the sorted pool has its length at the quantile ``(i + 0.5) /
pool`` of the mix's length distribution, its source rate the
``i % len(rates)``-th rate, and its low-pass edge (where the mix has one)
at a scrambled quantile of its range.  The seed orders the pool and draws
every signal.  Signals are made on the device from a ``torch.Generator``
and handed over as 16-bit-exact float32 host arrays, as a decoded WAV
would be.

Signal kinds:

* ``speech``: a harmonic source (``1/h`` harmonics below the source's
  Nyquist) on a gliding pitch contour under slowly moving formant bumps,
  with breath noise, syllable-rate amplitude and pauses between phrases;
* ``music``: bass, chord and lead voices of harmonic notes on a tempo
  grid with decaying envelopes, and noise-burst percussion, panned to
  stereo, then low-pass filtered at the file's edge (the band a lossy
  encode keeps).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

PCM = 32767.0


@dataclasses.dataclass
class Item:
    """One input file of the pool."""
    index: int              # position in the sorted pool (its size class)
    sr: int
    samples: np.ndarray     # [C, N] float32, 16-bit exact
    lowpass_hz: float = 0.0

    @property
    def seconds(self) -> float:
        return self.samples.shape[-1] / float(self.sr)

    def audio(self) -> Dict:
        """The ComfyUI AUDIO dict a graph hands the node."""
        return {"waveform": torch.from_numpy(self.samples)[None], "sample_rate": self.sr}


def sizes(spec: Dict) -> List[Dict]:
    """The pool's sizes, sorted by length: ``{"index", "seconds", "sr",
    "lowpass_hz"}`` each; the same for every seed."""
    n = int(spec["pool"])
    lo, hi = float(spec["length_s"]["min"]), float(spec["length_s"]["max"])
    rates = list(spec["rates"])
    out = []
    for i in range(n):
        q = (i + 0.5) / n
        sec = lo * (hi / lo) ** q if spec["length_s"]["dist"] == "loguniform" else lo + (hi - lo) * q
        lp = 0.0
        if "lowpass_hz" in spec:
            a, b = spec["lowpass_hz"]["min"], spec["lowpass_hz"]["max"]
            lp = a + (b - a) * (((i * 7) % n) + 0.5) / n
        out.append({"index": i, "seconds": sec, "sr": int(rates[i % len(rates)]),
                    "lowpass_hz": lp})
    return out


def order(spec: Dict, seed: int) -> List[int]:
    """The window's order of the pool for ``seed``."""
    return [int(i) for i in np.random.default_rng([int(seed), 1]).permutation(int(spec["pool"]))]


def _gen(seed: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * index + 17) % (2 ** 63))
    return g


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)


def _smooth(g, n_ctrl: int, n: int, device) -> torch.Tensor:
    """A smooth random curve of ``n`` samples through ``n_ctrl`` control
    points of N(0, 1)."""
    ctrl = torch.randn(1, 1, n_ctrl, generator=g, device=device)
    return torch.nn.functional.interpolate(ctrl, size=n, mode="linear",
                                           align_corners=True)[0, 0]


def _harmonics(phase: torch.Tensor, f_max: torch.Tensor, sr: int, n_h: int,
               tilt: float) -> torch.Tensor:
    """``sum_h h**-tilt * sin(h * phase)`` over the harmonics below Nyquist."""
    out = torch.zeros_like(phase, dtype=torch.float32)
    for h in range(1, n_h + 1):
        alive = (h * f_max < 0.48 * sr).float()
        out += alive * h ** -tilt * torch.sin(h * phase).float()
    return out


def _phase(freq: torch.Tensor, sr: int) -> torch.Tensor:
    return torch.remainder(torch.cumsum(freq.double() * (2 * math.pi / sr), 0), 2 * math.pi)


def speech(g: torch.Generator, n: int, sr: int, device) -> torch.Tensor:
    """``[1, n]`` speech-like signal at ``sr``."""
    f0 = float(_uniform(g, 1, 90.0, 240.0, device))
    contour = f0 * torch.exp(0.15 * _smooth(g, max(2, n // (sr // 3)), n, device))
    src = _harmonics(_phase(contour, sr), contour, sr, 60, 1.0)
    src = src + 0.05 * torch.randn(n, generator=g, device=device)
    n_fft, hop = 1024, 256
    win = torch.hann_window(n_fft, device=device)
    spec = torch.stft(src, n_fft, hop, window=win, return_complex=True)
    bins, frames = spec.shape
    freqs = torch.linspace(0, sr / 2, bins, device=device)[:, None]
    env = torch.zeros(bins, frames, device=device)
    for centre, width in ((600.0, 150.0), (1500.0, 250.0), (2600.0, 350.0), (3600.0, 500.0)):
        move = centre * (1 + 0.25 * torch.tanh(_smooth(g, max(2, frames // 20), frames, device)))
        env += torch.exp(-0.5 * ((freqs - move[None]) / width) ** 2)
    spec = spec * (0.05 + env)
    y = torch.istft(spec, n_fft, hop, window=win, length=n)
    # syllables at ~5 Hz, phrases of 1.5-3 s with 0.2-0.6 s pauses
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    syl = 0.55 + 0.45 * torch.sin(2 * math.pi * 5.0 * t + 2 * _smooth(g, 8, n, device).double())
    gate = torch.ones(n, device=device, dtype=torch.float64)
    at = 0.0
    dur = n / sr
    while at < dur:
        at += float(_uniform(g, 1, 1.5, 3.0, device))
        gap = float(_uniform(g, 1, 0.2, 0.6, device))
        a, b = int(at * sr), min(n, int((at + gap) * sr))
        if a < n:
            ramp = torch.linspace(1.0, 0.0, min(480, b - a), device=device, dtype=torch.float64)
            gate[a: a + ramp.numel()] = ramp
            gate[a + ramp.numel(): b] = 0.0
            if b < n:
                up = torch.linspace(0.0, 1.0, min(480, n - b), device=device, dtype=torch.float64)
                gate[b: b + up.numel()] = up
        at += gap
    return (y.double() * syl * gate).float()[None]


def music(g: torch.Generator, n: int, sr: int, lowpass_hz: float, device) -> torch.Tensor:
    """``[2, n]`` music-like stereo at ``sr``, low-passed at ``lowpass_hz``."""
    bpm = float(_uniform(g, 1, 80.0, 150.0, device))
    beat = int(sr * 60.0 / bpm)
    n_beats = n // beat + 2
    t_in = torch.arange(n, device=device) % beat
    which = torch.arange(n, device=device) // beat
    root = 55.0 * 2 ** (float(torch.randint(0, 12, (1,), generator=g, device=device)) / 12)
    scale = torch.tensor([0, 2, 4, 5, 7, 9, 11], device=device, dtype=torch.float64)
    out = torch.zeros(2, n, device=device)
    for octave, span, tilt, decay, pan, level in ((0, 1, 1.2, 3.0, 0.5, 0.5),
                                                  (2, 2, 1.6, 1.5, 0.3, 0.25),
                                                  (2, 4, 1.4, 0.8, 0.7, 0.25),
                                                  (3, 1, 1.3, 6.0, 0.6, 0.2)):
        steps = torch.randint(0, 7, (n_beats * span,), generator=g, device=device)
        notes = root * 2 ** (octave + scale[steps] / 12)
        idx = torch.clamp(torch.arange(n, device=device) * span // beat, max=notes.numel() - 1)
        freq = notes[idx]
        env = torch.exp(-decay * ((t_in % (beat // span)).double() / sr)).float()
        tone = level * env * _harmonics(_phase(freq, sr), freq, sr, 24, tilt)
        out[0] += (1 - pan) * tone
        out[1] += pan * tone
    hits = (torch.rand(n_beats, generator=g, device=device) < 0.7).float()[which]
    drum = 0.3 * hits * torch.exp(-25.0 * t_in.double() / sr).float()
    out += drum * torch.randn(2, n, generator=g, device=device)
    spec = torch.fft.rfft(out, dim=-1)
    f = torch.fft.rfftfreq(n, 1.0 / sr).to(device)
    taper = torch.clamp((lowpass_hz - f) / 200.0, 0.0, 1.0)
    return torch.fft.irfft(spec * taper, n=n, dim=-1)


def make_pool(spec: Dict, seed: int, device) -> List[Item]:
    """The pool in the window's order for ``seed``."""
    by_index = {s["index"]: s for s in sizes(spec)}
    items = []
    for i in order(spec, seed):
        s = by_index[i]
        g = _gen(seed, i, device)
        n = int(round(s["seconds"] * s["sr"]))
        if spec["signal"] == "speech":
            x = speech(g, n, s["sr"], device)
        elif spec["signal"] == "music":
            x = music(g, n, s["sr"], s["lowpass_hz"], device)
        else:
            raise ValueError(f"unknown signal kind {spec['signal']!r}")
        peak = float(_uniform(g, 1, *spec["peak"], device))
        x = x * (peak / torch.clamp(x.abs().max(), min=1e-9))
        q = torch.round(torch.clamp(x, -1.0, 1.0) * PCM) / PCM
        items.append(Item(i, s["sr"], np.ascontiguousarray(q.float().cpu().numpy()),
                          s["lowpass_hz"]))
    return items
