"""Host-side figures for the analysis nodes (numpy + matplotlib).

The port's own copy of ``egregora_tpu/utils/viz.py``; the designs:

* ``alignment_figure`` — the GCC-PHAT correlation surface against lag
  in milliseconds with the detected peak annotated;
* ``waveform_figure`` — all signals in one axis as envelope bands
  (per-block min/max) on a seconds axis;
* ``spectrogram_figure`` — panels with physical axes (s, kHz) on a
  shared dB scale with a colorbar;
* ``difference_figure`` — the signed spectral difference (dB) on a
  diverging scale.

Everything takes numpy arrays (the device work stays in the callers) and
returns a matplotlib Figure; matplotlib is imported when a figure is
drawn.  Callers rasterize with ``nodes.base.image_from_figure``.
"""
from __future__ import annotations

import numpy as np

_DB_FLOOR = -120.0


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _env_minmax(y: np.ndarray, blocks: int = 2000):
    """Per-block (min, max) envelope for dense waveform rendering."""
    n = y.shape[0]
    bs = max(1, n // blocks)
    nb = n // bs
    yb = y[: nb * bs].reshape(nb, bs)
    return yb.min(axis=1), yb.max(axis=1), bs


def alignment_figure(corr_curve: np.ndarray, lags_ms: np.ndarray,
                     delay_ms: float, peak_corr: float):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(7.0, 2.8), dpi=100)
    ax.fill_between(lags_ms, 0.0, corr_curve, color="#4878a8", alpha=0.55,
                    linewidth=0)
    ax.axvline(delay_ms, color="#b03030", linestyle="--", linewidth=1.0)
    ax.annotate(f"{delay_ms:+.2f} ms\nr={peak_corr:.3f}",
                xy=(delay_ms, float(np.max(corr_curve))),
                xytext=(6, -2), textcoords="offset points", fontsize=8)
    ax.set_xlabel("lag (ms)")
    ax.set_ylabel("GCC-PHAT")
    ax.margins(x=0)
    fig.tight_layout(pad=0.4)
    return fig


def waveform_figure(signals: dict, sr: int):
    """``{label: mono np.ndarray}`` rendered as stacked envelope bands
    in one axis (offset vertically), seconds on x."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9.0, 1.2 + 1.1 * len(signals)), dpi=100)
    palette = ["#35618f", "#8f6a35", "#8f3548", "#4a8f35"]
    yticks, ylabels = [], []
    for row, (label, y) in enumerate(signals.items()):
        lo, hi, bs = _env_minmax(np.asarray(y, np.float32))
        t = np.arange(lo.shape[0]) * bs / sr
        base = -2.4 * row
        scale = 1.0 / max(1e-9, max(abs(lo.min()), abs(hi.max())))
        ax.fill_between(t, base + lo * scale, base + hi * scale,
                        color=palette[row % len(palette)], linewidth=0,
                        alpha=0.85)
        yticks.append(base)
        ylabels.append(f"{label}\n(×{scale:.3g})")
    ax.set_yticks(yticks)
    ax.set_yticklabels(ylabels, fontsize=8)
    ax.set_xlabel("time (s)")
    ax.margins(x=0)
    for s in ("top", "right", "left"):
        ax.spines[s].set_visible(False)
    fig.tight_layout(pad=0.4)
    return fig


def spectrogram_figure(specs_db: dict, sr: int, hop: int):
    """``{label: [freqs, frames] dB array}`` panels, shared color scale,
    axes in seconds / kHz, one colorbar."""
    plt = _plt()
    n = len(specs_db)
    fig, axes = plt.subplots(n, 1, figsize=(9.0, 2.4 * n), dpi=100,
                             squeeze=False)
    vmax = max(float(np.max(s)) for s in specs_db.values())
    vmin = max(_DB_FLOOR, vmax - 100.0)
    im = None
    for ax, (label, s) in zip(axes[:, 0], specs_db.items()):
        extent = [0, s.shape[1] * hop / sr, 0, sr / 2000.0]
        im = ax.imshow(s, origin="lower", aspect="auto", extent=extent,
                       vmin=vmin, vmax=vmax, cmap="magma")
        ax.set_ylabel(f"{label}\nkHz", fontsize=8)
    axes[-1, 0].set_xlabel("time (s)")
    fig.colorbar(im, ax=axes[:, 0], label="dB", fraction=0.03)
    return fig


def difference_figure(spec_a_db: np.ndarray, spec_b_db: np.ndarray,
                      sr: int, hop: int):
    """Signed spectral delta B−A in dB on a diverging scale."""
    plt = _plt()
    d = np.clip(spec_b_db - spec_a_db, -60.0, 60.0)
    lim = float(np.percentile(np.abs(d), 99.0)) or 1.0
    fig, ax = plt.subplots(figsize=(9.0, 2.8), dpi=100)
    extent = [0, d.shape[1] * hop / sr, 0, sr / 2000.0]
    im = ax.imshow(d, origin="lower", aspect="auto", extent=extent,
                   vmin=-lim, vmax=lim, cmap="coolwarm")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("kHz")
    fig.colorbar(im, ax=ax, label="Δ dB (B−A)", fraction=0.03)
    fig.tight_layout(pad=0.4)
    return fig
