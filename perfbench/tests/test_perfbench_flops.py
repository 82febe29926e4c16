"""The arithmetic of ``attn_roofline`` and ``step_mfu_pct`` against
counts made by hand."""
import json

import pytest

from perfbench.harness import flops

H100 = flops.peaks("NVIDIA H100 80GB HBM3")


def test_peaks_table():
    assert H100["flops_per_s"]["bf16"] == 989e12
    assert H100["bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        flops.peaks("cpu")


def test_attention_bound_by_hand():
    # the published VAE's mid attention on one chunk: one head, N = 8192, D = 512, bf16:
    # 4 * 8192^2 * 512 = 137.4 GFLOP over 989 TFLOP/s = 138.9 us; 4 * 8192 * 512 * 2 bytes
    # = 33.6 MB over 3.35 TB/s = 10.0 us: compute bound
    assert flops.attention_bound_s(1, 1, 8192, 512, 2, H100) == pytest.approx(
        4 * 8192 ** 2 * 512 / 989e12)
    # a short sequence is bandwidth bound: N = 4, D = 64, 8 heads x 2, float32 at 67 TFLOP/s
    b, h, n, d = 2, 8, 4, 64
    assert flops.attention_bound_s(b, h, n, d, 4, H100) == pytest.approx(
        4 * b * h * n * d * 4 / 3.35e12)
    calls = [(1, 1, 8192, 512, 2), (2, 8, 4, 64, 4)]
    assert flops.attention_bound_total_s(calls, H100) == pytest.approx(
        sum(flops.attention_bound_s(*c, H100) for c in calls))


def conv(cin, cout, k, n):
    return 2 * cin * cout * k * n


def vae_by_hand(b, mults, r, z, hw):
    f, ch, res = conv(1, b, 9, hw), b, hw
    for i, m in enumerate(mults):                           # encoder
        for _ in range(r):
            f += conv(ch, b * m, 9, res) + conv(b * m, b * m, 9, res)
            f += conv(ch, b * m, 1, res) if ch != b * m else 0
            ch = b * m
        if i < len(mults) - 1:
            res //= 4
            f += conv(ch, ch, 9, res)
    mid = 2 * (2 * conv(ch, ch, 9, res)) + 4 * conv(ch, ch, 1, res) + 4 * res * res * ch
    f += mid + conv(ch, 2 * z, 9, res) + conv(2 * z, 2 * z, 1, res)
    f += conv(z, z, 1, res) + conv(z, ch, 9, res) + mid     # decoder
    for i, m in enumerate(reversed(mults)):
        for _ in range(r):
            f += conv(ch, b * m, 9, res) + conv(b * m, b * m, 9, res)
            f += conv(ch, b * m, 1, res) if ch != b * m else 0
            ch = b * m
        if i < len(mults) - 1:
            res *= 4
            f += conv(ch, ch, 9, res)
    return f + conv(ch, 1, 9, res)


def ldm_by_hand(mc, mult, r, attn, n):
    emb = 4 * mc
    f = 2 * mc * emb + 2 * emb * emb + conv(32, mc, 9, n)

    def res(cin, cout, n):
        return (conv(cin, cout, 9, n) + 2 * emb * cout + conv(cout, cout, 9, n)
                + (conv(cin, cout, 1, n) if cin != cout else 0))

    def att(c, n):
        return 2 * n * c * 3 * c + 4 * n * n * c + 2 * n * c * c

    chans, ch, ds = [mc], mc, 1
    for level, m in enumerate(mult):
        for _ in range(r):
            f += res(ch, m * mc, n) + (att(m * mc, n) if ds in attn else 0)
            ch = m * mc
            chans.append(ch)
        if level != len(mult) - 1:
            n //= 4
            f += conv(ch, ch, 9, n)
            chans.append(ch)
            ds *= 2
    f += 2 * res(ch, ch, n) + att(ch, n)
    for level, m in reversed(list(enumerate(mult))):
        for i in range(r + 1):
            f += res(ch + chans.pop(), m * mc, n) + (att(m * mc, n) if ds in attn else 0)
            ch = m * mc
            if level and i == r:
                n *= 4
                f += conv(ch, ch, 9, n)
                ds //= 2
    return f + conv(ch, 16, 9, n)


def hifigan_by_hand(init, factors, kernels, rk, dil, floor, t):
    f, ch = conv(256, init, 7, t), init
    for fac, k in zip(factors, kernels):
        out = max(ch // 2, floor)
        f += conv(ch, out, k, t)                            # transposed: on its input length
        t *= fac
        f += sum(len(ds) * 2 * conv(out, out, kk, t) for kk, ds in zip(rk, dil))
        ch = out
    return f + conv(ch, 1, 7, t)


def test_model_flops_by_hand():
    geom = json.loads(json.dumps(json.load(open(flops.PEAKS.parents[1] / "configs"
                                                  / "flashsr_published.json"))["geometry"]))
    geom["vae"].update(base_channels=8, channel_mults=[1, 2], num_res_blocks=1, groups=4)
    geom["unet"].update(model_channels=8, channel_mult=[1, 2], num_res_blocks=1,
                        attention_resolutions=[2], num_heads=2, groups=4)
    geom["vocoder"].update(upsample_initial=16, channel_floor=4, resblock_kernels=[3, 5],
                           resblock_dilations=[[1, 3], [1]])
    hw = 512 * 256
    want = (vae_by_hand(8, (1, 2), 1, 16, hw)
            + ldm_by_hand(8, (1, 2), 1, (2,), hw // 4)     # one downsample: latent at hw / 4
            + hifigan_by_hand(16, (10, 8, 6), (20, 16, 12), (3, 5), ((1, 3), (1,)), 4, 512))
    assert flops.model_flops_per_chunk(json.dumps(geom)) == want


def test_published_count():
    geom = json.load(open(flops.PEAKS.parents[1] / "configs" / "flashsr_published.json"))
    got = flops.model_flops_per_chunk(json.dumps(geom["geometry"]))
    assert 2.6e12 < got < 2.7e12
