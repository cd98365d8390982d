"""Front end of the PyTorch port against the JAX package.

Kernel K1's plain version (``fm_discriminate(fir_complex(x))``, what
``fir_discriminate`` runs on a CPU tensor) against the Pallas kernel in
interpret mode and against the plain XLA chain, at the cases of
``tests/test_pallas_ops.py``; then ``frontend_step`` / ``symbolize_step``:
soft symbols within 1e-3, dibits equal except where the soft symbol sits
within 1e-3 of a slicing threshold (0 or ±2).
"""

import numpy as np
import pytest
import torch

DISC_TOL = 2e-4          # tests/test_pallas_ops.py: Pallas vs XLA
SOFT_TOL = 1e-3          # tests/test_pallas_ops.py: soft symbols
EDGE = 1e-3              # dibits may differ this close to a threshold


def _fm_block(seed, c, b, scale):
    rng = np.random.default_rng(seed)
    phase = np.cumsum(rng.normal(scale=scale, size=(c, b)), axis=-1)
    return np.exp(1j * phase).astype(np.complex64)


@pytest.mark.parametrize("profile,c,b,seed,scale", [
    ("p25_c4fm", 4, 1000, 7, 0.4),
    ("6k25", 3, 517, 3, 0.2),
])
def test_fir_discriminate_matches_jax(profile, c, b, seed, scale):
    import jax.numpy as jnp
    from dsdneo_tpu.dsp import firdes, frontend
    from dsdneo_tpu.ops.pallas_frontend import fir_discriminate as pallas
    from dsdneo_tpu_torch.ops.fir_discriminate import fir_discriminate

    taps = firdes.channel_lpf(48000.0, profile)
    x = _fm_block(seed, c, b, scale)
    xr, xi = x.real.astype(np.float32), x.imag.astype(np.float32)
    want_pallas = np.asarray(pallas(xr, xi, taps, interpret=True))
    want_xla = np.asarray(frontend.fm_discriminate(
        frontend.fir_complex(jnp.asarray(x), jnp.asarray(taps))))
    got = fir_discriminate(torch.from_numpy(xr), torch.from_numpy(xi),
                           torch.from_numpy(taps.astype(np.float32)))
    got = got.numpy()
    assert got.shape == (c, b)
    assert np.all(got[:, 0] == 0.0)
    np.testing.assert_allclose(got[:, 1:], want_pallas[:, 1:], atol=DISC_TOL)
    np.testing.assert_allclose(got, want_xla, atol=DISC_TOL)


def _vector_iq(c, n_samples, seed):
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.protocol.p25 import encode
    tv = params.load("cpu").test_vector()
    rng = np.random.default_rng(seed)
    leads = rng.integers(30, 200, size=c)
    return encode.vector_block(tv, leads, rng.integers(0, 1 << 30, size=c),
                               n_samples)


def _check_symbols(d_j, s_j, d_t, s_t):
    np.testing.assert_allclose(s_t, s_j, atol=SOFT_TOL)
    edge = np.minimum(np.abs(np.abs(s_j) - 2.0), np.abs(s_j)) < EDGE
    assert np.array_equal(d_t[~edge], d_j[~edge])


def test_frontend_step_matches_jax():
    """I/Q → (dibits, soft, power) on a C4FM voice block."""
    import jax.numpy as jnp
    from dsdneo_tpu.dsp import firdes
    from dsdneo_tpu.engine.batched import frontend_step as jax_step
    from dsdneo_tpu_torch.engine.batched import frontend_step

    iq = _vector_iq(2, 24000, 11)
    taps = firdes.channel_lpf(48000.0, "p25_c4fm")
    n_sym = int(24000 // 10.0) - 2
    d_j, s_j, p_j = (np.asarray(a) for a in jax_step(
        jnp.asarray(iq), taps, 10.0, n_sym, True, use_pallas=False))
    d_t, s_t, p_t = frontend_step(torch.from_numpy(iq),
                                  torch.from_numpy(taps.astype(np.float32)),
                                  10.0, n_sym, True)
    assert d_t.dtype == torch.uint8 and d_t.shape == (2, n_sym)
    _check_symbols(d_j, s_j, d_t.numpy(), s_t.numpy())
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-5)


@pytest.mark.parametrize("case", ["fractional_sps", "two_level",
                                  "silent_window"])
def test_symbolize_step_matches_jax(case):
    """The fractional-sps gather branch, two-level slicing, and the
    degenerate-window guard (a window without swing slices to 0)."""
    import jax.numpy as jnp
    from dsdneo_tpu.engine.batched import symbolize_step as jax_sym
    from dsdneo_tpu_torch.engine.batched import symbolize_step

    rng = np.random.default_rng(5)
    c, n = 3, 6000
    if case == "fractional_sps":
        sps, four = 48000.0 / 4600.0, True
    elif case == "two_level":
        sps, four = 10.0, False
    else:
        sps, four = 10.0, True
    n_sym = int(n // sps) - 2
    lv = rng.choice([-3.0, -1.0, 1.0, 3.0], size=(c, n_sym + 4))
    pos = np.arange(n) / sps
    d = (np.interp(pos, np.arange(n_sym + 4), lv[0])[None]
         * np.ones((c, 1)) * 0.3 + 0.02 * rng.normal(size=(c, n)))
    d = d.astype(np.float32)
    if case == "silent_window":
        d[1] = 0.0                                # muted channel
        d[2, : 256 * 10] = 1e-7                   # one dead window
    dib_j, s_j = (np.asarray(a) for a in jax_sym(jnp.asarray(d), sps,
                                                 n_sym, four))
    dib_t, s_t = symbolize_step(torch.from_numpy(d), sps, n_sym, four)
    _check_symbols(dib_j, s_j, dib_t.numpy(), s_t.numpy())
    if case == "silent_window":
        assert np.all(s_t.numpy()[1] == 0.0)
        assert np.all(dib_t.numpy()[1] == 0)


def test_iq_power_matches_jax():
    import jax.numpy as jnp
    from dsdneo_tpu.dsp import frontend
    from dsdneo_tpu_torch.dsp.frontend import iq_power
    x = _fm_block(4, 3, 300, 0.2) * np.float32(0.7)
    np.testing.assert_allclose(iq_power(torch.from_numpy(x)).numpy(),
                               np.asarray(frontend.iq_power(jnp.asarray(x))),
                               rtol=1e-6)


def test_c4fm_generator_matches_jax():
    from dsdneo_tpu.protocol.p25 import encode as jax_encode
    from dsdneo_tpu_torch.protocol.p25 import encode
    dib = np.random.default_rng(2).integers(0, 4, 500).astype(np.uint8)
    np.testing.assert_array_equal(encode.c4fm_iq(dib, seed=9),
                                  jax_encode.c4fm_iq(dib, seed=9))


def test_wrapper_checks_refuse_cpu_tensors_for_the_kernel():
    """The kernel path takes only contiguous CUDA tensors; the checks
    raise instead of launching anything else."""
    from dsdneo_tpu_torch import kernels
    with pytest.raises(ValueError, match="CUDA"):
        kernels.require(torch.zeros(4), "x", torch.float32)


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.ops.fir_discriminate import (
        fir_discriminate, fir_discriminate_plain)
    taps = params.load("cuda").taps
    x = torch.as_tensor(_fm_block(1, 8, 5000, 0.3)).cuda()
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    n0 = fir_discriminate.launches
    got = fir_discriminate(xr, xi, taps)
    assert fir_discriminate.launches == n0 + 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = fir_discriminate_plain(xr, xi, taps)
    torch.testing.assert_close(got, want, rtol=0, atol=DISC_TOL)


def test_fir_discriminate_takes_interleaved_views():
    """The two stride-2 views of one ``[C, B, 2]`` block, as
    ``frontend_step`` now passes them, give what two contiguous planes
    give."""
    from dsdneo_tpu_torch.ops.fir_discriminate import fir_discriminate
    from dsdneo_tpu_torch import params
    taps = params.load("cpu").taps
    iq = torch.from_numpy(_vector_iq(3, 3010, 12))
    xr, xi = iq[..., 0], iq[..., 1]
    assert xr.stride() == (2 * 3010, 2)
    got = fir_discriminate(xr, xi, taps)
    want = fir_discriminate(xr.contiguous(), xi.contiguous(), taps)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ntaps", [1, 2, 143, 255])
def test_k1_kernel_shapes_and_layouts_on_card(ntaps):
    """K1 within 2e-4 of its plain version for 1..255 taps, a length that
    is a multiple of neither the 1024-output tile nor the 8 outputs of a
    thread, one channel and three; the interleaved views give exactly
    what the contiguous planes give."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.ops.fir_discriminate import (
        fir_discriminate, fir_discriminate_plain)
    if ntaps == 143:
        taps = params.load("cuda").taps
        assert taps.shape == (143,)
    else:
        rng = np.random.default_rng(ntaps)
        h = np.hanning(ntaps + 2)[1:-1] * (1 + 0.1 * rng.normal(size=ntaps))
        taps = torch.as_tensor((h / h.sum()).astype(np.float32)).cuda()
    for c, b in ((1, 5003), (3, 2049)):
        z = _fm_block(c + ntaps, c, b, 0.3)
        iq = torch.as_tensor(np.stack([z.real, z.imag], -1)).cuda()
        xr, xi = iq[..., 0], iq[..., 1]
        got = fir_discriminate(xr, xi, taps)
        planes = fir_discriminate(xr.contiguous(), xi.contiguous(), taps)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            want = fir_discriminate_plain(xr.contiguous(), xi.contiguous(),
                                          taps)
        torch.cuda.synchronize()
        assert got.shape == (c, b) and bool((got[:, 0] == 0).all())
        assert torch.equal(got, planes)
        torch.testing.assert_close(got, want, rtol=0, atol=DISC_TOL)


@pytest.mark.cuda
def test_k1_kernel_at_the_dmr_block_length_on_card():
    """K1 at [7, 141140], the DMR path's block: the length is no multiple
    of the 1,024-output tile (137 tiles and 852 outputs), read through
    the stride-2 views with the DMR path's 143 taps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.ops.fir_discriminate import (
        fir_discriminate, fir_discriminate_plain)
    taps = params.load_dmr("cuda").taps
    z = _fm_block(5, 7, 141140, 0.25)
    iq = torch.as_tensor(np.stack([z.real, z.imag], -1)).cuda()
    xr, xi = iq[..., 0], iq[..., 1]
    got = fir_discriminate(xr, xi, taps)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = fir_discriminate_plain(xr.contiguous(), xi.contiguous(), taps)
    torch.cuda.synchronize()
    assert got.shape == (7, 141140)
    torch.testing.assert_close(got, want, rtol=0, atol=DISC_TOL)


@pytest.mark.cuda
def test_fir_complex_on_card_is_full_float32():
    """The CQPSK path's RRC filter on the card against the CPU within
    1e-5 (TF32 would miss by ~1e-3), with the process's cuDNN TF32
    switch on before and after."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_*.py)")
    from dsdneo_tpu_torch.dsp import firdes
    from dsdneo_tpu_torch.dsp.frontend import fir_complex
    x = torch.as_tensor(_fm_block(9, 4, 144000, 0.3))
    taps = torch.as_tensor(firdes.rrc(10.0, 81, 0.2))
    want = fir_complex(x, taps)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = fir_complex(x.cuda(), taps.cuda())
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = before
    assert float((got.cpu() - want).abs().max()) <= 1e-5
