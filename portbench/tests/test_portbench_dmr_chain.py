"""The DMR cell's generator and plain reference on the CPU.

- The generator (``inputs/dmr_channels.py``) gives the port's
  ``protocol/dmr/encode.vector_block`` at the same leads and filler
  (the noise made negligible): equal dibits, I/Q within 1e-5; the test
  vector it reads is the port's; every lead of the mix keeps all 16
  superframes whole.
- Each function the reference (``reference/dmr_chain.py``) takes from
  the frozen P25 chain computes what the port's function computes at
  this commit, on DMR's shapes.
- The chain gives the port's frames, wire, PCM and carries on a seeded
  small block, from a fresh carry and from the port's carry.
- The reference imports nothing of the port and no JAX."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.inputs import dmr_channels as gen
from portbench.inputs.c4fm import BlockInfo
from portbench.reference import dmr_chain

TV = dmr_chain.test_vector()
CELL = "dmr.keyed"


@pytest.fixture(scope="module")
def port_tables():
    from dsdneo_tpu_torch import params
    return params.load_dmr("cpu")


@pytest.fixture(scope="module")
def cfg():
    w = harness.resolve(harness.load_spec(), CELL)
    return dict(w.cfg, **w.cfg["small"]), dict(w.mix, **w.mix["small"])


def _modulate(dev_hz):
    from dsdneo_tpu_torch.protocol.p25.encode import c4fm_clean
    return lambda d, sps: c4fm_clean(d, sps, 48000.0, dev_hz)


def test_the_vector_is_the_ports(port_tables):
    ptv = port_tables.test_vector()
    assert set(TV) == set(ptv)
    for k in TV:
        np.testing.assert_array_equal(TV[k], ptv[k])
    assert TV["bits49"].shape == (2, 144, 49)


def test_the_generator_matches_the_ports_vector_block(cfg):
    from dsdneo_tpu_torch.protocol.dmr import encode
    c, _mix = cfg
    c = dict(c, channels=3, snr_db=400.0)
    n = gen.n_samples(c)
    assert gen.n_samples(dict(c, block_s=2.9404)) == 141140
    fill = gen.fillers(2 ** 33 + 5, 1, 3, 96)
    info = BlockInfo(np.arange(3), np.array([0, 41, 96]))
    x = gen.channel_block(c, TV, info, fill, 2 ** 33 + 5, 1, "cpu",
                          n).numpy()
    for ch, lead in enumerate(info.leads):
        dib = gen.stream(TV, fill[ch], int(lead), n // 10)
        np.testing.assert_array_equal(
            dib, np.concatenate([fill[ch][96 - lead:], TV["dibits"]])
            [:n // 10])
        want = encode.vector_block(TV, [int(lead)], [7], n, snr_db=400.0,
                                   modulate=_modulate(c["dev_hz"]),
                                   lead_dibits=fill[ch])
        np.testing.assert_allclose(x[ch], want[0], atol=1e-5, rtol=0)


def test_every_lead_keeps_all_sixteen_superframes():
    w = harness.resolve(harness.load_spec(), CELL)
    n_sym = gen.n_samples(w.cfg) // w.cfg["sps"] - 2
    lo, hi = w.mix["lead_dibits"]
    for lead in range(lo, hi + 1):
        assert len(dmr_chain.expected_frames(TV, lead, n_sym)[0]) == 16


def test_shared_functions_compute_as_the_ports(port_tables):
    """What ``dmr_chain`` takes from the frozen P25 chain, against the
    port's functions on the CPU, bit for bit."""
    from dsdneo_tpu_torch.engine.batched import frontend_step
    from dsdneo_tpu_torch.engine.voicebatch import correlate_syncs_device
    from dsdneo_tpu_torch.fec.device import _ml_dec
    from dsdneo_tpu_torch.ops.audio_wire import adpcm_compress_plain
    from dsdneo_tpu_torch.vocoder import device as vd
    from dsdneo_tpu_torch.vocoder.synth import synthesize_stream
    from portbench.reference.p25_chain import (adpcm_compress_np,
                                               adpcm_expand_np)
    ch = dmr_chain.DmrChain(3, device="cpu")
    b, t = ch.base, ch.tables
    g = torch.Generator().manual_seed(11)
    x = torch.randn((3, 4000, 2), generator=g)
    want = frontend_step(x, port_tables.taps, 10.0, 398, True)
    for a, w in zip(b.frontend_step(x, t.taps, 10.0, 398, True), want):
        assert torch.equal(a, w)
    assert torch.equal(b.correlate_syncs(want[1], t.sync_levels),
                       correlate_syncs_device(want[1],
                                              port_tables.sync_levels))
    words = torch.randint(0, 2, (300, 23), generator=g, dtype=torch.uint8)
    for a, w in zip(b._ml_dec(words, t.golay_pm, t.golay_cb),
                    _ml_dec(words, port_tables.golay_pm,
                            port_tables.golay_cb)):
        assert torch.equal(a, w)
    S = torch.randint(0, 2, (300, 31), generator=g).to(torch.float32)
    li = torch.randint(0, 48, (300,), generator=g)
    assert torch.equal(b._per_frame_matvec(S, t.ambe_w, li),
                       vd._per_frame_matvec(S, port_tables.ambe_w, li))
    C, T = 3, 36
    w0 = torch.rand((C, T), generator=g) * 0.3
    V = (torch.rand((C, T, 56), generator=g) > 0.5).to(torch.float32)
    A = torch.rand((C, T, 56), generator=g)
    good = (torch.rand((C, T), generator=g) > 0.3).to(torch.float32)
    present = (torch.rand((C, T), generator=g) > 0.1).to(torch.float32)
    rep = vd.repeat_state_init(C, "cpu")
    for a, w in zip(torch.utils._pytree.tree_leaves(
            b.repeat_gate(w0, V, A, good, present, rep)),
            torch.utils._pytree.tree_leaves(
            vd.repeat_gate(w0, V, A, good, present, rep))):
        assert torch.equal(a, w)
    assert torch.equal(b.noise_phases(C, T, "cpu"),
                       vd.noise_phases(C, T, "cpu"))
    fch = torch.tensor([0, 1, 2, 3]), torch.tensor([0, 5, 7, 0])
    vals = torch.rand((4, 56), generator=g)
    assert torch.equal(b._scatter(vals, *fch, C, T, torch.float32),
                       vd._scatter(vals, *fch, C, T, torch.float32))
    noise = vd.noise_phases(C, T, "cpu")
    sy = (torch.rand(C, generator=g), torch.rand(C, generator=g) * 0.2,
          torch.rand((C, 56), generator=g))
    got = b.synthesize_stream(w0, A, V, noise, *sy)
    for a, w in zip(got, synthesize_stream(w0, A, V, noise, *sy,
                                           tables=port_tables)):
        assert torch.equal(a, w)
    p = torch.clamp(got[0] * 0.02, -1.0, 1.0).reshape(C, -1)
    wire = adpcm_compress_np(p.numpy(), t.adpcm_step, t.adpcm_index)
    np.testing.assert_array_equal(
        wire, adpcm_compress_plain(p, port_tables.adpcm_step,
                                   port_tables.adpcm_index).numpy())
    from dsdneo_tpu_torch.ops.audio_wire import wire_expand
    np.testing.assert_allclose(
        adpcm_expand_np(wire, t.adpcm_step, t.adpcm_index),
        wire_expand(wire, "adpcm", C), atol=1e-7, rtol=0)


def test_the_chain_gives_the_ports_outputs(cfg, port_tables):
    """A seeded small block through the port's pipeline and the chain:
    the same superframes, frames, error counts and wire bytes, the PCM
    within the expand's rounding, the same carries; then the next block
    from the port's carry."""
    from dsdneo_tpu_torch.engine.dmrbatch import BatchedDmrVoicePipeline
    c, mix = cfg
    ring, infos = gen.make_ring(c, mix, 2 ** 34 + 3, "cpu", pin=False)
    pipe = BatchedDmrVoicePipeline(c["channels"], pcm_fmt="adpcm",
                                   device="cpu", tables=port_tables)
    chain = dmr_chain.DmrChain(c["channels"], device="cpu")
    carry = None
    n_sym = gen.n_samples(c) // c["sps"] - 2
    for blk, info in zip(ring, infos):
        wire = pipe.decode_block_async(blk)
        frames, ref_wire, carry_out, steps = chain.decode(
            chain.frontend(blk), carry)
        n_sf = [len(dmr_chain.expected_frames(TV, int(lead), n_sym)[0])
                for lead in info.leads]
        assert min(n_sf) >= 2
        assert steps == pipe.last_steps == -(-18 * max(n_sf) // 36) * 36
        bits, errs, fch, forder = pipe.last_frames
        np.testing.assert_array_equal(bits.numpy(), frames[0])
        np.testing.assert_array_equal(errs.numpy(), frames[1])
        np.testing.assert_array_equal(fch, frames[2])
        np.testing.assert_array_equal(forder, frames[3])
        assert len(fch) == 18 * sum(n_sf)
        np.testing.assert_array_equal(wire.numpy(), ref_wire)
        np.testing.assert_allclose(pipe.fetch_pcm(wire),
                                   chain.expand(ref_wire), atol=1e-7,
                                   rtol=0)
        got = [t for part in pipe.voice_state() for t in part]
        for a, w in zip(got, [t for part in carry_out for t in part]):
            assert torch.equal(a, w)
        carry = pipe.voice_state()


def test_the_reference_imports_neither_the_port_nor_jax():
    code = ("import sys, json\n"
            "import portbench.reference.dmr_pipelined\n"
            "import portbench.inputs.dmr_channels\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    mods = json.loads(p.stdout.strip().splitlines()[-1])
    assert not [m for m in mods if m.split(".")[0] in
                ("dsdneo_tpu", "dsdneo_tpu_torch", "jax", "jaxlib")]
