"""The PyTorch port's constant tables and its independence from JAX.

The checked-in ``dsdneo_tpu_torch/data/p25p1_tables.npz``,
``dmr_tables.npz``, ``tdma_tables.npz``, ``cc_tables.npz``,
``event_tables.npz`` and ``burst_tables.npz`` must equal what
``tools/export_torch_tables.py`` builds from the JAX package now
(exact), and importing the port must never load JAX or any module of the
JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

PORT_MODULES = (
    "dsdneo_tpu_torch.app_control.http", "dsdneo_tpu_torch.ui.menu",
    "dsdneo_tpu_torch.ui.terminal", "dsdneo_tpu_torch.ui.panes",
    "dsdneo_tpu_torch.runtime.wizard", "dsdneo_tpu_torch.io.rdio",
    "dsdneo_tpu_torch.io.auto_gain", "dsdneo_tpu_torch.io.auto_ppm",
    "dsdneo_tpu_torch.io.serial_control",
    "dsdneo_tpu_torch.protocol.m17.encoder",
    "dsdneo_tpu_torch.vocoder.batch",
    "dsdneo_tpu_torch", "dsdneo_tpu_torch.device", "dsdneo_tpu_torch.params",
    "dsdneo_tpu_torch.kernels", "dsdneo_tpu_torch.dsp.frontend",
    "dsdneo_tpu_torch.ops.fir_discriminate",
    "dsdneo_tpu_torch.ops.audio_wire", "dsdneo_tpu_torch.engine.batched",
    "dsdneo_tpu_torch.engine.voicebatch", "dsdneo_tpu_torch.fec.device",
    "dsdneo_tpu_torch.vocoder.device", "dsdneo_tpu_torch.vocoder.synth",
    "dsdneo_tpu_torch.protocol.p25.encode", "dsdneo_tpu_torch.dsp.firdes",
    "dsdneo_tpu_torch.dsp.cqpsk", "dsdneo_tpu_torch.symbols.timing",
    "dsdneo_tpu_torch.engine.voicestate", "dsdneo_tpu_torch.engine.dmrbatch",
    "dsdneo_tpu_torch.protocol.dmr.encode", "dsdneo_tpu_torch.engine.modes",
    "dsdneo_tpu_torch.engine.x2batch", "dsdneo_tpu_torch.engine.p2batch",
    "dsdneo_tpu_torch.engine.nxdnbatch", "dsdneo_tpu_torch.fec.rs",
    "dsdneo_tpu_torch.crypto.keystream", "dsdneo_tpu_torch.crypto.keyring",
    "dsdneo_tpu_torch.protocol.p25.p2_xcch",
    "dsdneo_tpu_torch.protocol.nxdn.encode",
    "dsdneo_tpu_torch.engine.ccbatch", "dsdneo_tpu_torch.engine.trunk",
    "dsdneo_tpu_torch.fec.crc", "dsdneo_tpu_torch.fec.trellis",
    "dsdneo_tpu_torch.fec.conv", "dsdneo_tpu_torch.protocol.base",
    "dsdneo_tpu_torch.symbols.framesync", "dsdneo_tpu_torch.core.affiliation",
    "dsdneo_tpu_torch.protocol.p25.phase1",
    "dsdneo_tpu_torch.protocol.p25.p2_mac",
    "dsdneo_tpu_torch.protocol.p25.mac_tables",
    "dsdneo_tpu_torch.protocol.p25.harris",
    "dsdneo_tpu_torch.protocol.p25.phase2",
    "dsdneo_tpu_torch.protocol.dmr.csbk",
    "dsdneo_tpu_torch.protocol.nxdn.decoder", "dsdneo_tpu_torch.protocol.nmea",
    "dsdneo_tpu_torch.symbols.slicer", "dsdneo_tpu_torch.engine.demod",
    "dsdneo_tpu_torch.engine.dstarbatch", "dsdneo_tpu_torch.engine.m17batch",
    "dsdneo_tpu_torch.protocol.dstar.decoder",
    "dsdneo_tpu_torch.protocol.dstar.encode",
    "dsdneo_tpu_torch.protocol.m17.decoder",
    "dsdneo_tpu_torch.protocol.m17.encode", "dsdneo_tpu_torch.vocoder.codec2",
    "dsdneo_tpu_torch.dsp.audio_filters", "dsdneo_tpu_torch.engine.ysfbatch",
    "dsdneo_tpu_torch.engine.dpmrbatch",
    "dsdneo_tpu_torch.protocol.edacs.decoder",
    "dsdneo_tpu_torch.protocol.edacs.afs",
    "dsdneo_tpu_torch.protocol.edacs.encode",
    "dsdneo_tpu_torch.protocol.ysf.encode",
    "dsdneo_tpu_torch.protocol.dpmr.encode",
    "dsdneo_tpu_torch.protocol.dpmr.decoder",
    "dsdneo_tpu_torch.protocol.ysf.decoder",
    "dsdneo_tpu_torch.protocol.dstar.ambe2400",
    "dsdneo_tpu_torch.runtime.config", "dsdneo_tpu_torch.fec.gf",
    "dsdneo_tpu_torch.fec.blockcodes",
    "dsdneo_tpu_torch.protocol.p25.imbe_frame",
    "dsdneo_tpu_torch.vocoder.imbe", "dsdneo_tpu_torch.vocoder.mbe",
    "dsdneo_tpu_torch.vocoder.glue", "dsdneo_tpu_torch.protocol.p25.lcw",
    "dsdneo_tpu_torch.protocol.p25.mbt",
    "dsdneo_tpu_torch.protocol.dmr.ip_pdu",
    "dsdneo_tpu_torch.protocol.dmr.lrrp", "dsdneo_tpu_torch.protocol.dmr.gps",
    "dsdneo_tpu_torch.protocol.provoice.decoder",
    "dsdneo_tpu_torch.protocol.provoice.imbe7100",
    "dsdneo_tpu_torch.protocol.provoice.encode",
    "dsdneo_tpu_torch.dsp.channelizer", "dsdneo_tpu_torch.engine.fleettrunk",
    "dsdneo_tpu_torch.engine.fleetvec", "dsdneo_tpu_torch.engine.wideband",
    "dsdneo_tpu_torch.engine.fleet", "dsdneo_tpu_torch.engine.analogbatch",
    "dsdneo_tpu_torch.parallel.mesh", "dsdneo_tpu_torch.parallel",
    "dsdneo_tpu_torch.parallel.dist", "dsdneo_tpu_torch.parallel.trunkfleet",
    "dsdneo_tpu_torch.parallel.__main__",
    "dsdneo_tpu_torch.ui.panes",
    "dsdneo_tpu_torch.engine.decoder", "dsdneo_tpu_torch.engine.serialvec",
    "dsdneo_tpu_torch.fec.bptc", "dsdneo_tpu_torch.fec.trellis34",
    "dsdneo_tpu_torch.protocol.dmr", "dsdneo_tpu_torch.protocol.dmr.bs",
    "dsdneo_tpu_torch.protocol.dmr.ambe_frame",
    "dsdneo_tpu_torch.protocol.dmr.late_entry",
    "dsdneo_tpu_torch.protocol.dmr.slc", "dsdneo_tpu_torch.protocol.dmr.udt",
    "dsdneo_tpu_torch.protocol.dmr.data", "dsdneo_tpu_torch.protocol.x2tdma",
    "dsdneo_tpu_torch.protocol.x2tdma.decoder",
    "dsdneo_tpu_torch.crypto.retevis_rc2", "dsdneo_tpu_torch.crypto.pc4",
    "dsdneo_tpu_torch.crypto.pc5", "dsdneo_tpu_torch.crypto.vendor",
    "dsdneo_tpu_torch.crypto.ecdsa", "dsdneo_tpu_torch.io",
    "dsdneo_tpu_torch.io.iq", "dsdneo_tpu_torch.runtime.jitter",
    "dsdneo_tpu_torch.dsp.resampler", "dsdneo_tpu_torch.protocol.m17",
    "dsdneo_tpu_torch.protocol.m17.ip",
    "dsdneo_tpu_torch.cli", "dsdneo_tpu_torch.engine.stream",
    "dsdneo_tpu_torch.engine.live", "dsdneo_tpu_torch.engine.livevec",
    "dsdneo_tpu_torch.engine.lcn_calc", "dsdneo_tpu_torch.runtime.log",
    "dsdneo_tpu_torch.runtime.native",
    "dsdneo_tpu_torch.runtime.calibration",
    "dsdneo_tpu_torch.runtime.rt_sched", "dsdneo_tpu_torch.dsp.measure",
    "dsdneo_tpu_torch.core.events", "dsdneo_tpu_torch.core.talkgroup",
    "dsdneo_tpu_torch.core.calls", "dsdneo_tpu_torch.io.audio_files",
    "dsdneo_tpu_torch.io.audio_out", "dsdneo_tpu_torch.io.mbe_files",
    "dsdneo_tpu_torch.io.symbol_capture", "dsdneo_tpu_torch.io.net",
    "dsdneo_tpu_torch.io.rtl_tcp", "dsdneo_tpu_torch.io.sdr_device",
    "dsdneo_tpu_torch.app_control", "dsdneo_tpu_torch.app_control.commands",
    "dsdneo_tpu_torch.app_control.snapshot")


@pytest.fixture(scope="module")
def exported():
    from export_torch_tables import build_tables
    return build_tables()


@pytest.fixture(scope="module")
def stored():
    from dsdneo_tpu_torch.params import TABLES_NPZ
    with np.load(TABLES_NPZ) as z:
        return {k: z[k] for k in z.files}


def test_npz_has_every_exported_array(exported, stored):
    assert sorted(exported) == sorted(stored)


@pytest.mark.parametrize("group", ["front", "ecc", "dequant", "scalars",
                                   "wire_synth", "vector"])
def test_npz_equals_exporter(exported, stored, group):
    prefix = {"front": ("taps", "symbol_rate", "four_level", "sync_"),
              "ecc": ("ecc_", "golay_", "h15_"),
              "dequant": ("dq_",),
              "scalars": ("gain_", "b0_", "voicing_", "pred_", "imbe_",
                          "tone_"),
              "wire_synth": ("adpcm_", "synth_"),
              "vector": ("tv_",)}[group]
    keys = [k for k in exported if k.startswith(prefix)]
    assert keys
    for k in keys:
        a, b = np.asarray(exported[k]), np.asarray(stored[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.fixture(scope="module")
def dmr_exported():
    from export_torch_tables import build_dmr_tables
    return build_dmr_tables()


@pytest.mark.parametrize("group", ["front", "ecc", "dequant", "wire_synth",
                                   "vector"])
def test_dmr_npz_equals_exporter(dmr_exported, group):
    """The checked-in ``dmr_tables.npz`` is what the exporter builds from
    the JAX package now; its test vector is ``synth_voice_stream(8,
    seed=1)``."""
    from dsdneo_tpu_torch.params import DMR_TABLES_NPZ
    with np.load(DMR_TABLES_NPZ) as z:
        stored = {k: z[k] for k in z.files}
    assert sorted(dmr_exported) == sorted(stored)
    prefix = {"front": ("taps", "symbol_rate", "four_level", "sync_"),
              "ecc": ("ambe_g", "ambe_p", "golay_", "qr_"),
              "dequant": ("ambe_w", "ambe_c", "ambe_a"),
              "wire_synth": ("adpcm_", "synth_"),
              "vector": ("tv_",)}[group]
    keys = [k for k in dmr_exported if k.startswith(prefix)]
    assert keys
    for k in keys:
        a, b = np.asarray(dmr_exported[k]), np.asarray(stored[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    if group == "vector":
        assert stored["tv_dibits"].shape == (14114,)
        assert stored["tv_bits49"].shape == (2, 144, 49)
    if group == "front":
        assert stored["taps"].shape == (143,)
        assert stored["sync_inverted"].tolist() == [False, True]


def test_dmr_from_numpy_of_jax_arrays_equals_loaded(dmr_exported):
    from dsdneo_tpu_torch import params
    a = params.dmr_from_numpy(dmr_exported, "cpu")
    b = params.load_dmr("cpu")
    n = 0
    for name, v in vars(a).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(b, name)), name
            n += 1
    assert n >= 20
    assert sorted(b.test_vector()) == ["bits49", "dibits", "seeds"]


@pytest.fixture(scope="module")
def tdma_exported():
    from export_torch_tables import build_tdma_tables
    return build_tdma_tables()


@pytest.mark.parametrize("group", ["front", "host", "x2", "p2", "nxdn"])
def test_tdma_npz_equals_exporter(tdma_exported, group):
    """The checked-in ``tdma_tables.npz`` is what the exporter builds
    from the JAX package now."""
    from dsdneo_tpu_torch.params import TDMA_TABLES_NPZ
    with np.load(TDMA_TABLES_NPZ) as z:
        stored = {k: z[k] for k in z.files}
    assert sorted(tdma_exported) == sorted(stored)
    prefix = {"front": ("taps_", "rate_", "sync_"),
              "host": ("gf64_", "p2_duid", "p2_isch", "nxdn_pn9"),
              "x2": ("x2_tv_",), "p2": ("p2_tv_",),
              "nxdn": ("nxdn_tv_",)}[group]
    keys = [k for k in tdma_exported if k.startswith(prefix)]
    assert keys
    for k in keys:
        a, b = np.asarray(tdma_exported[k]), np.asarray(stored[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    if group == "x2":
        assert stored["x2_tv_dibits"].shape == (14114,)
    if group == "p2":
        assert stored["p2_tv_dibits"].shape == (17380,)
        assert stored["p2_tv_adp_bits49"].shape == (2, 72, 49)
    if group == "nxdn":
        assert stored["nxdn_tv_bits49"].shape == (36 * 4, 49)


@pytest.mark.parametrize("mode", ["x2tdma", "p25p2", "nxdn48", "nxdn96"])
def test_tdma_from_numpy_equals_loaded_and_modes(tdma_exported, mode):
    """Tables built from the JAX package's arrays equal the loaded ones;
    the port's mode rows equal the JAX package's."""
    from dsdneo_tpu.engine.modes import MODES as JMODES
    from export_torch_tables import build_dmr_tables
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.engine.modes import MODES
    a = params.tdma_from_numpy(build_dmr_tables(), tdma_exported, mode,
                               "cpu")
    b = params.load_tdma(mode, "cpu")
    n = 0
    for name, v in vars(a).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(b, name)), name
            n += 1
    assert n >= 20
    m, j = MODES[mode], JMODES[mode]
    assert (m.lpf_profile, m.symbol_rate, m.four_level) == (
        j.lpf_profile, j.symbol_rate, j.four_level)
    assert b.symbol_rate == j.symbol_rate and b.mode == mode
    with pytest.raises(ValueError, match="unknown TDMA mode"):
        params.load_tdma("dmr", "cpu")


@pytest.fixture(scope="module")
def cc_exported():
    from export_torch_tables import build_cc_tables
    return build_cc_tables()


@pytest.mark.parametrize("group", ["fec", "dmr", "cac", "p25_tv", "dmr_tv",
                                   "nxdn_tv"])
def test_cc_npz_equals_exporter(cc_exported, group):
    """The checked-in ``cc_tables.npz`` is what the exporter builds from
    the JAX package now: its constants and its three vectors with their
    payloads and event lines."""
    from dsdneo_tpu_torch.params import CC_TABLES_NPZ
    with np.load(CC_TABLES_NPZ) as z:
        stored = {k: z[k] for k in z.files}
    assert sorted(cc_exported) == sorted(stored)
    prefix = {"fec": ("p25_deperm", "p25_expect", "p25_nibbles", "crc16_",
                      "tsdu_", "bptc_", "h15_", "h13_", "golay20_", "conv_"),
              "dmr": ("dmr_st", "dmr_payload", "dmr_cc_"),
              "cac": ("cac_",), "p25_tv": ("p25_tv_",),
              "dmr_tv": ("dmr_tv_",), "nxdn_tv": ("nxdn_tv_",)}[group]
    keys = [k for k in cc_exported if k.startswith(prefix)]
    assert keys
    for k in keys:
        a, b = np.asarray(cc_exported[k]), np.asarray(stored[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    if group.endswith("_tv"):
        assert stored[group + "_lines"].dtype.kind == "U"
        assert (stored[group + "_line_block"].max() + 1
                == len(stored[group + "_payloads"]))


def test_cc_from_numpy_of_jax_arrays_equals_loaded(cc_exported):
    from dsdneo_tpu_torch import params
    for kind in params.CcTables.KINDS:
        b = params.load_cc(kind, "cpu")
        a = params.cc_from_numpy(cc_exported, b.front, kind)
        n = 0
        for name, v in vars(a).items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, getattr(b, name)), name
                n += 1
        assert n == 18
        assert sorted(b.test_vector()) == ["dibits", "fields", "lead",
                                           "line_block", "lines", "payloads",
                                           "seeds", "starts"]
    with pytest.raises(ValueError, match="unknown control-channel kind"):
        params.load_cc("edacs", "cpu")


@pytest.fixture(scope="module")
def event_exported():
    from export_torch_tables import build_event_tables
    return build_event_tables()


@pytest.mark.parametrize("group", ["dstar_ecc", "golay", "dstar_tv",
                                   "m17_tv"])
def test_event_npz_equals_exporter(event_exported, group):
    """The checked-in ``event_tables.npz`` is what the exporter builds
    from the JAX package now (its D-STAR and M17 vectors held to the JAX
    pipelines on the way)."""
    from dsdneo_tpu_torch.params import EVENT_TABLES_NPZ
    with np.load(EVENT_TABLES_NPZ) as z:
        stored = {k: z[k] for k in z.files}
    assert sorted(event_exported) == sorted(stored)
    prefix = {"dstar_ecc": ("dstar_ambe_",), "golay": ("golay",),
              "dstar_tv": ("dstar_tv_",), "m17_tv": ("m17_tv_",)}[group]
    keys = [k for k in event_exported if k.startswith(prefix)]
    assert keys
    for k in keys:
        a, b = np.asarray(event_exported[k]), np.asarray(stored[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_event_from_numpy_of_jax_arrays_equals_loaded(event_exported):
    from dsdneo_tpu_torch import params
    for kind, n in (("dstar", 9), ("m17", 2)):
        b = params.load_event(kind, "cpu")
        a = params.event_from_numpy(event_exported, kind, "cpu")
        got = 0
        for name, v in vars(a).items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, getattr(b, name)), name
                got += 1
        assert got == n
        assert "dibits" in b.test_vector() and "lead" in b.test_vector()
    with pytest.raises(ValueError, match="unknown event pipeline"):
        params.load_event("ysf", "cpu")


@pytest.fixture(scope="module")
def burst_exported():
    from export_torch_tables import build_burst_tables
    return build_burst_tables()


@pytest.mark.parametrize("kind", ["ysf", "dpmr", "edacs"])
def test_burst_npz_equals_exporter(burst_exported, kind):
    """The checked-in ``burst_tables.npz`` is what the exporter builds from
    the JAX package now (each stream held to the JAX pipeline on the
    way, its accepted frames kept)."""
    from dsdneo_tpu_torch.params import BURST_TABLES_NPZ
    with np.load(BURST_TABLES_NPZ) as z:
        stored = {k: z[k] for k in z.files}
    assert sorted(burst_exported) == sorted(stored)
    keys = [k for k in burst_exported if k.startswith(kind + "_tv_")]
    assert f"{kind}_tv_jax_frames" in keys and f"{kind}_tv_dibits" in keys
    for k in keys:
        a, b = np.asarray(burst_exported[k]), np.asarray(stored[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_burst_from_numpy_of_jax_arrays_equals_loaded(burst_exported):
    from dsdneo_tpu_torch import params
    dmr = params._read_npz(params.DMR_TABLES_NPZ)
    for kind in ("ysf", "dpmr", "edacs"):
        b = params.load_burst(kind, "cpu")
        a = params.burst_from_numpy(dmr, burst_exported, kind, "cpu")
        assert a.kind == b.kind == kind
        ta, tb = a.test_vector(), b.test_vector()
        assert sorted(ta) == sorted(tb) and "dibits" in ta and "lead" in ta
        for k in ta:
            np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
        if kind == "edacs":
            assert a.ambe is None and b.ambe is None
        else:
            assert torch.equal(a.ambe.ambe_w, b.ambe.ambe_w)
            assert torch.equal(a.ambe.adpcm_step, b.ambe.adpcm_step)


def test_burst_paths_run_without_the_jax_package():
    """Decode a C=1 block of YSF and dPMR (K3's and K8's plain versions
    on the way) and of the EDACS monitor on the CPU: no module of the JAX
    package, and no jax, is ever loaded."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from dsdneo_tpu_torch import params\n"
        "from dsdneo_tpu_torch.dsp.audio_filters import condition_audio\n"
        "from dsdneo_tpu_torch.engine.ccbatch import "
        "BatchedEdacsControlPipeline\n"
        "from dsdneo_tpu_torch.engine.dpmrbatch import "
        "BatchedDpmrVoicePipeline\n"
        "from dsdneo_tpu_torch.engine.ysfbatch import "
        "BatchedYsfVoicePipeline\n"
        "from dsdneo_tpu_torch.protocol.dmr.encode import vector_block\n"
        "from dsdneo_tpu_torch.protocol.dpmr import encode as de\n"
        "from dsdneo_tpu_torch.protocol.ysf import encode as ye\n"
        "from dsdneo_tpu_torch.protocol.edacs import encode as ee\n"
        "for kind, cls, mod, sps in (('ysf', BatchedYsfVoicePipeline, ye, "
        "10), ('dpmr', BatchedDpmrVoicePipeline, de, 20)):\n"
        "    t = params.load_burst(kind, 'cpu')\n"
        "    tv = t.test_vector()\n"
        "    x = vector_block(tv, (3,), (1,), 2400 * sps, sps=sps, "
        "modulate=mod.fm_iq, lead_dibits=tv['lead'])\n"
        "    p = cls(1, pcm_fmt='adpcm', device='cpu', tables=t)\n"
        "    pcm = p.decode_block(x)\n"
        "    assert pcm.shape[1] > 0 and np.abs(pcm).max() > 0, kind\n"
        "    y = condition_audio(torch.as_tensor(pcm[:, :400]), 'nfm', "
        "3400)\n"
        "    assert torch.isfinite(y).all(), kind\n"
        "t = params.load_burst('edacs', 'cpu')\n"
        "tv = t.test_vector()\n"
        "x = vector_block(tv, (3,), (1,), 4000 * 5, sps=5, "
        "modulate=ee.fm_iq, lead_dibits=tv['lead'])\n"
        "p = BatchedEdacsControlPipeline(1, device='cpu')\n"
        "assert p.decode_block_events(x) >= 10\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dsdneo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.fixture(scope="module")
def serial_exported():
    from export_torch_tables import build_serial_tables
    return build_serial_tables(check=False)


@pytest.mark.parametrize("kind", ["p25", "pv", "dmr", "x2", "nxdn", "dpmr",
                                  "ysf", "dstar", "m17", "p2"])
def test_serial_npz_equals_exporter(serial_exported, kind):
    """The checked-in ``serial_tables.npz`` is what the exporter builds
    from the JAX package's encoders now (the exporter also holds each
    stream to the JAX ``decode_samples`` before it writes them)."""
    from dsdneo_tpu_torch.params import SERIAL_TABLES_NPZ
    with np.load(SERIAL_TABLES_NPZ) as z:
        stored = {k: z[k] for k in z.files}
    assert sorted(serial_exported) == sorted(stored)
    keys = [k for k in serial_exported if k.startswith(kind + "_")]
    assert f"{kind}_dibits" in keys
    for k in keys:
        a, b = np.asarray(serial_exported[k]), np.asarray(stored[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_serial_npz_auto_picks_equal_exporter(serial_exported):
    """The stored ``detect_mode`` picks (``auto_families``,
    ``auto_picks``) are the exporter's; it holds them to the JAX
    ``detect_mode`` on each family's probe before it writes them."""
    from dsdneo_tpu_torch.params import SERIAL_TABLES_NPZ
    with np.load(SERIAL_TABLES_NPZ) as z:
        for k in ("auto_families", "auto_picks"):
            np.testing.assert_array_equal(z[k], serial_exported[k])
    from dsdneo_tpu_torch.engine import serialvec as SV
    assert tuple(serial_exported["auto_families"]) == SV.AUTO_FAMILIES


@pytest.fixture(scope="module")
def fleet_exported():
    from export_torch_tables import build_fleet_tables
    return build_fleet_tables(check=False)


@pytest.mark.parametrize("kind", ["bench", "wide", "dmr", "nxdn", "edacs",
                                  "p2"])
def test_fleet_npz_equals_exporter(fleet_exported, kind):
    """The checked-in ``fleet_tables.npz`` is what the exporter builds
    from the JAX package's encoders now (the exporter also holds each
    band to the JAX ``TrunkedFleet`` before it writes them)."""
    from dsdneo_tpu_torch.params import FLEET_TABLES_NPZ
    with np.load(FLEET_TABLES_NPZ) as z:
        stored = {k: z[k] for k in z.files}
    assert sorted(fleet_exported) == sorted(stored)
    keys = [k for k in fleet_exported if k.startswith(kind + "_")]
    assert keys
    for k in keys:
        a, b = np.asarray(fleet_exported[k]), np.asarray(stored[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_serial_decode_runs_without_the_jax_package():
    """Import ``engine.decoder`` and decode 1.5 s of the P25 call (its
    first keyed superframe included), 1 s of the EDACS/ProVoice stream,
    3 s of the DMR stream with every DMR voice cipher set (Basic Privacy,
    CSI72, TYT16, TYT-EP, Retevis RC2, PC4, PC5, the Hytera, Kenwood and
    Anytone keystreams, a static keystream and, through the Vertex map,
    its key-ID lookup) and the RC4 call with its key, 2 s of the X2-TDMA
    stream, 1 s of the NXDN stream as NXDN48 and 2 s as NXDN96, 1.5 s of
    the dPMR stream, 2 s each of the YSF and D-STAR streams, 3 s of the
    M17 stream with its keys and 2 s of the P25p2 stream with its
    parameters and key on the CPU, the clear ones held to their vectors;
    ``detect_mode`` on the P25p2 probe and ``decode_capture`` of a
    96 kHz capture of the P25 call (``io.write_iq_capture`` after
    ``dsp.resampler``): no module of the JAX package, and no jax, is
    ever loaded."""
    code = (
        "import sys\n"
        "from dsdneo_tpu_torch.engine.decoder import decode_samples\n"
        "from dsdneo_tpu_torch.engine import serialvec as SV\n"
        "from dsdneo_tpu_torch.crypto.keyring import KeyRing\n"
        "tv = SV.vector()\n"
        "kr = kr0 = KeyRing()\n"
        "kr.scalar[int(tv['p25_ids'][4])] = int(tv['p25_ids'][3])\n"
        "sink = SV.ImbeSink()\n"
        "ctx = decode_samples(SV.p25_iq(tv, 7200), 'p25p1', keyring=kr, "
        "mbe_sink=sink, device='cpu')\n"
        "got = SV.judge_p25(tv, ctx, sink, 7200)\n"
        "assert got['keyed_ldus'] >= 2, got\n"
        "ctx = decode_samples(SV.pv_iq(tv, 9600), 'provoice', "
        "device='cpu')\n"
        "assert SV.judge_pv(tv, ctx, 9600)['provoice_superframes'] >= 3\n"
        "from dsdneo_tpu_torch.crypto import pc4, pc5, retevis_rc2, vendor\n"
        "h = '0123456789ABCDEF0123456789ABCDEF'\n"
        "attrs = {'dmr_bp_key_id': 7, 'dmr_csi72_key': bytes(range(9)), "
        "'dmr_tyt16_key': 0xABCD, 'dmr_tyt_ep_key': 1 << 100, "
        "'dmr_retevis_rc2': retevis_rc2.RetevisRC2.from_hex(h), "
        "'dmr_tyt_ap': pc4.PC4.from_hex(h), "
        "'dmr_baofeng_pc5': pc5.PC5.from_hex(h)}\n"
        "for sf in ({'dmr_hytera_bp': (0x123456789A,)}, "
        "{'dmr_kenwood_key': 12345}, {'dmr_anytone_key': 0x1234}, "
        "{'dmr_static_ks': vendor.StaticKeystream.parse('DEADBEEF:32')}, "
        "{'dmr_vertex_ks_map': {0: vendor.StaticKeystream.parse('AB:8')}}):\n"
        "    ctx = decode_samples(SV.dmr_iq(tv, 14400), 'dmr', "
        "state_attrs={**attrs, **sf}, device='cpu')\n"
        "    assert sum('VC' in e.line for e in ctx.events) >= 30\n"
        "    assert ctx.audio and ctx.state.dmr_vc_frame_count >= 90\n"
        "kr = KeyRing()\n"
        "kr.scalar[int(tv['dmr_ids'][2])] = int(tv['dmr_ids'][1])\n"
        "start = int(tv['dmr_windows'][0])\n"
        "sink = SV.ImbeSink()\n"
        "ctx = decode_samples(SV.dmr_iq(tv, 19200, start=start), 'dmr', "
        "keyring=kr, mbe_sink=sink, device='cpu')\n"
        "assert SV.judge_dmr(tv, ctx, sink, start, 19200, "
        "rc4=True)['rc4_frames'] >= 72\n"
        "for mode, n, iq, key, least in (\n"
        "        ('x2tdma', 12000, SV.x2_iq, 'superframes', 5),\n"
        "        ('nxdn48', 2400, SV.nxdn_iq, 'vcalls', 2),\n"
        "        ('nxdn96', 9600, SV.nxdn_iq, 'vcalls', 2),\n"
        "        ('dpmr', 3600, SV.dpmr_iq, 'fs3_parts', 3),\n"
        "        ('ysf', 9600, SV.ysf_iq, 'imbe_frames', 10),\n"
        "        ('dstar', 9600, SV.dstar_iq, 'superframes', 3),\n"
        "        ('m17', 14400, SV.m17_iq, 'voice_frames', 60),\n"
        "        ('p25p2', 12000, SV.p2_iq, 'voice_frames', 150)):\n"
        "    x = iq(tv, n, mode) if iq is SV.nxdn_iq else iq(tv, n)\n"
        "    kw = {'m17': {'state_attrs': SV.m17_attrs(tv)},\n"
        "          'p25p2': {'p2_params': SV.p2_params(tv),\n"
        "                    'keyring': SV.keyring(tv)}}.get(mode, {})\n"
        "    ctx, sinks = SV.decode_spied(x, mode, device='cpu', **kw)\n"
        "    got = SV.judge(mode, tv, ctx, sinks, n)\n"
        "    assert got[key] >= least, (mode, got)\n"
        "from dsdneo_tpu_torch.engine.decoder import detect_mode, "
        "decode_capture\n"
        "assert detect_mode(SV.p2_iq(tv, 24000), device='cpu').name == "
        "'p25p2'\n"
        "import os, tempfile, torch\n"
        "from dsdneo_tpu_torch.dsp.resampler import resample\n"
        "from dsdneo_tpu_torch.io import IqMetadata, write_iq_capture\n"
        "x = resample(torch.from_numpy(SV.p25_iq(tv, 7200)), 48000, "
        "96000).numpy()\n"
        "path = os.path.join(tempfile.mkdtemp(), 'p25.iq')\n"
        "write_iq_capture(path, 0.5 * x, IqMetadata(sample_format='cs16', "
        "sample_rate_hz=96000))\n"
        "sink = SV.ImbeSink()\n"
        "ctx = decode_capture(path, 'p25p1', keyring=kr0, mbe_sink=sink, "
        "device='cpu')\n"
        "assert SV.judge_p25(tv, ctx, sink, 7200)['ldus'] >= 4\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dsdneo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_cli_runs_without_the_jax_package():
    """``python -m dsdneo_tpu_torch --platform cpu -f1 --iq-replay`` on
    2 s of the P25 call (a capture the port writes), run as ``-m`` runs
    it (``runpy``) in a fresh process, then the live path's closed loop
    (``engine/livevec``: ``LiveEngine`` with ``TrunkFollower`` and
    ``TrunkSM``): the call decodes, every LDU of the followed call is
    exact, and no module of the JAX package, and no jax, is ever
    loaded."""
    code = (
        "import os, runpy, sys, tempfile\n"
        "from dsdneo_tpu_torch.engine import serialvec as SV\n"
        "from dsdneo_tpu_torch.io import IqMetadata, write_iq_capture\n"
        "tv = SV.vector()\n"
        "path = os.path.join(tempfile.mkdtemp(), 'p25.iq')\n"
        "write_iq_capture(path, SV.p25_iq(tv, 9600), "
        "IqMetadata(sample_format='cf32', sample_rate_hz=48000))\n"
        "sys.argv = ['dsdneo_tpu_torch', '--platform', 'cpu', '-f1', "
        "'--iq-replay', path]\n"
        "try:\n"
        "    runpy.run_module('dsdneo_tpu_torch', run_name='__main__', "
        "alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "from dsdneo_tpu_torch.engine import fleetvec as FV, live, trunk\n"
        "from dsdneo_tpu_torch.engine import livevec as LV\n"
        "loop = LV.ClosedLoop(live.LiveEngine, trunk.TrunkSM, "
        "trunk.TrunkFollower, SV.ImbeSink(), engine_kw={'device': 'cpu'})\n"
        "loop.run(FV.vector())\n"
        "assert LV.judge(loop, FV.vector())['ldus'] == 11\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dsdneo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
    assert r.stderr.count("LDU1 VOICE (9 IMBE frames)") >= 4
    assert "Group 2501 Source 1234567" in r.stderr


def test_port_sources_import_no_jax_module():
    """No line of the port's sources imports jax or a module of the JAX
    package, inside a function included (the serial decoders import
    their helpers in their methods), and no string names a module of the
    JAX package (``engine.fleet``'s factory tables import by name)."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|dsdneo_tpu)(\.|\s|$)")
    named = re.compile(r"[\"']dsdneo_tpu\.[A-Za-z_]")
    bad = []
    for top, _dirs, files in os.walk(os.path.join(ROOT, "dsdneo_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(top, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if pat.match(line) or named.search(line):
                            bad.append(f"{path}:{i}: {line.strip()}")
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        bad += [line for line in fh if pat.match(line) or named.search(line)]
    assert not bad, bad


def test_port_never_imports_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'dsdneo_tpu'))\n"
              "assert not bad, bad\n"
              "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_port_runs_without_the_jax_package():
    """Import the port, load its tables, decode a C=2 ADPCM block and
    expand it on the host: no module of the JAX package, and no jax, is
    ever loaded."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from dsdneo_tpu_torch import params\n"
        "from dsdneo_tpu_torch.engine.voicebatch import "
        "BatchedP25VoicePipeline\n"
        "from dsdneo_tpu_torch.protocol.p25 import encode\n"
        "t = params.load('cpu')\n"
        "iq = encode.vector_block(t.test_vector(), (30, 77), (1, 2), 24000)\n"
        "p = BatchedP25VoicePipeline(2, pcm_fmt='adpcm', device='cpu', "
        "tables=t)\n"
        "pcm = p.decode_block(iq)\n"
        "assert pcm.shape[0] == 2 and pcm.shape[1] > 0, pcm.shape\n"
        "assert np.isfinite(pcm).all() and np.abs(pcm).max() > 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'dsdneo_tpu' or "
        "m.startswith('dsdneo_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_dmr_and_cqpsk_paths_run_without_the_jax_package():
    """Decode a C=2 DMR block (ADPCM) and a C=2 CQPSK block on the CPU:
    no module of the JAX package, and no jax, is ever loaded."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from dsdneo_tpu_torch import params\n"
        "from dsdneo_tpu_torch.engine.dmrbatch import "
        "BatchedDmrVoicePipeline\n"
        "from dsdneo_tpu_torch.engine.voicebatch import "
        "BatchedP25VoicePipeline\n"
        "from dsdneo_tpu_torch.protocol.dmr import encode as dmr_encode\n"
        "from dsdneo_tpu_torch.protocol.p25 import encode\n"
        "d = params.load_dmr('cpu')\n"
        "iq = dmr_encode.vector_block(d.test_vector(), (3, 9), (1, 2), "
        "20000)\n"
        "p = BatchedDmrVoicePipeline(2, pcm_fmt='adpcm', device='cpu', "
        "tables=d)\n"
        "pcm = p.decode_block(iq)\n"
        "assert pcm.shape == (2, 2 * 18 * 160), pcm.shape\n"
        "assert np.isfinite(pcm).all() and np.abs(pcm).max() > 0\n"
        "t = params.load('cpu')\n"
        "iq = encode.vector_block(t.test_vector(), (30, 77), (1, 2), 12000, "
        "modulation='cqpsk', cfo_hz=(150.0, -90.0))\n"
        "q = BatchedP25VoicePipeline(2, cqpsk=True, device='cpu', tables=t)\n"
        "pcm = q.decode_block(iq)\n"
        "assert pcm.shape[0] == 2 and pcm.shape[1] > 0, pcm.shape\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dsdneo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_tdma_paths_run_without_the_jax_package():
    """Decode a C=2 X2 block (ADPCM), a C=1 encrypted P2 block with its
    key (K7's plain version and the host RS decoder on the way) and a
    C=2 NXDN96 block on the CPU: no module of the JAX package, and no
    jax, is ever loaded."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from dsdneo_tpu_torch import params\n"
        "from dsdneo_tpu_torch.crypto.keyring import KeyRing\n"
        "from dsdneo_tpu_torch.engine.nxdnbatch import "
        "BatchedNxdnVoicePipeline\n"
        "from dsdneo_tpu_torch.engine.p2batch import BatchedP2VoicePipeline\n"
        "from dsdneo_tpu_torch.engine.x2batch import BatchedX2VoicePipeline\n"
        "from dsdneo_tpu_torch.protocol.dmr.encode import vector_block\n"
        "from dsdneo_tpu_torch.protocol.nxdn.encode import modulator\n"
        "from dsdneo_tpu_torch.protocol.p25.encode import tdma_fm_iq\n"
        "t = params.load_tdma('x2tdma', 'cpu')\n"
        "iq = vector_block(t.test_vector(), (3, 9), (1, 2), 16000, sps=8, "
        "modulate=tdma_fm_iq)\n"
        "pcm = BatchedX2VoicePipeline(2, pcm_fmt='adpcm', device='cpu', "
        "tables=t).decode_block(iq)\n"
        "assert pcm.shape == (2, 2 * 18 * 160), pcm.shape\n"
        "t = params.load_tdma('p25p2', 'cpu')\n"
        "tv = t.test_vector()\n"
        "iq = vector_block({'dibits': tv['adp_dibits']}, (3,), (1,), "
        "2 * 2160 * 8 + 800, sps=8, modulate=tdma_fm_iq)\n"
        "kr = KeyRing()\n"
        "kr.scalar[int(tv['adp_params'][3])] = int(tv['adp_params'][4])\n"
        "p = BatchedP2VoicePipeline(1, keyring=kr, device='cpu', tables=t)\n"
        "bits, out, order = p.decode_block_bits49(iq)\n"
        "sel = np.flatnonzero(out == 0)\n"
        "assert (bits[sel][18:] == tv['adp_bits49'][0][18:len(sel)]).all()\n"
        "t = params.load_tdma('nxdn96', 'cpu')\n"
        "iq = vector_block(t.test_vector(), (3, 9), (1, 2), 24000, "
        "modulate=modulator('nxdn96'))\n"
        "pcm = BatchedNxdnVoicePipeline(2, mode='nxdn96', device='cpu', "
        "tables=t).decode_block(iq)\n"
        "assert pcm.shape[1] > 0 and np.isfinite(pcm).all()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dsdneo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_cc_monitors_run_without_the_jax_package():
    """Decode a C=1 block of each control-channel monitor on the CPU
    (K4's and K5's plain versions on the way): no module of the JAX
    package, and no jax, is ever loaded."""
    code = (
        "import sys\n"
        "from dsdneo_tpu_torch import params\n"
        "from dsdneo_tpu_torch.engine import ccbatch\n"
        "from dsdneo_tpu_torch.protocol.dmr.encode import vector_block, "
        "dmr_fm_iq\n"
        "from dsdneo_tpu_torch.protocol.nxdn.encode import modulator\n"
        "from dsdneo_tpu_torch.protocol.p25.encode import c4fm_clean\n"
        "for kind, cls, sps, mod in (\n"
        "        ('p25', ccbatch.BatchedP25ControlPipeline, 10, "
        "lambda d, s: c4fm_clean(d, s)),\n"
        "        ('dmr', ccbatch.BatchedDmrControlPipeline, 10, dmr_fm_iq),\n"
        "        ('nxdn48', ccbatch.BatchedNxdnControlPipeline, 20, "
        "modulator('nxdn48'))):\n"
        "    t = params.load_cc(kind, 'cpu')\n"
        "    tv = t.test_vector()\n"
        "    x = vector_block(tv, (3,), (1,), 1500 * sps, sps=sps, "
        "modulate=mod, lead_dibits=tv['lead'])\n"
        "    p = cls(1, device='cpu', tables=t)\n"
        "    assert p.decode_block_events(x) >= 4, kind\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dsdneo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_event_pipelines_run_without_the_jax_package():
    """Decode a C=1 block of D-STAR (K6's plain version on the way) and of
    M17 (K5's) on the CPU: no module of the JAX package, and no jax, is
    ever loaded."""
    code = (
        "import sys\n"
        "from dsdneo_tpu_torch import params\n"
        "from dsdneo_tpu_torch.engine.dstarbatch import BatchedDstarPipeline\n"
        "from dsdneo_tpu_torch.engine.m17batch import "
        "BatchedM17VoicePipeline\n"
        "from dsdneo_tpu_torch.protocol.dmr.encode import vector_block\n"
        "from dsdneo_tpu_torch.protocol.dstar import encode as de\n"
        "from dsdneo_tpu_torch.protocol.m17 import encode as me\n"
        "for kind, cls, mod, n in (('dstar', BatchedDstarPipeline, de.fm_iq, "
        "3), ('m17', BatchedM17VoicePipeline, me.fm_iq, 10)):\n"
        "    t = params.load_event(kind, 'cpu')\n"
        "    tv = t.test_vector()\n"
        "    x = vector_block(tv, (3,), (1,), 72000, modulate=mod, "
        "lead_dibits=tv['lead'])\n"
        "    p = cls(1, device='cpu', tables=t)\n"
        "    assert p.decode_block_events(x) >= n, kind\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dsdneo_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_event_loaders_default_to_the_card():
    """``params.load_event`` and the two event pipelines with no device
    run on the card, and raise where there is none."""
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.engine.dstarbatch import BatchedDstarPipeline
    from dsdneo_tpu_torch.engine.m17batch import BatchedM17VoicePipeline
    if torch.cuda.is_available():
        assert params.load_event("m17").golay_cb.is_cuda
        assert BatchedDstarPipeline(1).taps.is_cuda
        assert BatchedM17VoicePipeline(1).taps.is_cuda
    else:
        for make in (lambda: params.load_event("dstar"),
                     lambda: BatchedDstarPipeline(1),
                     lambda: BatchedM17VoicePipeline(1)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()


def test_nid_codebook_equals_jax_package():
    """The port expands the BCH(63,16) codebook from its own generator
    polynomial; it equals the JAX package's, word for word."""
    from dsdneo_tpu.fec.blockcodes import bch_63_16
    from dsdneo_tpu_torch import params
    got = params.bch_63_16_codebook()
    want = bch_63_16().codebook
    assert got.dtype == np.uint8 and got.shape == (65536, 63)
    np.testing.assert_array_equal(got, want)


def test_load_defaults_to_the_card():
    """``params.load()`` with no device runs on the card, and raises
    where there is none; it never picks the CPU itself."""
    from dsdneo_tpu_torch import params
    if torch.cuda.is_available():
        assert params.load().taps.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            params.load()


def test_from_numpy_of_jax_arrays_equals_loaded(exported):
    """The tables built straight from the JAX package and the npz give
    the port the same tensors."""
    from dsdneo_tpu_torch import params
    a = params.from_numpy(exported, "cpu")
    b = params.load("cpu")
    for name, v in vars(a).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(b, name)), name
    # the NID codebook the port builds is the JAX pipeline's
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    pm = BatchedP25VoicePipeline(1).bch.pm
    np.testing.assert_array_equal(a.bch_pm.numpy(), pm)


def test_state_from_numpy_layout():
    from dsdneo_tpu_torch import params
    C = 3
    pred = (np.ones((C, 56), np.float32), np.full(C, 9, np.int32))
    synth = (np.zeros(C, np.float32), np.zeros(C, np.float32),
             np.zeros((C, 56), np.float32))
    rep = (np.zeros(C, np.float32), np.zeros((C, 56), np.float32),
           np.zeros((C, 56), np.float32), np.zeros(C, np.int32),
           np.zeros(C, np.float32))
    p, s, r = params.state_from_numpy(pred, synth, rep, "cpu")
    assert p[0].dtype == torch.float32 and p[1].dtype == torch.int32
    assert [t.shape for t in s] == [(C,), (C,), (C, 56)]
    assert r[3].dtype == torch.int32 and r[4].dtype == torch.float32
    assert params.state_from_numpy(pred, synth, None, "cpu")[2] is None
    # an AMBE pipeline has no prediction carry
    p, s, r = params.state_from_numpy(None, synth, rep, "cpu")
    assert p is None and len(s) == 3 and len(r) == 5
