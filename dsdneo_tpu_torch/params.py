"""Constant tables and per-channel carries of the voice paths.

The system runs no model: its "weights" are the constant tables below,
which ``tools/export_torch_tables.py`` builds from the JAX package's own
functions into ``data/p25p1_tables.npz`` (P25 Phase 1),
``data/dmr_tables.npz`` (DMR and the AMBE core),
``data/tdma_tables.npz`` (the front ends and host tables of X2-TDMA,
P25 Phase 2 and NXDN), ``data/cc_tables.npz`` (the control-channel
monitors' FEC, CRC and gather tables) and ``data/event_tables.npz`` (the
D-STAR AMBE ECC and the M17 LICH code, and the two event streams) and
``data/burst_tables.npz`` (the YSF, dPMR and EDACS streams), and
its state is the per-channel carry of the voice decoder (prediction,
synthesis and frame-repeat).  :func:`from_numpy`, :func:`dmr_from_numpy`,
:func:`tdma_from_numpy`, :func:`cc_from_numpy` and
:func:`event_from_numpy` and :func:`burst_from_numpy` carry the tables
across onto a device;
:func:`state_from_numpy` carries a JAX
pipeline's carries across, so a block decoded by the JAX package can
continue in the port.

The BCH(63,16) NID codebook (65,536 words) is expanded at load time from
its generator polynomial (:func:`bch_63_16_codebook`) instead of being
stored.  Nothing here imports the JAX package.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from dsdneo_tpu_torch.device import require_cuda

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TABLES_NPZ = os.path.join(_DATA, "p25p1_tables.npz")
DMR_TABLES_NPZ = os.path.join(_DATA, "dmr_tables.npz")
TDMA_TABLES_NPZ = os.path.join(_DATA, "tdma_tables.npz")
CC_TABLES_NPZ = os.path.join(_DATA, "cc_tables.npz")
EVENT_TABLES_NPZ = os.path.join(_DATA, "event_tables.npz")
BURST_TABLES_NPZ = os.path.join(_DATA, "burst_tables.npz")
SERIAL_TABLES_NPZ = os.path.join(_DATA, "serial_tables.npz")
FLEET_TABLES_NPZ = os.path.join(_DATA, "fleet_tables.npz")

MAX_L = 56              # harmonics per frame (vocoder.imbe.MAX_L)
L_MIN = 9               # fewest harmonics; stacked tables index L - L_MIN
N_BINS = 79             # unvoiced noise grid bins (vocoder.synth)
# largest temporary a chunked step materializes (NID and ECC score
# tiles, per-frame table gathers, one plane of the synthesis bank)
TILE_BYTES = 256 << 20
TV_PREFIX = "tv_"       # test-vector arrays in the npz
# generator polynomial of the P25 NID code BCH(63,16,23), bit i the
# coefficient of x^i: the product of the distinct minimal polynomials of
# α^1..α^22 in GF(64) = GF(2)[x]/(x^6 + x + 1), degree 47
BCH_63_16_GEN = 0xCD930BDD3B2B


def _poly_mod(a: int, m: int) -> int:
    """Remainder of a(x) / m(x) in GF(2)[x], polynomials packed as ints."""
    dm = m.bit_length() - 1
    while a.bit_length() - 1 >= dm:
        a ^= m << (a.bit_length() - 1 - dm)
    return a


def bch_63_16_codebook() -> np.ndarray:
    """All 2^16 codewords of the systematic BCH(63,16) NID code,
    ``[65536, 63]`` uint8: the 16 message bits (NAC ‖ DUID) msb first,
    then the 47 parity bits of m(x)·x^47 mod g(x), msb first."""
    n, k = 63, 16
    nk = n - k
    basis = np.zeros((k, nk), dtype=np.uint8)
    for i in range(k):
        rem = _poly_mod(1 << (k - 1 - i + nk), BCH_63_16_GEN)
        basis[i] = [(rem >> (nk - 1 - j)) & 1 for j in range(nk)]
    msgs = ((np.arange(1 << k, dtype=np.uint32)[:, None]
             >> np.arange(k - 1, -1, -1, dtype=np.uint32)[None, :]) & 1
            ).astype(np.uint8)
    parity = (msgs @ basis) & 1
    return np.concatenate([msgs, parity], axis=1)


SYNTH_KEYS = ("synth_bin_w", "synth_bin_cos", "synth_bin_sin")


def _synth_tensors(t: dict[str, np.ndarray], device) -> dict:
    """The synthesis noise grid on ``device``: the bins' frequencies
    ``[79]``, their cosine and sine bases ``[79, 160]``, each bin's
    harmonic slot and its phase offset (the JAX synth's own f64
    expression, cast to f32 as it casts it)."""
    kk = np.arange(N_BINS)
    arrays = {k: np.asarray(t[k], np.float32) for k in SYNTH_KEYS}
    arrays["synth_phi_off"] = (2.399963 * (kk // MAX_L)
                               * (kk + 3)).astype(np.float32)
    out = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    out["synth_bin_l"] = torch.as_tensor(kk % MAX_L, dtype=torch.int64,
                                         device=device)
    return out


class _VoiceTables:
    """What the table sets share: the numpy originals in ``np`` (host-side
    code reads them), the front end's constants, the PCM wire and
    synthesis tables as tensors on ``device``, and the test vector."""

    def __init__(self, tables: dict[str, np.ndarray], device):
        self._dev = torch.device(device)
        self.np = {k: np.asarray(v) for k, v in tables.items()}
        t = self.np

        # front end
        self.taps = self.f32(t["taps"])
        self.symbol_rate = float(t["symbol_rate"])
        self.four_level = bool(t["four_level"])
        self.sync_levels = self.f32(t["sync_levels"])          # [P, 24]
        self.sync_inverted = tuple(bool(x) for x in t["sync_inverted"])
        self.sync_len = int(t["sync_levels"].shape[1])
        self.golay_cb = self.u8(t["golay_codebook"])           # [4096, 23]
        self.golay_pm = self.f32(1.0 - 2.0 * t["golay_codebook"])

        # PCM wire
        self.adpcm_step = self.i32(t["adpcm_step"])
        self.adpcm_index = self.i32(t["adpcm_index"])

        # synthesis noise grid
        vars(self).update(_synth_tensors(t, self._dev))

    def _as(self, a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=self._dev)

    def f32(self, a):
        return self._as(a, np.float32)

    def i64(self, a):
        return self._as(a, np.int64)

    def i32(self, a):
        return self._as(a, np.int32)

    def u8(self, a):
        return self._as(a, np.uint8)

    def test_vector(self) -> dict[str, np.ndarray]:
        """The synthesized stream of the npz and its expected voice
        bits (the ``tv_`` arrays, without the prefix)."""
        return {k[len(TV_PREFIX):]: v for k, v in self.np.items()
                if k.startswith(TV_PREFIX)}


class P25Tables(_VoiceTables):
    """Every constant of the P25p1 voice path as tensors on ``device``.

    Host-side code (the LDU picker, shape bookkeeping) reads the numpy
    originals kept in ``np``; device code reads the tensor attributes.
    """

    def __init__(self, tables: dict[str, np.ndarray], device):
        super().__init__(tables, device)
        t = self.np
        f32, i64, u8 = self.f32, self.i64, self.u8

        # NID BCH(63,16): ±1 codebook, [65536, 63]
        self.bch_pm = f32(1.0 - 2.0 * bch_63_16_codebook())

        # IMBE voice-frame ECC
        self.ecc_gather = i64(t["ecc_gather"].reshape(-1))      # [184]
        self.ecc_pn = u8(t["ecc_pn"])                          # [4096, 114]
        self.ecc_seed_of_msg = i64(t["ecc_seed_of_msg"])
        self.ecc_param_g = u8(t["ecc_param_g"])                # [4096, 12]
        self.ecc_param_h = u8(t["ecc_param_h"])                # [2048, 11]
        self.h15_cb = u8(t["h15_codebook"])                    # [2048, 15]
        self.h15_pm = f32(1.0 - 2.0 * t["h15_codebook"])

        # IMBE dequantization (stacked per-L tables)
        self.dq_pos = i64(t["dq_pos"])                         # [48, 70]
        self.dq_w = f32(t["dq_w"])                             # [48, 70, 55]
        self.dq_steps = f32(t["dq_steps"])                     # [48, 55]
        self.dq_offs = f32(t["dq_offs"])
        self.dq_a = f32(t["dq_a"])                             # [48, 56, 56]
        self.gain_pos = i64(t["gain_pos"])
        self.b0_hi_pos = i64(t["b0_hi_pos"])
        self.b0_lo_pos = tuple(int(x) for x in t["b0_lo_pos"])
        self.voicing_start = int(t["voicing_start"])
        self.gain_min = float(t["gain_min"])
        self.gain_step = float(t["gain_step"])
        self.pred_decay = float(t["pred_decay"])
        self.imbe_amp_scale = float(t["imbe_amp_scale"])
        self.tone_b0_min = int(t["tone_b0_min"])
        self.tone_b0_max = int(t["tone_b0_max"])


class DmrTables(_VoiceTables):
    """Every constant of the DMR voice path and the AMBE core as tensors
    on ``device``."""

    def __init__(self, tables: dict[str, np.ndarray], device):
        super().__init__(tables, device)
        t = self.np
        # EMB gate: QR(16,7,6), [128, 16]
        self.qr_cb = self.u8(t["qr_codebook"])
        self.qr_pm = self.f32(1.0 - 2.0 * t["qr_codebook"])
        # AMBE voice-frame ECC
        self.ambe_gather = self.i64(t["ambe_gather"].reshape(-1))  # [96]
        self.ambe_pn = self.u8(t["ambe_pn"])                   # [4096, 23]
        self.ambe_parity = self.u8(t["ambe_parity"])           # [4096]
        self.ambe_param = self.u8(t["ambe_param"])             # [4096, 12]
        # AMBE dequantization (stacked per-L tables)
        self.ambe_w = self.f32(t["ambe_w"])                    # [48, 31, 56]
        self.ambe_c = self.f32(t["ambe_c"])                    # [48, 56]
        self.ambe_assigned = self.f32(t["ambe_assigned"])


class TdmaTables(DmrTables):
    """The AMBE core of ``DmrTables`` with the front end of ``mode``,
    one of ``x2tdma``, ``p25p2``, ``nxdn48``, ``nxdn96`` (taps, symbol
    rate, sync rows), and the host tables of P25p2 and NXDN in ``np``."""

    def __init__(self, tables: dict[str, np.ndarray], mode: str, device):
        super().__init__(tables, device)
        self.mode = mode


# the sync rows and the test vector of each mode in tdma_tables.npz
_TDMA_GROUPS = {"x2tdma": ("x2tdma", "x2"), "p25p2": ("p25p2", "p2"),
                "nxdn48": ("nxdn", "nxdn"), "nxdn96": ("nxdn", "nxdn")}
_FRONT_KEYS = ("taps", "symbol_rate", "four_level", "sync_levels",
               "sync_inverted")


def _read_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _device(device):
    """The caller's device, or the card (raises when there is none)."""
    return require_cuda() if device is None else device


def from_numpy(tables: dict[str, np.ndarray], device) -> P25Tables:
    """numpy tables (the npz, or arrays built by the JAX package) →
    the port's tensors on ``device``."""
    return P25Tables(tables, device)


def load(device=None) -> P25Tables:
    """The checked-in ``data/p25p1_tables.npz`` on ``device``: the card
    when none is given (raises when there is no card)."""
    return from_numpy(_read_npz(TABLES_NPZ), _device(device))


_SYNTH: dict[str, SimpleNamespace] = {}


def load_synth(device) -> SimpleNamespace:
    """The synthesis noise grid of ``data/p25p1_tables.npz`` on
    ``device`` (kept once per device): what ``vocoder.synth.synthesize``
    needs of the tables, without the voice path's other tables."""
    dev = torch.device(device)
    key = str(dev)
    if key not in _SYNTH:
        with np.load(TABLES_NPZ) as z:
            _SYNTH[key] = SimpleNamespace(**_synth_tensors(
                {k: z[k] for k in SYNTH_KEYS}, dev))
    return _SYNTH[key]


def dmr_from_numpy(tables: dict[str, np.ndarray], device) -> DmrTables:
    """numpy tables (the npz, or arrays built by the JAX package) →
    the port's DMR / AMBE tensors on ``device``."""
    return DmrTables(tables, device)


def load_dmr(device=None) -> DmrTables:
    """The checked-in ``data/dmr_tables.npz`` on ``device``: the card
    when none is given (raises when there is no card)."""
    return dmr_from_numpy(_read_npz(DMR_TABLES_NPZ), _device(device))


def tdma_from_numpy(dmr: dict[str, np.ndarray],
                    tdma: dict[str, np.ndarray], mode: str,
                    device) -> TdmaTables:
    """numpy tables (the two npz files, or arrays built by the JAX
    package) → the tensors of ``mode``'s voice path on ``device``: the
    AMBE core of ``dmr``, the front end, host tables and test vector of
    ``mode`` from ``tdma``."""
    from dsdneo_tpu_torch.engine.modes import MODES
    if mode not in _TDMA_GROUPS:
        raise ValueError(f"unknown TDMA mode {mode!r}")
    sync, tv = _TDMA_GROUPS[mode]
    m = MODES[mode]
    t = {k: v for k, v in dmr.items()
         if not k.startswith(TV_PREFIX) and k not in _FRONT_KEYS}
    t.update((k, v) for k, v in tdma.items()
             if not k.startswith(("taps_", "rate_", "sync_"))
             and "_tv_" not in k)
    t.update(taps=tdma[f"taps_{m.lpf_profile}"],
             symbol_rate=tdma[f"rate_{mode}"],
             four_level=np.bool_(m.four_level),
             sync_levels=tdma[f"sync_{sync}"],
             sync_inverted=tdma[f"sync_{sync}_inverted"])
    t.update((TV_PREFIX + k[len(tv) + 4:], v) for k, v in tdma.items()
             if k.startswith(f"{tv}_tv_"))
    return TdmaTables(t, mode, device)


def load_tdma(mode: str, device=None) -> TdmaTables:
    """The checked-in ``data/dmr_tables.npz`` and ``data/tdma_tables.npz``
    as ``mode``'s tables on ``device``: the card when none is given
    (raises when there is no card)."""
    return tdma_from_numpy(_read_npz(DMR_TABLES_NPZ),
                           _read_npz(TDMA_TABLES_NPZ), mode,
                           _device(device))


class CcTables:
    """The constants of one control-channel monitor as tensors on the
    front end's device: ``kind`` is ``p25`` (C4FM or CQPSK), ``dmr``, ``nxdn48``
    or ``nxdn96``.  ``front`` holds the tables of the voice path whose
    front end the monitor shares (``P25Tables``, ``DmrTables`` or
    ``TdmaTables``); the DMR monitor correlates its own sync rows
    (``+DMR BS data``, ``+DMR BS voice``).  The numpy arrays of
    ``cc_tables.npz`` stay in ``np``."""

    KINDS = ("p25", "dmr", "nxdn48", "nxdn96")

    def __init__(self, cc: dict[str, np.ndarray], front: _VoiceTables,
                 kind: str):
        if kind not in self.KINDS:
            raise ValueError(f"unknown control-channel kind {kind!r}")
        self.kind = kind
        self.front = front
        self.np = {k: np.asarray(v) for k, v in cc.items()}
        t = self.np
        as_ = front._as
        i64 = front.i64
        f32 = front.f32
        u8 = front.u8
        # P25 TSDU: the three trellis blocks' dibit offsets from the sync
        # start, the CRC16 contribution rows of the first 80 bits
        self.tsdu_offsets = i64(t["tsdu_offsets"])             # [3, 98]
        self.crc16_contrib = f32(t["crc16_contrib80"])         # [80, 16]
        # DMR CSBK: BPTC(196,96) gather and row/column codebooks,
        # Golay(20,8) slot type, burst geometry, sync rows
        self.bptc_gather = i64(t["bptc_gather"].reshape(-1))   # [195]
        self.h15_cb = u8(t["h15_codebook"])
        self.h15_pm = f32(1.0 - 2.0 * t["h15_codebook"])
        self.h13_cb = u8(t["h13_codebook"])
        self.h13_pm = f32(1.0 - 2.0 * t["h13_codebook"])
        self.golay20_cb = u8(t["golay20_codebook"])
        self.golay20_pm = f32(1.0 - 2.0 * t["golay20_codebook"])
        self.dmr_st_offs = i64(t["dmr_st_offs"])
        self.dmr_payload_offs = i64(t["dmr_payload_offs"])
        self.sync_levels = f32(t["dmr_cc_sync_levels"])        # [2, 24]
        # NXDN CAC: payload gather and descramble, depermute/depuncture
        # into the 350 Viterbi symbols and their weights, the affine
        # CRC16-CAC screen
        self.cac_offs = i64(t["cac_offs"])                     # [150]
        self.cac_flips = u8(t["cac_flips"])
        self.cac_src_idx = i64(t["cac_src_idx"])               # [350]
        self.cac_wt = f32(t["cac_wt"])
        self.cac_a_bits = as_(t["cac_a_bits"], np.int32)
        self.cac_crc_tab = f32(t["cac_crc_tab"])               # [171, 16]

    def test_vector(self) -> dict[str, np.ndarray]:
        """The kind's stream, payloads and JAX event lines (the
        ``<kind>_tv_`` arrays, without the prefix)."""
        pre = ("nxdn" if self.kind.startswith("nxdn") else self.kind) + "_tv_"
        return {k[len(pre):]: v for k, v in self.np.items()
                if k.startswith(pre)}


def cc_from_numpy(cc: dict[str, np.ndarray], front: _VoiceTables,
                  kind: str) -> CcTables:
    """numpy control-channel tables (the npz, or arrays built by the JAX
    package) and the front end's tables → ``CcTables`` on the front
    end's device."""
    return CcTables(cc, front, kind)


def load_cc(kind: str, device=None) -> CcTables:
    """The checked-in ``data/cc_tables.npz`` and the tables of the front
    end of ``kind`` (``p25``: ``load``; ``dmr``: ``load_dmr``;
    ``nxdn48`` / ``nxdn96``: ``load_tdma``) on ``device``: the card when
    none is given (raises when there is no card)."""
    if kind not in CcTables.KINDS:
        raise ValueError(f"unknown control-channel kind {kind!r}")
    device = _device(device)
    front = (load(device) if kind == "p25" else load_dmr(device)
             if kind == "dmr" else load_tdma(kind, device))
    return cc_from_numpy(_read_npz(CC_TABLES_NPZ), front, kind)


class EventTables:
    """The constants of one event pipeline as tensors on ``device``:
    ``kind`` is ``dstar`` (the Golay(23,12) codebook and the D-STAR AMBE
    ECC's row positions, PN rows, parities and messages) or ``m17`` (the
    Golay(24,12) codebook of the LICH).  The numpy arrays of
    ``event_tables.npz`` stay in ``np``."""

    KINDS = ("dstar", "m17")

    def __init__(self, tables: dict[str, np.ndarray], kind: str, device):
        if kind not in self.KINDS:
            raise ValueError(f"unknown event pipeline {kind!r}")
        self.kind = kind
        self.device = torch.device(device)
        self.np = {k: np.asarray(v) for k, v in tables.items()}
        t = self.np

        def on(a, dt):
            return torch.as_tensor(np.asarray(a, dt), device=self.device)

        if kind == "dstar":
            self.golay_cb = on(t["golay23_codebook"], np.uint8)
            self.golay_pm = on(1.0 - 2.0 * t["golay23_codebook"],
                               np.float32)
            self.dstar_r0, self.dstar_r1, self.dstar_r2, self.dstar_r3 = (
                on(t[f"dstar_ambe_r{i}"], np.int64) for i in range(4))
            self.dstar_pn = on(t["dstar_ambe_pn"], np.uint8)   # [4096, 23]
            self.dstar_parity = on(t["dstar_ambe_parity"], np.uint8)
            self.dstar_param = on(t["dstar_ambe_param"], np.uint8)
        else:
            self.golay_cb = on(t["golay24_codebook"], np.uint8)
            self.golay_pm = on(1.0 - 2.0 * t["golay24_codebook"],
                               np.float32)

    def test_vector(self) -> dict[str, np.ndarray]:
        """The kind's stream and what it carries (the ``<kind>_tv_``
        arrays, without the prefix)."""
        pre = self.kind + "_tv_"
        return {k[len(pre):]: v for k, v in self.np.items()
                if k.startswith(pre)}


def event_from_numpy(tables: dict[str, np.ndarray], kind: str,
                     device) -> EventTables:
    """numpy event tables (the npz, or arrays built by the JAX package)
    → ``EventTables`` of ``kind`` on ``device``."""
    return EventTables(tables, kind, device)


def load_event(kind: str, device=None) -> EventTables:
    """The checked-in ``data/event_tables.npz`` as ``kind``'s tables
    (``dstar`` or ``m17``) on ``device``: the card when none is given
    (raises when there is no card)."""
    if kind not in EventTables.KINDS:
        raise ValueError(f"unknown event pipeline {kind!r}")
    return event_from_numpy(_read_npz(EVENT_TABLES_NPZ), kind,
                            _device(device))


class BurstTables:
    """The tables of one path behind the gated front end that the event
    tables do not hold: ``kind`` is ``ysf`` or ``dpmr`` (voice: ``ambe``
    is the AMBE core of ``DmrTables`` on ``device``) or ``edacs`` (the
    control-channel monitor needs no tables: ``ambe`` is None, the stream
    is all).  The kind's stream of ``burst_tables.npz`` stays in
    ``np``."""

    KINDS = ("ysf", "dpmr", "edacs")

    def __init__(self, dmr: dict[str, np.ndarray] | None,
                 burst: dict[str, np.ndarray], kind: str, device):
        if kind not in self.KINDS:
            raise ValueError(f"unknown burst path {kind!r}")
        self.kind = kind
        self.device = torch.device(device)
        pre = kind + "_tv_"
        self.np = {k: np.asarray(v) for k, v in burst.items()
                   if k.startswith(pre)}
        self.ambe = (None if kind == "edacs" else
                     DmrTables({k: v for k, v in dmr.items()
                                if not k.startswith(TV_PREFIX)}, device))

    def test_vector(self) -> dict[str, np.ndarray]:
        """The kind's stream and what it carries (the ``<kind>_tv_``
        arrays, without the prefix)."""
        pre = self.kind + "_tv_"
        return {k[len(pre):]: v for k, v in self.np.items()}


def burst_from_numpy(dmr: dict[str, np.ndarray] | None,
                     burst: dict[str, np.ndarray], kind: str,
                     device) -> BurstTables:
    """numpy tables (the two npz files, or arrays built by the JAX
    package) → ``BurstTables`` of ``kind`` on ``device``: the AMBE core
    of ``dmr`` (voice kinds) and the kind's stream of ``burst``."""
    return BurstTables(dmr, burst, kind, device)


def load_burst(kind: str, device=None) -> BurstTables:
    """The checked-in ``data/burst_tables.npz`` (and, for ``ysf`` and
    ``dpmr``, the AMBE core of ``data/dmr_tables.npz``) as ``kind``'s
    tables on ``device``: the card when none is given (raises when there
    is no card)."""
    if kind not in BurstTables.KINDS:
        raise ValueError(f"unknown burst path {kind!r}")
    device = _device(device)
    dmr = None if kind == "edacs" else _read_npz(DMR_TABLES_NPZ)
    return burst_from_numpy(dmr, _read_npz(BURST_TABLES_NPZ), kind, device)


def state_from_numpy(pred, synth, rep, device):
    """The JAX pipeline's three device carries, fetched with
    ``np.asarray`` → the port's carries on ``device``:

      - ``pred``  = (prev_logm [C, 56] f32, prev_L [C] i32) — or None
                    for a pipeline with no prediction (AMBE)
      - ``synth`` = (theta [C], w [C], amps [C, 56]) f32
      - ``rep``   = (w0 [C], voiced [C, 56], amps [C, 56], reps [C] i32,
                     valid [C]) — or None for a fresh repeat carry

    Returns (pred, synth, rep) as tuples of tensors, in the layout
    ``BatchedP25VoicePipeline`` keeps them; ``(synth, rep)`` is the
    ``_vstate`` of ``BatchedDmrVoicePipeline``."""
    dev = torch.device(device)

    def conv(a):
        a = np.asarray(a)
        dt = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        return torch.as_tensor(a.astype(dt), device=dev)

    pred_t = None if pred is None else tuple(conv(a) for a in pred)
    synth_t = tuple(conv(a) for a in synth)
    rep_t = None if rep is None else tuple(conv(a) for a in rep)
    return pred_t, synth_t, rep_t
