"""Constant tables and per-channel carries of the P25p1 voice path.

The system runs no model: its "weights" are the constant tables below,
which ``tools/export_torch_tables.py`` builds from the JAX package's own
functions into ``data/p25p1_tables.npz``, and its state is the
per-channel carry of the voice decoder (prediction, synthesis and
frame-repeat).  :func:`from_numpy` carries the tables across onto a
device; :func:`state_from_numpy` carries a JAX pipeline's three carries
across, so a block decoded by the JAX package can continue in the port.

The BCH(63,16) NID codebook (65,536 words) is built at load time from
the jax-free ``dsdneo_tpu.fec.blockcodes`` instead of being stored.
"""

from __future__ import annotations

import os

import numpy as np
import torch

TABLES_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "data", "p25p1_tables.npz")

MAX_L = 56              # harmonics per frame (vocoder.imbe.MAX_L)
L_MIN = 9               # fewest harmonics; stacked tables index L - L_MIN
N_BINS = 79             # unvoiced noise grid bins (vocoder.synth)
# largest temporary a chunked step materializes (NID and ECC score
# tiles, per-frame table gathers, one plane of the synthesis bank)
TILE_BYTES = 256 << 20
TV_PREFIX = "tv_"       # test-vector arrays in the npz


class P25Tables:
    """Every constant of the P25p1 voice path as tensors on ``device``.

    Host-side code (the LDU picker, shape bookkeeping) reads the numpy
    originals kept in ``np``; device code reads the tensor attributes.
    """

    def __init__(self, tables: dict[str, np.ndarray], device):
        from dsdneo_tpu.fec import blockcodes

        dev = torch.device(device)
        self.np = {k: np.asarray(v) for k, v in tables.items()}
        t = self.np

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        def i64(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        def u8(a):
            return torch.as_tensor(np.asarray(a, np.uint8), device=dev)

        # front end
        self.taps = f32(t["taps"])
        self.symbol_rate = float(t["symbol_rate"])
        self.four_level = bool(t["four_level"])
        self.sync_levels = f32(t["sync_levels"])               # [P, 24]
        self.sync_inverted = tuple(bool(x) for x in t["sync_inverted"])
        self.sync_len = int(t["sync_levels"].shape[1])
        # NID BCH(63,16): ±1 codebook, [65536, 63]
        self.bch_pm = f32(blockcodes.bch_63_16().pm)

        # IMBE voice-frame ECC
        self.ecc_gather = i64(t["ecc_gather"].reshape(-1))      # [184]
        self.ecc_pn = u8(t["ecc_pn"])                          # [4096, 114]
        self.ecc_seed_of_msg = i64(t["ecc_seed_of_msg"])
        self.ecc_param_g = u8(t["ecc_param_g"])                # [4096, 12]
        self.ecc_param_h = u8(t["ecc_param_h"])                # [2048, 11]
        self.golay_cb = u8(t["golay_codebook"])                # [4096, 23]
        self.golay_pm = f32(1.0 - 2.0 * t["golay_codebook"])
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

        # PCM wire
        self.adpcm_step = i32(t["adpcm_step"])
        self.adpcm_index = i32(t["adpcm_index"])

        # synthesis noise grid; the per-bin phase offset is the JAX
        # synth's own f64 expression, cast to f32 as it casts it
        self.synth_bin_w = f32(t["synth_bin_w"])               # [79]
        self.synth_bin_cos = f32(t["synth_bin_cos"])           # [79, 160]
        self.synth_bin_sin = f32(t["synth_bin_sin"])
        kk = np.arange(N_BINS)
        self.synth_bin_l = i64(kk % MAX_L)
        self.synth_phi_off = f32(
            (2.399963 * (kk // MAX_L) * (kk + 3)).astype(np.float32))

    def test_vector(self) -> dict[str, np.ndarray]:
        """The synthesized 16-LDU stream and its expected IMBE bits."""
        return {k[len(TV_PREFIX):]: v for k, v in self.np.items()
                if k.startswith(TV_PREFIX)}


def from_numpy(tables: dict[str, np.ndarray], device) -> P25Tables:
    """numpy tables (the npz, or arrays built by the JAX package) →
    the port's tensors on ``device``."""
    return P25Tables(tables, device)


def load(device) -> P25Tables:
    """The checked-in ``data/p25p1_tables.npz`` on ``device``."""
    with np.load(TABLES_NPZ) as z:
        return from_numpy({k: z[k] for k in z.files}, device)


def state_from_numpy(pred, synth, rep, device):
    """The JAX pipeline's three device carries, fetched with
    ``np.asarray`` → the port's carries on ``device``:

      - ``pred``  = (prev_logm [C, 56] f32, prev_L [C] i32)
      - ``synth`` = (theta [C], w [C], amps [C, 56]) f32
      - ``rep``   = (w0 [C], voiced [C, 56], amps [C, 56], reps [C] i32,
                     valid [C]) — or None for a fresh repeat carry

    Returns (pred, synth, rep) as tuples of tensors, in the layout
    ``BatchedP25VoicePipeline`` keeps them."""
    dev = torch.device(device)

    def conv(a):
        a = np.asarray(a)
        dt = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        return torch.as_tensor(a.astype(dt), device=dev)

    pred_t = tuple(conv(a) for a in pred)
    synth_t = tuple(conv(a) for a in synth)
    rep_t = None if rep is None else tuple(conv(a) for a in rep)
    return pred_t, synth_t, rep_t
