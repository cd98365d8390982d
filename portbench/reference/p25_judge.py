"""The comparison that decides ``correct`` for the P25 voice cells.

For each sampled block the program's outputs (the frames it accepted,
read from ``pipe.last_frames`` after the decode, its PCM as the user
gets it, and the voice carry it hands the next block) are held to the
reference's on the same input from the same carry in:

- ``frames_diff``: frames accepted on one side only, or with other IMBE
  bits or error counts (front end, sync, NID, pick and FEC); exact, but
  for frames the reference flags as marginal (a dibit within
  ``p25_chain.MARGINAL`` of a slicer threshold), which two sound float32
  front ends may slice either way;
- ``pcm_rms_rel``: the RMS of the PCM's difference over the RMS of the
  reference's PCM, over every sampled block (synthesis, K2, K3 and the
  host expand; in band cells the channelizer through them);
- ``carry_rel``: the largest difference between the carries out, each
  tensor against its own largest magnitude (phases modulo 2π): the
  stage the comparison otherwise takes from the program;
- ``vector_frames_off`` (where the configuration asks for it): of every
  keyed channel's LDUs that its block holds whole, the frames that were
  not decoded with the vector's bits, in order; exact.

Each number is printed beside its limit, which the configuration file
states (``limits``).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from portbench import compare
from portbench.reference.p25_chain import MARGINAL, P25Chain, test_vector


def frames_diff(got, want, window: float = MARGINAL) -> int:
    """Frames that differ between the program's (bits88, errs, channel,
    step) and the reference's (the same and each frame's margin; None:
    no frame), leaving out the frames whose margin is under
    ``window``."""
    def as_map(fr):
        if fr is None:
            return {}, set()
        bits, errs, fch, forder = (np.asarray(a.cpu() if
                                              isinstance(a, torch.Tensor)
                                              else a) for a in fr[:4])
        keys = [(int(c), int(t)) for c, t in zip(fch, forder)]
        flagged = ({k for k, m in zip(keys, fr[4]) if m < window}
                   if len(fr) > 4 else set())
        return ({k: (bits[i].tobytes(), int(errs[i]))
                 for i, k in enumerate(keys)}, flagged)
    (g, _), (w, marginal) = as_map(got), as_map(want)
    return sum(1 for k in (g.keys() | w.keys()) - marginal
               if g.get(k) != w.get(k))


def pcm_sums(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(Σ (got − want)², Σ want²) in float64; a shape that differs counts
    as the whole of both."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    ref = float(np.sum(want ** 2))
    if got.shape != want.shape:
        return float(np.sum(got ** 2)) + ref, ref
    return float(np.sum((got - want) ** 2)), ref


def carry_rel(got, want) -> float:
    """Largest relative difference between two carries (None: a fresh
    pipeline's zeros); the first synthesis tensor is a phase."""
    if got is None and want is None:
        return 0.0
    if got is None or want is None:
        return math.inf
    worst = 0.0
    for pi, (gp, wp) in enumerate(zip(got, want)):
        for ti, (g, w) in enumerate(zip(gp, wp)):
            g = g.detach().to("cpu", torch.float64)
            w = w.detach().to("cpu", torch.float64)
            d = (g - w).abs()
            if pi == 1 and ti == 0:
                d = torch.minimum(d, 2 * math.pi - d)
                scale = math.pi
            else:
                scale = float(w.abs().max()) if w.numel() else 0.0
            if d.numel() and float(d.max()) > 0:
                worst = max(worst, float(d.max()) / max(scale, 1e-30))
    return worst


def vector_frames_off(frames, keyed, leads, tv, n_sym: int,
                      need: int) -> int:
    """Of the frames every keyed channel's block holds whole, those not
    decoded in order with the vector's bits."""
    if frames is None:
        bits = np.zeros((0, 88), np.uint8)
        fch = forder = np.zeros(0, np.int64)
    else:
        bits, _e, fch, forder = frames[:4]
        bits = np.asarray(bits.cpu() if isinstance(bits, torch.Tensor)
                          else bits)
    off = 0
    for c, lead in zip(keyed, leads):
        k = int(np.sum(int(lead) + tv["ldu_starts"] + need < n_sym))
        want = tv["bits88"][:9 * k]
        sel = np.flatnonzero(fch == c)
        got = bits[sel[np.argsort(forder[sel], kind="stable")]]
        if got.shape[0] < want.shape[0]:
            off += want.shape[0] - got.shape[0]
            want = want[:got.shape[0]]
        off += int((got[:want.shape[0]] != want).any(-1).sum())
    return off


# margins under which the notes count the reference's frames
WINDOWS = (1e-3, 1e-4, 3e-5, 1e-5, 3e-6)


def _rms_rel(se: float, sr: float) -> float:
    return math.sqrt(se / sr) if sr else (0.0 if se == 0 else math.inf)


class P25Reference:
    """The plain chain over per-channel basebands, and the comparison.
    ``control`` computes the chain in TF32, the precision below the
    configuration's float32: the control that has to fail."""

    def __init__(self, cfg: dict, device, control: bool = False):
        self.cfg = cfg
        self.chain = P25Chain(cfg["channels"], fs=cfg["fs"], device=device,
                              tf32=control)

    def basebands(self, block):
        """The ``[C, B, 2]`` basebands the chain decodes."""
        return block

    def soft_symbols(self, block) -> torch.Tensor:
        """The chain's ``[C, T]`` soft symbols of a block."""
        x = torch.as_tensor(self.basebands(block), dtype=torch.float32,
                            device=self.chain.device)
        n_sym = int(x.shape[1] // self.chain.sps) - 2
        t = self.chain.tables
        return self.chain.frontend_step(x, t.taps, self.chain.sps, n_sym,
                                        t.four_level)[1]

    def outputs(self, sample) -> dict:
        """What the chain makes of a sample's block from its carry in:
        frames (with the marginal flags), PCM ``[C, N]`` float32 and the
        carry out."""
        fe = self.chain.frontend(self.basebands(sample.block))
        frames, wire, carry_out, _steps = self.chain.decode(
            fe, sample.kept["carry_in"])
        return {"frames": frames, "output": self.chain.expand(wire),
                "carry_out": carry_out}

    def judge(self, samples, got=None) -> tuple[dict, int, dict]:
        """(numbers, samples that fail on their own, notes) over the
        samples; ``got`` ({seq: outputs}) replaces the program's (the
        control)."""
        allow = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return self._judge(samples, got)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = allow

    def _judge(self, samples, got):
        cfg, limits = self.cfg, self.cfg["limits"]
        vec = bool(cfg.get("vector_check"))
        tv = test_vector() if vec else None
        fd = vo = n_failed = fd_all = 0
        under = dict.fromkeys((*WINDOWS, MARGINAL), 0)
        se = sr = cr = 0.0
        for s in samples:
            k = s.kept if got is None else got[s.seq]
            want = self.outputs(s)
            d = frames_diff(k["frames"], want["frames"])
            fd_all += frames_diff(k["frames"], want["frames"], 0.0)
            a, b = pcm_sums(k["output"], want["output"])
            c = carry_rel(k["carry_out"], want["carry_out"])
            one = {"frames_diff": d, "pcm_rms_rel": _rms_rel(a, b),
                   "carry_rel": c}
            if vec:
                n_sym = int(int(s.block.shape[1])
                            // (cfg["fs"] / cfg["symbol_rate"])) - 2
                one["vector_frames_off"] = vector_frames_off(
                    k["frames"], s.info.keyed, s.info.leads, tv, n_sym,
                    self.chain._ldu_need)
                vo += one["vector_frames_off"]
            if not compare.judge(one, limits)[0]:
                n_failed += 1
            fd, se, sr, cr = fd + d, se + a, sr + b, max(cr, c)
            margin = (np.zeros(0) if want["frames"] is None
                      else want["frames"][4])
            for x in under:
                under[x] += int((margin < x).sum())
            print(f"block {s.seq}: "
                  + ", ".join(f"{n} {v:.6g}" for n, v in one.items())
                  + f"; frames the reference flags marginal "
                  f"{int((margin < MARGINAL).sum())} of {margin.size}",
                  file=sys.stderr, flush=True)
        numbers = {"frames_diff": fd, "pcm_rms_rel": _rms_rel(se, sr),
                   "carry_rel": cr}
        if vec:
            numbers["vector_frames_off"] = vo
        return numbers, n_failed, {
            "frames_diff_unflagged": fd_all,
            "frames_under": {f"{x:g}": n for x, n in under.items()}}
