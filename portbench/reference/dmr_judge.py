"""The comparison that decides ``correct`` for the DMR BS voice cell.

For each sampled block the program's outputs (the frames it accepted,
read from ``pipe.last_frames`` after the decode, its PCM as the user
gets it, and the (synthesis, repeat) carry it hands the next block) are
held to the reference's (``dmr_chain.DmrChain``) on the same input from
the same carry in:

- ``frames_diff``: frames accepted on one side only, or with other
  AMBE+2 ``bits49`` or error counts (front end, sync, EMB gate, pick,
  ECC); exact, but for frames the reference flags as marginal (a dibit
  within the P25 cells' ``MARGINAL`` of a slicer threshold);
- ``vector_frames_off``: of the superframes every keyed channel's block
  holds whole (``dmr_chain.expected_frames``' rule), the frames not
  decoded in order with the vector's ``bits49``;
- ``pcm_rms_rel``: the RMS of the PCM's difference over the RMS of the
  reference's PCM, over every sampled block (synthesis, K3 and the host
  expand);
- ``carry_rel``: the largest difference between the carries out, each
  tensor against its own largest magnitude (the phase modulo 2π).

Each number is printed beside its limit, which the configuration file
states (``limits``).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from portbench import compare
from portbench.reference.dmr_chain import (DmrChain, expected_frames,
                                           test_vector)
from portbench.reference.p25_chain import MARGINAL
from portbench.reference.p25_judge import (WINDOWS, _rms_rel, frames_diff,
                                           pcm_sums)


def carry_rel(got, want) -> float:
    """Largest relative difference between two (synthesis, repeat)
    carries (None: a fresh pipeline's zeros); the first synthesis tensor
    is a phase."""
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
            if pi == 0 and ti == 0:
                d = torch.minimum(d, 2 * math.pi - d)
                scale = math.pi
            else:
                scale = float(w.abs().max()) if w.numel() else 0.0
            if d.numel() and float(d.max()) > 0:
                worst = max(worst, float(d.max()) / max(scale, 1e-30))
    return worst


def vector_frames_off(frames, keyed, leads, tv, n_sym: int) -> int:
    """Of the superframes every keyed channel's block holds whole, the
    frames not decoded in order with the vector's ``bits49``."""
    if frames is None:
        bits = np.zeros((0, 49), np.uint8)
        fch = forder = np.zeros(0, np.int64)
    else:
        bits, _e, fch, forder = frames[:4]
        bits = np.asarray(bits.cpu() if isinstance(bits, torch.Tensor)
                          else bits)
        fch, forder = np.asarray(fch), np.asarray(forder)
    off = 0
    for c, lead in zip(keyed, leads):
        want = expected_frames(tv, int(lead), n_sym)[1].reshape(-1, 49)
        sel = np.flatnonzero(fch == c)
        got = bits[sel[np.argsort(forder[sel], kind="stable")]]
        if got.shape[0] < want.shape[0]:
            off += want.shape[0] - got.shape[0]
            want = want[:got.shape[0]]
        off += int((got[:want.shape[0]] != want).any(-1).sum())
    return off


class DmrReference:
    """The plain chain over per-channel basebands, and the comparison.
    ``control`` computes the chain in TF32, the precision below the
    configuration's float32: the control that has to fail."""

    def __init__(self, cfg: dict, device, control: bool = False):
        self.cfg = cfg
        self.chain = DmrChain(cfg["channels"], fs=cfg["fs"], device=device,
                              tf32=control)

    def soft_symbols(self, block) -> torch.Tensor:
        """The chain's ``[C, T]`` soft symbols of a block."""
        return self.chain.soft_symbols(block)

    def outputs(self, sample) -> dict:
        """What the chain makes of a sample's block from its carry in:
        frames (with the marginal flags), PCM ``[C, N]`` float32 and the
        carry out."""
        fe = self.chain.frontend(sample.block)
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
        fd = vo = n_failed = fd_all = n_frames = 0
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
                n_sym = int(s.block.shape[1]) // int(cfg["sps"]) - 2
                one["vector_frames_off"] = vector_frames_off(
                    k["frames"], s.info.keyed, s.info.leads, tv, n_sym)
                vo += one["vector_frames_off"]
            if not compare.judge(one, limits)[0]:
                n_failed += 1
            fd, se, sr, cr = fd + d, se + a, sr + b, max(cr, c)
            margin = (np.zeros(0) if want["frames"] is None
                      else want["frames"][4])
            n_frames += margin.size
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
            "frames_diff_unflagged": fd_all, "reference_frames": n_frames,
            "frames_under": {f"{x:g}": n for x, n in under.items()}}
