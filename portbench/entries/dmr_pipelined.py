"""Entry driver: ``BatchedDmrVoicePipeline`` over per-channel basebands.

The P25 entry's pipelined loop (``p25_pipelined.Entry``: block N+1's
front end dispatched before block N's candidates are fetched, block
N−1's PCM fetched last), its stage split, its voice carry (through the
pipeline's ``voice_state()``: here the synthesis and repeat carries) and
its sample of the frames decoded (``last_frames``: here ``bits49``,
error counts, frame channel and step) over one
``BatchedDmrVoicePipeline`` that lives for the whole run.  What differs
is the pipeline, the block's length (a whole number of symbols), the
kernels' shapes and the front end read by ``portbench.control``.
"""

from __future__ import annotations

import torch

from dsdneo_tpu_torch.engine.batched import frontend_step
from dsdneo_tpu_torch.engine.dmrbatch import BatchedDmrVoicePipeline
from portbench.entries import p25_pipelined
from portbench.harness import HarnessError
from portbench.inputs.dmr_channels import n_samples
from portbench.reference.dmr_chain import read_npz


class Entry(p25_pipelined.Entry):
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = device
        self.pipe = BatchedDmrVoicePipeline(
            cfg["channels"], fs=cfg["fs"], pcm_fmt=cfg["pcm_fmt"],
            device=device)
        if not hasattr(self.pipe, "voice_state"):
            raise HarnessError("this port's BatchedDmrVoicePipeline has no "
                               "voice_state(): the comparison cannot read "
                               "its carry")
        self.channels = cfg["channels"]
        self.block_s = n_samples(cfg) / cfg["fs"]
        self.last_block = None

    def kernel_shapes(self) -> dict:
        """K1 ``fir_disc`` (C, B, taps) and K3 ``adpcm_enc`` (rows,
        samples) on the last block: K3 encodes 160 samples a padded frame
        step of every channel."""
        if self.last_block is None:
            return {}
        ntaps = len(read_npz()["taps"])
        return {"fir_disc": (*self.k1_shape(self.last_block), ntaps),
                "adpcm_enc": (self.channels,
                              160 * int(self.pipe.last_steps or 0))}

    def soft_symbols(self, block) -> torch.Tensor:
        """The program's ``[C, T]`` soft symbols of a block (its front
        end alone: K1 and the symbolizer)."""
        pipe = self.pipe
        x = torch.as_tensor(block, dtype=torch.float32, device=self.device)
        n_sym = int(x.shape[1] // pipe.sps) - 2
        t = pipe.tables
        return frontend_step(x, t.taps, pipe.sps, n_sym, t.four_level)[1]
