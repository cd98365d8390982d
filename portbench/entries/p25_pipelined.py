"""Entry driver: ``BatchedP25VoicePipeline`` over per-channel basebands.

One pipeline lives for the whole run and carries the voice state across
blocks.  The loop is the JAX bench's pipelined loop (``bench.py``'s
``_pipelined_loop`` at commit 1acf1f855b4962341c6932295300c03c25b32489):
block N+1's front end is dispatched before block N's candidates are
fetched, and block N−1's PCM is fetched last.  A block is handed off at
its ``frontend_dispatch`` call, which copies it from the host ring to
the card, and completes when its PCM is on the host as float32
``[C, N]``.

An entry (``portbench/entries/<entry>.py``, class ``Entry(cfg, device)``)
gives the harness: ``channels`` and ``block_s`` (the RF a block holds);
``run(src, rec)``, the loop of the timed window, which reports each
block to the recorder (``handoff``, ``before`` / ``after`` the call that
advances the carried state, ``done`` with the block's output on the
host) and wraps its calls into the port in ``rec.span``; ``split(block)``,
one block stage by stage; ``sample_in()`` / ``sample_out()``, what the
reference needs of the program's state around that call;
``kernel_shapes()``, the shapes the hand-written kernels ran at on the
last block; ``soft_symbols(block)``, the program's front end alone (read
by ``portbench.control``).
"""

from __future__ import annotations

import time

import torch

from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
from portbench.reference.p25_chain import read_npz


class Entry:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.device = device
        self.pipe = BatchedP25VoicePipeline(
            cfg["channels"], fs=cfg["fs"], pcm_fmt=cfg["pcm_fmt"],
            device=device)
        self.channels = cfg["channels"]
        self.block_s = cfg["block_s"]
        self.last_block = None

    def k1_shape(self, block) -> tuple[int, int]:
        """The ``[C, B]`` K1 runs at on a block of the ring."""
        return int(block.shape[0]), int(block.shape[1])

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

    def run(self, src, rec) -> None:
        """Hand off the blocks ``src.next()`` gives until it gives None,
        reporting to ``rec``."""
        pipe = self.pipe
        item = src.next()
        if item is None:
            return
        seq, blk = item
        self.last_block = blk
        rec.handoff(seq)
        with rec.span("frontend_dispatch"):
            fe = pipe.frontend_dispatch(blk)
        prev = None
        while True:
            nxt = src.next()
            if nxt is not None:
                self.last_block = nxt[1]
                rec.handoff(nxt[0])
                with rec.span("frontend_dispatch"):
                    fe_next = pipe.frontend_dispatch(nxt[1])
            with rec.span("frontend_finish"):
                f = pipe.frontend_finish(fe)
            rec.before(seq, self)
            with rec.span("pick_decode"):
                h = pipe.decode_from_frontend(f)
            rec.after(seq, self)
            if prev is not None:
                with rec.span("fetch_pcm"):
                    pcm = pipe.fetch_pcm(prev[1])
                rec.done(prev[0], pcm)
            prev = (seq, h)
            if nxt is None:
                break
            seq, fe = nxt[0], fe_next
        with rec.span("fetch_pcm"):
            pcm = pipe.fetch_pcm(prev[1])
        rec.done(prev[0], pcm)

    def split(self, blk) -> dict[str, float]:
        """One block stage by stage, each synchronized: host seconds of
        the front end (with the copy to the card and the candidates to
        the host), the pick and voice decode, and the PCM fetch."""
        pipe = self.pipe
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        f = pipe.frontend_finish(pipe.frontend_dispatch(blk))
        sync()
        t1 = time.perf_counter()
        h = pipe.decode_from_frontend(f)
        sync()
        t2 = time.perf_counter()
        pipe.fetch_pcm(h)
        t3 = time.perf_counter()
        return {"frontend": t1 - t0, "pick_decode": t2 - t1,
                "pcm_fetch": t3 - t2}

    def carry(self):
        """A copy of the pipeline's voice carry (None before the first
        decoded block)."""
        st = self.pipe.voice_state()
        if st[0] is None:
            return None
        return tuple(tuple(t.clone() for t in part) for part in st)

    def sample_in(self) -> dict:
        """The voice carry the next decode starts from."""
        return {"carry_in": self.carry()}

    def sample_out(self) -> dict:
        """A copy of what the last decode accepted, (bits88, errs, frame
        channel, frame step) or None, and the carry it hands on."""
        lf = self.pipe.last_frames
        frames = None if lf is None else (lf[0].clone(), lf[1].clone(),
                                          lf[2].copy(), lf[3].copy())
        return {"frames": frames, "carry_out": self.carry()}

    def basebands(self, block):
        """The ``[C, B, 2]`` basebands the pipeline decodes."""
        return block

    def soft_symbols(self, block) -> torch.Tensor:
        """The program's ``[C, T]`` soft symbols of a block (its front
        end alone: K1 and the symbolizer)."""
        return self.pipe.frontend(self.basebands(block))[1]
