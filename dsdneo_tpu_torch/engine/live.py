"""Live engine: producer → ring → streaming decoder, with a control
plane.

The port's own copy of ``dsdneo_tpu/engine/live.py``, unchanged in its
loop; it takes ``device=`` and hands it to its ``StreamDecoder`` (the
card when none is given), and its ring is the port's
``runtime.native.IngestRing``.  It rebuilds the reference's thread
model (src/io/radio/rtl_sdr_fm.cpp: producer thread fills the input ring, the demod thread
drains it blockwise, the controller thread applies retunes with purge
+ generation gates; engine.c liveScanner drives the decode loop).

The producer here is any callable that feeds CU8 bytes (a replay
pacer, a UDP PCM source, an SDR process piping to us); retunes purge
the ring (dropping stale pre-retune samples, like the reference's
purge/mute gate), journal an event into the capture writer when one is
attached, and reset the stream decoder's carry.
"""

from __future__ import annotations

import threading

import numpy as np

from dsdneo_tpu_torch.engine.stream import StreamDecoder
from dsdneo_tpu_torch.runtime import trace


class LiveEngine:
    """Ring-fed streaming decode loop with retune control."""

    def __init__(self, mode: str, fs: float = 48000.0,
                 block_s: float = 0.25, ring=None, capture_writer=None,
                 control_port: int = 0, on_event=None, trunk=None,
                 retune_mute_s: float = 0.075, scanner=None,
                 hop_s: float = 0.5, perf=None, device=None):
        from dsdneo_tpu_torch.app_control import CommandQueue, MetricsHub
        from dsdneo_tpu_torch.runtime.native import IngestRing
        self.mode = mode
        self.fs = fs
        self.trunk = trunk            # TrunkFollower (events → TrunkSM)
        self.block = int(fs * block_s)
        self.ring = ring or IngestRing()
        self.capture = capture_writer
        self.on_event = on_event
        self.decoder = StreamDecoder(mode, fs=fs, device=device)
        self.device = self.decoder.device
        self.freq_hz = 0.0
        self.retunes = 0
        self.muted = False
        self.squelch_db = -200.0      # open
        self.gain_db = 0.0
        self.ppm = 0
        self.on_ppm = None            # tuner hook (rtl_tcp set_ppm)
        # app_control boundary: frontends poll `metrics.snapshot()` and
        # enqueue into `commands`; the loop drains between blocks
        self.metrics = MetricsHub()
        self.commands = CommandQueue()
        # retune discipline (reference rtl_sdr_fm.cpp:4665 retune mute
        # window + tagged async tune completion):
        # - a mute window after each retune drops the transient samples
        #   a mid-burst retune would otherwise splice into the demod
        # - feeds carry an optional tune generation; samples produced
        #   against a stale generation are dropped before the ring
        self.retune_mute_s = retune_mute_s
        self.tune_generation = 0
        self.tune_pending = False     # cleared by first fresh feed
        self.stale_feeds = 0
        self._mute_samples = 0
        # squelch-hop (reference squelch-driven scanner hop): when the
        # squelch stays closed for hop_s, rotate the scanner
        self.scanner = scanner
        self.hop_s = hop_s
        self._squelched_s = 0.0
        # input conditioning (reference --input-volume /
        # --input-level-warn-db) + auto PPM correction hook
        self.input_volume = 1.0
        # SNR squelch (DSD_NEO_SNR_SQL_DB): decode gated on the eye SNR
        # of the previous block, alongside the power squelch
        self.snr_squelch_db = -200.0
        # DC blocker (DSD_NEO_IQ_DC_BLOCK): subtract the block mean;
        # DSD_NEO_IQ_DC_SHIFT=k upgrades it to a one-pole tracker
        # dc += (mean - dc)/2^k (the reference's shift coefficient)
        self.dc_block = False
        self.dc_shift = 0
        self._dc = 0j
        # DSD_NEO_RETUNE_DRAIN_MS: decode up to this much buffered
        # signal before the retune purge drops the rest
        self.retune_drain_s = 0.0
        self._drain_budget: int | None = None
        # DSD_NEO_OUTPUT_CLEAR_ON_RETUNE: drop undelivered audio
        self.output_clear_on_retune = False
        # fs/4 capture shift (reference +fs/4 downconvert in the widen
        # stage; DSD_NEO_DISABLE_FS4_SHIFT turns it off) and
        # DSD_NEO_COMBINE_ROT: fused widen+rotate in the native ring
        # (default) vs the two-pass host rotation
        self.fs4_shift = False
        self.combine_rot = True
        self.fs4_rot = 1               # j^{+n}: pairs with a +fs/4 tune
        self.level_warn_db = -200.0
        self.level_warnings = 0
        self.auto_ppm = None          # io.auto_ppm.AutoPpm
        self.auto_gain = None         # io.auto_gain.TunerAutogain
        # DSD_NEO_P25_AFC_STATUS_GATE: suppress auto-PPM training on
        # frames not classified as infrastructure-originated
        self.afc_status_gate = False
        # --perf-csv on the LIVE path (reference DSD_NEO_RTL_PERF_CSV,
        # rtl_perf.cpp counters): per-block ingest and decode time +
        # ring drops
        self.perf = perf
        self._perf_drops = 0
        self._stop = False
        self._thread: threading.Thread | None = None
        self._ctl = None
        if control_port:
            from dsdneo_tpu_torch.io.net import UdpControlServer
            self._ctl = UdpControlServer(self.tune, port=control_port)

    # -- control plane (the reference's controller thread) -----------------
    @property
    def fs4_offset_hz(self) -> float:
        """Hardware tune offset for the +fs/4 capture shift: the tuner
        sits fs/4 above the wanted channel (moving its DC spike out of
        the passband) and the ingest ring's fused widen+rotate
        (``j^n`` at ring rate) shifts the channel back to 0 Hz
        (reference rtl_sdr_fm.cpp capture shift;
        DSD_NEO_DISABLE_FS4_SHIFT turns the whole scheme off)."""
        return self.fs / 4.0 if self.fs4_shift else 0.0

    def tune(self, freq_hz: float) -> None:
        """Retune: journal the event, purge stale ring contents, reset
        the decode carry, open the post-retune mute window, and bump
        the tune generation (reference rtl_stream_tune_impl purge+mute,
        tagged completion rtl_sdr_fm.cpp:4665)."""
        self.freq_hz = freq_hz
        self.retunes += 1
        self.tune_generation += 1
        self.tune_pending = True
        if self.capture is not None:
            self.capture.record_event("retune",
                                      center_frequency_hz=int(freq_hz))
        if self.auto_gain is not None:
            self.auto_gain.on_retune()     # post-retune settle hold
        # DSD_NEO_RETUNE_DRAIN_MS: let the demod loop finish up to the
        # drain budget of already-buffered pre-retune samples before
        # the purge (tail audio is not cut mid-word)
        drain = int(self.fs * self.retune_drain_s)
        if drain > 0:
            self._drain_budget = drain
            return
        self._apply_retune()

    def _apply_retune(self) -> None:
        self._drain_budget = None
        self._mute_samples = int(self.fs * self.retune_mute_s)
        self.ring.purge()
        if self.output_clear_on_retune:
            # DSD_NEO_OUTPUT_CLEAR_ON_RETUNE: pending undelivered audio
            # belongs to the old carrier
            self.decoder.ctx.audio.clear()
        self.decoder = StreamDecoder(self.mode, fs=self.fs,
                                     ctx=self.decoder.ctx,
                                     device=self.device)

    # -- producer side ------------------------------------------------------
    def feed_cu8(self, data: bytes, generation: int | None = None) -> int:
        """Producer entry: raw CU8 interleaved I/Q bytes into the ring.

        ``generation`` tags the data with the tune generation it was
        produced under (read ``engine.tune_generation`` after applying
        a retune to the hardware): stale-generation samples are dropped
        before the ring, and the first fresh feed completes the pending
        tune (tagged async completion)."""
        if generation is not None and generation != self.tune_generation:
            self.stale_feeds += 1
            return 0
        if self.tune_pending and (generation is None
                                  or generation == self.tune_generation):
            self.tune_pending = False
            self.metrics.publish(tune_complete_generation=self.tune_generation)
        return self.ring.write(data)

    # -- app_control command drain ------------------------------------------
    def _drain_commands(self) -> None:
        from dsdneo_tpu_torch.app_control import AppCommand
        for qc in self.commands.drain():
            if qc.cmd == AppCommand.TUNE:
                self.tune(float(qc.payload))
            elif qc.cmd == AppCommand.SET_MODE:
                self.mode = str(qc.payload)
                self.decoder = StreamDecoder(self.mode, fs=self.fs,
                                             ctx=self.decoder.ctx,
                                             device=self.device)
            elif qc.cmd == AppCommand.TOGGLE_MUTE:
                self.muted = not self.muted
            elif qc.cmd == AppCommand.SET_SQUELCH:
                self.squelch_db = float(qc.payload)
            elif qc.cmd == AppCommand.GAIN_DELTA:
                self.gain_db += 3.0 * int(qc.payload)
                self.decoder.ctx.state.audio_gain_db = self.gain_db
            elif qc.cmd == AppCommand.TG_HOLD:
                pol = getattr(self.decoder.ctx.state, "tg_policy", None)
                if pol is not None:
                    slot, tg = qc.payload
                    pol.hold(int(slot), int(tg))
            elif qc.cmd == AppCommand.TG_RELEASE:
                pol = getattr(self.decoder.ctx.state, "tg_policy", None)
                if pol is not None:
                    pol.release_hold(int(qc.payload))
            elif qc.cmd == AppCommand.SET_PPM:
                self.ppm = int(qc.payload)
                if self.on_ppm is not None:
                    self.on_ppm(self.ppm)
            elif qc.cmd == AppCommand.STOP:
                self._stop = True

    # -- consumer loop (the reference's demod thread) -----------------------
    def run(self, max_blocks: int | None = None) -> int:
        """Drain the ring blockwise until stopped; returns blocks decoded.
        With ``perf``, the loop's spans ``live.ingest`` (the ring read)
        and ``live.decode`` (the decoder's push) fill its time columns."""
        trace.attach(self.perf)
        try:
            return self._drain(max_blocks)
        finally:
            trace.detach(self.perf)

    def _drain(self, max_blocks: int | None) -> int:
        # env-gated SCHED_FIFO + CPU affinity (reference rt_sched.cpp);
        # degrades gracefully without privileges
        from dsdneo_tpu_torch.runtime.rt_sched import apply_rt_policy
        self.rt_report = apply_rt_policy(role="demod")
        n = 0
        while not self._stop:
            self._drain_commands()
            if self._stop:
                break
            rot = self.fs4_rot if self.fs4_shift else 0
            with trace.span("live.ingest", n):
                planes = self.ring.read_block_cu8(
                    self.block, rotate=(rot if self.combine_rot else 0),
                    timeout_ms=300)
            if planes is None:
                # a just-applied purge also yields None; only stop when
                # the ring is actually drained (bounded-run mode)
                if self._drain_budget is not None:
                    self._apply_retune()
                if max_blocks is not None and self.ring.fill < 2 * self.block:
                    break
                continue
            samples = (planes[:, 0] + 1j * planes[:, 1]).astype(np.complex64)
            if rot and not self.combine_rot:
                # DSD_NEO_COMBINE_ROT=0: two-pass transform — widen
                # first, then the j^{±n} rotation on the host (bit-equal
                # to the fused native path)
                k = np.arange(len(samples)) & 3
                samples = samples * np.power(1j * rot, k).astype(np.complex64)
            if self._drain_budget is not None:
                self._drain_budget -= len(samples)
                if self._drain_budget <= 0:
                    drain_done = True
                else:
                    drain_done = False
            else:
                drain_done = False
            if self.input_volume != 1.0:
                samples = samples * np.float32(self.input_volume)
            if self.dc_block:
                if self.dc_shift > 0:
                    self._dc += (complex(samples.mean()) - self._dc) \
                        / float(1 << self.dc_shift)
                    samples = samples - np.complex64(self._dc)
                else:
                    samples = samples - np.complex64(samples.mean())
            if self.capture is not None:
                self.capture.submit(samples)
            rms = float(np.sqrt(np.mean(np.abs(samples) ** 2)))
            rms_db = 20.0 * np.log10(max(rms, 1e-12))
            if rms_db < self.level_warn_db:
                self.level_warnings += 1
            # post-retune mute window: drop the transient samples so a
            # mid-burst retune never splices stale and fresh signal
            # into one demod window (reference retune mute)
            if self._mute_samples > 0:
                self._mute_samples -= len(samples)
                if drain_done:
                    # a second retune's drain completed inside this
                    # window: purge now, don't decode its stale tail
                    self._apply_retune()
                n += 1
                self.metrics.publish(freq_hz=self.freq_hz,
                                     retune_muted=True, blocks=n)
                if max_blocks is not None and n >= max_blocks:
                    break
                continue
            if self.auto_ppm is not None:
                # trained only past the mute window — tuner-settling
                # transients must not shift the PPM loop; the estimate
                # reads the block's host copy (no device round trip)
                from dsdneo_tpu_torch.io.auto_ppm import estimate_cfo_hz
                # advisory AFC status gate (DSD_NEO_P25_AFC_STATUS_GATE):
                # when enabled, frames classified subscriber-originated
                # or unknown must not train the PPM loop (reference
                # rtl_sdr_fm.cpp:6884 over p25_status_symbol.c)
                gate_ok = True
                if self.afc_status_gate:
                    cls = getattr(self.decoder.ctx.state,
                                  "p25_ss_classification", None)
                    gate_ok = cls == "infrastructure"
                if gate_ok:
                    self.auto_ppm.update(
                        estimate_cfo_hz(samples, self.fs),
                        getattr(self.decoder, "last_snr_db", 0.0),
                        pwr_db=rms_db)
            # power squelch: below-threshold blocks aren't decoded at
            # all (reference demod_pipeline.cpp squelch gate)
            squelched = (20.0 * np.log10(max(rms, 1e-12)) < self.squelch_db
                         or getattr(self.decoder, "last_snr_db", 0.0)
                         < self.snr_squelch_db)
            if squelched:
                self._squelched_s += len(samples) / self.fs
                if (self.scanner is not None
                        and self._squelched_s >= self.hop_s):
                    # squelch-hop: rotate to the scanner's next target
                    self._squelched_s = 0.0
                    self.scanner.tick()
            else:
                self._squelched_s = 0.0
                if self.scanner is not None:
                    self.scanner.on_activity()
            if self.auto_gain is not None:
                # DSD_NEO_TUNER_AUTOGAIN: closed-loop tuner gain from
                # the block statistics (clip back-off / quiet step-up)
                self.auto_gain.update(samples, squelch_open=not squelched)
            with trace.span("live.decode", n):
                events = [] if squelched else self.decoder.push(samples)
            if self.perf is not None:
                drops_now = self.ring.drops
                self.perf.add(
                    channels=1, symbols=len(samples) / (self.fs / 4800),
                    drops=drops_now - self._perf_drops)
                self._perf_drops = drops_now
            # audio-hold gate (DSD_NEO_P25_VOICE_HOLD / MAC_HOLD /
            # RING_HOLD): while TUNED, a configured voice-hold window
            # with no recent voice/MAC/audio activity mutes delivery
            gate_mute = False
            if self.trunk is not None:
                sm = getattr(self.trunk, "sm", None)
                if sm is not None and sm.phase.name == "TUNED" \
                        and not sm.audio_eligible():
                    gate_mute = True
            for e in events:
                if self.trunk is not None:
                    self.trunk.on_event(e)
                if self.on_event is not None and not (self.muted or gate_mute):
                    self.on_event(e)
            if self.trunk is not None:
                # the reference's watchdog tick (p25_sm_watchdog.c)
                self.trunk.tick()
            if drain_done:
                self._apply_retune()     # drained: now purge + mute
            n += 1
            # visualizer buffers every 8th block (reference
            # rtl_metrics spectrum/eye snapshots): decimated spectrum
            # from the raw block + the decoder's last soft symbols
            extra = {}
            if n % 8 == 1:
                z = samples[:4096]
                if z.size >= 256:
                    sp = np.abs(np.fft.fftshift(np.fft.fft(z)))
                    extra["spectrum_db"] = (20.0 * np.log10(
                        np.maximum(sp, 1e-9))).astype(np.float32)[::16]
                soft = getattr(self.decoder, "last_soft", None)
                if soft is not None and soft.size:
                    extra["eye_symbols"] = soft[:512].astype(np.float32)
            self.metrics.publish(
                freq_hz=self.freq_hz, stream_active=True,
                retunes=self.retunes, blocks=n, retune_muted=False,
                input_level_rms=rms,
                snr_db=getattr(self.decoder, "last_snr_db", 0.0),
                ring_fill=self.ring.fill, ring_drops=self.ring.drops,
                **extra)
            if max_blocks is not None and n >= max_blocks:
                break
        self.decoder.flush()
        self.metrics.publish(stream_active=False)
        return n

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop = True
        if self._ctl is not None:
            self._ctl.close()
        if self._thread is not None:
            # the consumer's final decoder.flush() decodes the leftover
            # partial block (a front end on the device and a host walk),
            # which can take seconds: wait for it rather than leave a
            # daemon thread inside a device call at interpreter exit
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                import sys
                print("dsd-neo-tpu: live loop did not stop within 60 s",
                      file=sys.stderr)
