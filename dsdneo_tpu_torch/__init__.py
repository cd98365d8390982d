"""dsdneo_tpu_torch — the PyTorch and CUDA port of dsdneo_tpu.

The JAX package ``dsdneo_tpu`` is the reference; this package mirrors
its module names so each function's counterpart is easy to find:

  - ``device``            card checks and identity (name, power limit)
  - ``params``            the constant tables (``data/p25p1_tables.npz``,
                          ``data/dmr_tables.npz``,
                          ``data/tdma_tables.npz``,
                          ``data/cc_tables.npz``,
                          ``data/event_tables.npz``) and the per-channel
                          carries, as tensors
  - ``dsp.frontend``      channel FIR, FM discriminator, power
  - ``dsp.cqpsk``         CQPSK demodulation: 4th-power carrier estimate,
                          RRC filter (``dsp.firdes.rrc``), differential
                          phasor
  - ``dsp.firdes``        the RRC and channel low-pass designs
  - ``symbols.timing``    windowed O&M decision positions, symbol
                          recovery, ``interp`` (XLA's arithmetic)
  - ``symbols.slicer``    windowed-quantile levels and dibit slicing
  - ``ops``               the hand-written CUDA kernels' wrappers:
                          ``fir_discriminate`` (K1), ``audio_wire`` (K3)
  - ``engine.batched``    front end + symbol timing + slicing
  - ``engine.demod``      the power-gated front end of the bursty
                          protocols
  - ``engine.voicebatch`` ``BatchedP25VoicePipeline``: I/Q → PCM
  - ``engine.dmrbatch``   ``BatchedDmrVoicePipeline``: I/Q → PCM
  - ``engine.x2batch``    ``BatchedX2VoicePipeline``: I/Q → PCM
  - ``engine.p2batch``    ``BatchedP2VoicePipeline``: I/Q → per-slot PCM,
                          with the ESS / ADP decryption path
  - ``engine.nxdnbatch``  ``BatchedNxdnVoicePipeline``: I/Q → PCM
  - ``engine.ccbatch``    the control-channel monitors
                          (``BatchedP25ControlPipeline``,
                          ``BatchedDmrControlPipeline``,
                          ``BatchedNxdnControlPipeline``): I/Q → events
  - ``engine.dstarbatch`` ``BatchedDstarPipeline``: I/Q → D-STAR headers,
                          slow data and AMBE bits (events)
  - ``engine.m17batch``   ``BatchedM17VoicePipeline``: I/Q → M17 stream
                          events, Codec2 PCM of monitored channels
  - ``cli``, ``__main__`` ``python -m dsdneo_tpu_torch``: the JAX CLI's
                          flags, the card unless ``--platform cpu``
  - ``engine.stream``     ``StreamDecoder``: the chunked serial decode
  - ``engine.live``       ``LiveEngine``: ring-fed blocks, retunes,
                          squelch, trunk following (``runtime.native.
                          IngestRing``, ``io.rtl_tcp``, ``io.net``,
                          ``io.sdr_device``)
  - ``engine.trunk``      the P25 iden table (channel → frequency), the
                          channel map, ``TrunkSM``, ``TrunkFollower``,
                          ``TrunkScanner``
  - ``engine.livevec``    the one-tuner closed loop's test drive
  - ``engine.modes``      the modes' filter profiles and symbol rates
  - ``engine.voicestate`` the voice-carry reset the AMBE pipelines share
  - ``fec.device``        batched IMBE and AMBE+2 voice-frame ECC, the
                          GF(64) RS syndrome screen (K7), the P25 trellis
                          Viterbi (K4), the K=5 soft Viterbi (K5), the
                          K=3 hard Viterbi (K6) and the D-STAR AMBE ECC
  - ``fec.crc``, ``fec.trellis``, ``fec.conv``
                          the host CRCs, P25 trellis (with the ranked-list
                          decoder) and K=5 code
  - ``fec.rs``            the host RS(63,35) decoder
  - ``crypto``            the RC4 keystream and the key ring
  - ``vocoder.device``    IMBE dequantization, prediction (K2), repeat
                          gate; the AMBE+2 parameter decode and the tail
                          every AMBE family shares
  - ``vocoder.synth``     batched harmonic synthesis
  - ``vocoder.codec2``    the system's libcodec2 through ctypes (host)
  - ``protocol.p25.p2_xcch``
                          the P25p2 scrambler, ISCH lookup, hexbits
  - ``protocol.base``, ``symbols.framesync``, ``core.affiliation``
                          decode events and contexts, sync definitions,
                          the affiliation and patch registries
  - ``protocol.p25.phase1``, ``protocol.dmr.csbk``,
    ``protocol.nxdn.decoder``
                          the TSBK, CSBK and NXDN message catalogs
  - ``protocol.dstar.decoder``, ``protocol.m17.decoder``
                          D-STAR header and slow-data lines, the M17
                          frame tables, CRC and callsigns
  - ``protocol.p25.encode``, ``protocol.dmr.encode``,
    ``protocol.nxdn.encode``, ``protocol.dstar.encode``,
    ``protocol.m17.encode``
                          the test-signal modulators (and the D-STAR and
                          M17 streams' judges)

Six pipelines, each ``[C, B, 2]`` float32 I/Q blocks in, ``[C, N]``
PCM out (``[2C, N]`` for P25p2), with the same calls (``frontend_dispatch`` →
``frontend_finish``, or ``frontend_sync_device`` for both → the host
pick → ``decode_from_frontend`` → ``fetch_pcm``; ``decode_block`` and
``decode_block_async`` for all of it; ``reset_voice_state``):

  - ``BatchedP25VoicePipeline(C)``               P25 Phase 1 C4FM voice
    (kernels K1, K2, K3);
  - ``BatchedP25VoicePipeline(C, cqpsk=True)``   P25 Phase 1 CQPSK / LSM
    voice (K2, K3);
  - ``BatchedDmrVoicePipeline(C)``               DMR BS two-slot voice
    (K1, K3);
  - ``BatchedX2VoicePipeline(C)``                X2-TDMA two-slot voice
    (K1, K3);
  - ``BatchedP2VoicePipeline(C, keyring=...)``   P25 Phase 2 two-slot
    TDMA voice (K1, K3; K7 with a keyring);
  - ``BatchedNxdnVoicePipeline(C, mode=...)``    NXDN48 / NXDN96 voice
    (K1, K3).

Three control-channel monitors, ``[C, B, 2]`` I/Q blocks in, trunking
events out in one ``DecoderContext`` per channel (``ctxs[c].events``;
``decode_block_events``, or ``frontend_dispatch`` → ``frontend_finish``
→ ``events_from_frontend``):

  - ``BatchedP25ControlPipeline(C)``   P25 Phase 1 TSBKs, C4FM (K1, K4) or
    ``cqpsk=True`` (K4);
  - ``BatchedDmrControlPipeline(C)``   DMR Tier III CSBKs (K1);
  - ``BatchedNxdnControlPipeline(C)``  NXDN RCCH CAC messages (K1, K5).

Two event pipelines behind the power-gated front end, the same calls:

  - ``BatchedDstarPipeline(C)``        D-STAR RF headers (K6), slow data
    and raw AMBE bits with the D-STAR AMBE ECC;
  - ``BatchedM17VoicePipeline(C)``     M17 stream frames (K5), the LSF,
    Codec2 speech of the ``monitor`` channels.

It imports torch and numpy, never JAX and nothing of the JAX package:
what it needs from there (the NID code's generator polynomial, the RRC
design, the host pickers, the host ADPCM decoder, the constant tables in
``data/``) it keeps as its own copy.  Every function takes its tensors' device from its inputs; CUDA
kernels launch for CUDA tensors, their plain PyTorch versions run for
CPU tensors.  The entry points (``params.load``, ``params.load_dmr``,
``params.load_tdma``, ``params.load_cc``, ``params.load_event`` and the
pipelines) run on the card unless the caller names another
device.
"""

__version__ = "0.1.0"
