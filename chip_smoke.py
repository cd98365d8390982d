#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one CUDA card: eight voice paths,
five control-channel monitors, two event pipelines, the serial decode
path, the wideband band and the closed-loop trunked fleet, the CLI and
the live one-tuner path, the CLI's frontends and extras, and the
multi-GPU slice (the sharded steps and the sharded trunked fleet over
``torch.distributed``).

    python3 chip_smoke.py

The paths, each at 320 channels through the entry points a user calls:

  - C4FM: P25 Phase 1 C4FM voice, ``BatchedP25VoicePipeline(320)``,
    3 s blocks; kernels K1 (FIR + discriminator), K2 (IMBE prediction)
    and K3 (ADPCM encode);
  - CQPSK: P25 Phase 1 CQPSK/LSM voice,
    ``BatchedP25VoicePipeline(320, cqpsk=True)``, 3 s blocks; K2 and K3
    (the RRC matched filter stands where K1's channel filter did);
  - DMR: DMR BS two-slot voice, ``BatchedDmrVoicePipeline(320)``, the
    2.94 s stream of 8 superframes per slot; K1 and K3 (AMBE has no
    prediction recurrence);
  - X2: X2-TDMA two-slot voice, ``BatchedX2VoicePipeline(320)``, the
    2.35 s stream of 8 superframes per slot at 6000 symbols/s; K1, K3;
  - P2: P25 Phase 2 two-slot TDMA voice, ``BatchedP2VoicePipeline(320)``
    with the default WACN/SYS/NAC and no keyring, the 2.90 s stream of
    8 superframes, 640 output streams; K1, K3;
  - NXDN48: ``BatchedNxdnVoicePipeline(320, mode="nxdn48")``, 3 s blocks
    of 36 full-voice frames per channel; K1, K3;
  - ADP: ``BatchedP2VoicePipeline(320, keyring=...)`` on an ADP/RC4
    encrypted stream, 1.457 s blocks; K1, K3 and K7 (the RS syndrome
    screen of the ESS, ~2,330 words a block).  The RC4 keystream is
    host Python, so the step measures the host's ESS work, which its
    own stage shows;
  - YSF and dPMR: ``BatchedYsfVoicePipeline(320)``,
    ``BatchedDpmrVoicePipeline(320)``, 3 s blocks of bursty voice behind
    the gated front end; K3, and K8 (the one-pole IIR) in the CLI's
    monitor-audio conditioning of the decoded PCM
    (``dsp.audio_filters.condition_audio``, de-emphasis "nfm" and the
    3400 Hz low-pass, one cascade launch a block);
  - EDACS: ``BatchedEdacsControlPipeline(320)``, 3 s blocks of a
    continuous control channel; no kernel of the table;
  - P2 CC: ``BatchedP2ControlPipeline(320, 0xBEE00, 0x14C, 0x293)``,
    the JAX bench's P25 Phase 2 TDMA control channel (``bench.py:604``:
    6 superframes of scrambled SACCH MAC PDUs, 2.1767 s blocks); K1.
  - serial: ``engine.decoder.decode_samples`` (one channel, the CLI's
    offline decode entry) on ten 60 s streams at 48 kHz: a P25 Phase 1
    voice call as C4FM and as CQPSK (part of it ADP-keyed, the key in a
    ``KeyRing``), an EDACS control channel with ProVoice voice
    superframes (the ``provoice`` mode), a DMR BS stream with traffic on
    both slots (CSBKs, a rate-3/4 data call, a UDT, short LCs, group
    calls with the embedded LC and a talker alias, one call under Basic
    Privacy and one under RC4 with late entry; the ``dmr`` mode with
    both keys), also on an inverted channel under ``force_polarity``,
    an X2-TDMA voice stream (the ``x2tdma`` mode), an NXDN traffic
    channel (``nxdn48`` and ``nxdn96`` from the same dibits), a dPMR
    channel, a YSF channel, a D-STAR channel, an M17 channel (clear,
    scrambled, AES-CTR and signed calls with Codec2 voice, an SMS
    packet, a BERT run; the keys as ``state_attrs``) and a P25 Phase 2
    channel (a clear then an ADP-keyed half; with ``p2_params`` and
    blind); ``decode_samples(..., "auto")`` on a probe of each family's
    stream; ``decode_capture`` of the P25 call written as a 96 kHz cs16
    capture; no kernel of the table: the serial front end and the
    resampler are plain PyTorch on the card and the protocol walk runs
    on the host, as in the JAX package.
  - wideband: ``engine.wideband.decode_wideband_voice_batched`` on a
    12.288 MHz band, 256 channels of 48 kHz (the polyphase bank and the
    halfband decimator on the card, every channel through
    ``BatchedP25VoicePipeline(256)``), 3 s blocks; K1, K2, K3;
  - the trunked fleet: ``engine.fleettrunk.TrunkedFleet`` (the row
    extractor, the control rows' pipeline, grants retargeting the voice
    rows): the JAX bench's 768 kHz CU8 cell with the device TSDU pick
    (``parallel.mesh._p25_cc_body``: K1, K4), a 2.4 MHz band of four
    P25 systems and 16 voice rows, and the DMR, NXDN48 (K5 on its CC),
    EDACS (analog rows) and P25 Phase 2 row fleets.
  - the CLI: ``python -m dsdneo_tpu_torch`` (its default platform, the
    card) on a P25 capture, ``--trunk-wideband`` on the bench's cell
    with the decoded-audio conditioning (K1, K2, K4 on the fleet, K8 on
    its PCM); the live path: ``engine.live.LiveEngine`` following a
    grant with ``engine.trunk.TrunkFollower`` and ``TrunkSM`` (one
    tuner), and fed by ``io.rtl_tcp.RtlTcpClient`` through the ingest
    ring.
  - the multi-GPU slice: ``parallel.mesh``'s sharded steps (P25, DMR and
    P25p2 voice, P25 CC) at 320 channels and the sharded trunked fleet
    ``parallel.trunkfleet.ShardedTrunkedFleet`` of 64 systems in five
    modes, on a world of one rank under NCCL (the machine has one card)
    and on two ranks sharing it under gloo; K1, K2, K4, K5.

Phases, in order; any failure exits non-zero:

  1. set-up: the card (name and power limit), no JAX and no module of
     the JAX package ``dsdneo_tpu`` in the process, the CUDA kernels
     built from ``dsdneo_tpu_torch/csrc``, the input blocks of the three
     paths: 320 distinct channels each (own leading offset and noise
     seed; on CQPSK also an own carrier offset within ±300 Hz) built
     from the test vectors in ``dsdneo_tpu_torch/data`` (each family's
     two blocks over a pool of threads, one chunk of channels a task,
     bit for bit the blocks of one call; each family's seconds are
     printed); the AMBE families' leads are 0-96 random dibits; the build log must show
     every instance of K4, K5, K6, K7 and K8 without local memory (no
     stack frame, no spills);
  2. each kernel against its plain PyTorch version on the card, at the
     paths' shapes, with its time, its bound (the larger of bytes over
     3.35 TB/s and operations over the 67 TFLOP/s FP32 peak; for the
     recurrences K2 and K3 also the recurrence floor) and its share of
     that bound: K1 at [320, 144000] and at the DMR block [320, 141140],
     through the two stride-2 views the paths give it; K2 at [320, 162];
     K3 at [320, 25920] and at the DMR path's [320, 46080]; K1 at the
     X2, P2 and NXDN48 blocks; K3 at P2's [640, 23040] and NXDN48's
     [320, 23040] (held to its plain version on 32 rows: the plain loop
     takes ~18 s at [320, 46080]); and the RRC
     matched filter (``dsp.frontend.fir_complex``, 81 taps,
     [320, 144000] complex) on the card against the CPU on channels 0-1,
     with cuDNN's TF32 switch on around it;
  3. each path in turn, checked and then timed.  Checked: ``pcm_fmt``
     f16 and adpcm over two consecutive blocks with the carry kept, the
     launch counters set to 0 just before the path and read just after.
     P25 paths: every channel must accept every LDU and decode the
     vector's IMBE bits; on CQPSK the carrier estimate of every channel
     must lie within 1 Hz of the offset applied.  DMR: every channel
     must accept at least 14 of its 16 superframes per block, none
     inverted, and the share of frames whose 49 bits equal the vector's
     is printed (the synthetic FM leaves ~0.5% symbol errors and 25 of
     49 bits are unprotected) and must not be lower on the card than on
     the port's CPU path for channels 0-1; then the same dibits with the
     serial DMR stream's pulse shape (``serialvec.dmr_iq``), two blocks:
     every channel accepts every superframe, every frame's 49 bits equal
     the vector's, 0 ECC errors.  Every path: PCM finite and
     non-silent, and channels 0-1 within 2e-3 of the peak of the port's
     plain CPU path on the same input; every kernel of the path
     launched, the others not.  Timed (adpcm): the pipelined loop
     (dispatch N+1, finish N, fetch N-1's PCM last) over 6 blocks, the
     stage split of one block, and a torch.profiler window over two
     blocks (the largest device operations, the port's kernels by name
     with their device time per launch, and the device busy share:
     device time per block over the unprofiled pipelined step, since the
     profiler slows the host).  A path's timing follows its own checks
     at once, so the C4FM path is timed in the state of the process in
     which it was timed before the other paths were added, and its step
     stays comparable with earlier runs (the step is host-bound).
     After the C4FM path's checks also: K3
     on that path's own PCM beside three-tone sinusoids, and K2 on its
     own grids beside random ones.  X2: every channel accepts every
     superframe its block holds whole, and the exact-frame share on
     the card is not below the CPU path's on channels 0-1.  P2: every
     (channel, slot) stream decodes at least 7 x 18 of its 8 x 18 frames
     with the vector's 49 bits, all of them.  NXDN48: every channel
     accepts at least 35 of its 36 frames, and the exact-frame share on
     the card is not below the CPU path's on channels 0-1.  On X2, P2
     and NXDN48 the card's PCM of channels 0-1 is held to the CPU
     path's up to the first frame whose bits differ.
  4. the ADP phase at 320 channels through the AMBE paths' loop (f16
     and adpcm, two blocks with the carry kept): with the key in the
     keyring every one of the 640 slot streams decodes every frame from
     the second superframe on to the vector's plaintext bits, the first
     block's first superframe stays cipher, the PCM is finite, channels
     0-1 equal the CPU path, and K7 launches once a block; timed
     (pipelined, stage split with the decode's ESS path and its job,
     word, host-decode and RC4 counts, profile).  Then K7 against its
     plain version at the path's word count and at 5,120 and 20,480
     words, half of them clean RS(63,35) codewords, bit for bit, with
     the designs it replaced or beat (``csrc/alt/rs_syndromes_v1.cu``,
     the first; ``rs_syndromes_v2.cu``, bit-sliced;
     ``rs_syndromes_mma.cu``, the product on int8 mma; each held bit for
     bit to it), an empty launch, the ESS path's call (host words, and
     the words uploaded first, the form before) and the library
     yardstick (an f32 ``torch.matmul`` of the words' bit planes by the
     code's GF(2) parity matrix, mod 2, repacked; the port never calls
     it) timed in the same call, and the SASS of every design's loops.
  5. the control-channel monitors (P25 TSBK with K1 and K4, DMR CSBK with
     K1, NXDN CAC with K1 and K5) at 320 channels, 3 s blocks, two
     blocks with the contexts kept: every block a channel's block holds
     whole is parsed with the vector's payload and the JAX catalog's
     lines; channels 0-1 equal the CPU path; K4 and K5 against their
     plain versions and timed in both input forms (K4 on the monitor's
     uint8 bits and on int32 LLRs, K5 with its weight row broadcast and
     written out) beside the first designs' recorded times and beside
     the lanes-per-word designs that lost to them
     (``csrc/alt/viterbi_lanes.cu``, built by a second nvcc beside the
     library's and held bit for bit to the kernels), K5 also over a
     sweep of word counts, after the build log has shown neither kernel
     uses local memory; each monitor timed with its stage split and
     profile.
  5b. the P25 Phase 2 TDMA monitor at 320 channels on the bench's
     stream (IDEN_UP TDMA, the TG 101 grant on channel 0x1018 and
     NET_STS, 30 dB), each channel with its own lead of 0-96 dibits and
     its own noise, two blocks with the contexts kept: every xCCH
     timeslot of every frame a channel's block holds whole parsed (a
     SACCH line at its position and no error line), every one through
     the screen (0 RS fallbacks, 0 CRC errors), the grant and the
     2-slot TDMA iden entry on every channel, channels 0-1's packed
     bursts and events (lines and fields) equal to the CPU path's, K1
     launched once a block and no other kernel; K1 at the block's
     length against its plain version; the sync matches per channel
     beside the JAX package's top-K of 64; the blind recovery on 4
     channels without WACN/SYS/NAC (recovered once on each in block 0,
     every burst of block 1 through the screen); timed (pipelined, 6
     blocks) with its stage split (pick, device gather, host screen,
     host parse), profile and peak memory.
  6. the event pipelines at 320 channels, 3 s blocks (n_sym 14,398), two
     blocks with the contexts kept, each channel with its own lead of
     0-96 dibits of dead air and its own noise, through the gated front
     end: ``BatchedDstarPipeline(320)`` (kernel K6 launched) accepts
     every header its block holds, CRC-valid with the vector's 41
     octets, and every superframe with a partner sync in the block, with
     the vector's slow-data bytes, raw AMBE bits and 49-bit parameters
     and 0 ECC errors, nothing else that emits an event, and sets
     ``channel_state`` right; ``BatchedM17VoicePipeline(320)`` (kernel
     K5 launched) passes every stream frame the pick may take through
     the LICH gate with the vector's FN and payload bytes, fails every
     other hit, and assembles the LSF CRC-valid with the vector's
     callsigns whenever its six chunks are in; channels 0-1 equal the
     CPU path's frames, records and events; the gated front end on the
     card within ``GATED_SOFT_TOL`` of its CPU path; K6 against its
     plain version at the path's header count and at 65,536 words, K5
     at M17's word count; each path timed (pipelined) with its stage
     split, profile and peak memory, and the top-K lists' fill printed.
  7. the paths behind the gated front end that ``data/burst_tables.npz``
     carries, at 320 channels, 3 s blocks, two blocks with the carry or
     the contexts kept, own lead (0-96 dibits) and noise per channel,
     every fourth channel of dPMR and EDACS with the FM negated:
     YSF and dPMR through the AMBE paths' loop (f16 and adpcm; every
     frame a block holds accepted with the vector's AMBE bits, YSF's
     data frames and any other pick failing the vote gate, the inverted
     dPMR channels decoding; PCM finite and non-silent; channels 0-1
     within 2e-3 of the peak of the CPU path; the decoded PCM of every
     block conditioned on the card through K8, held bit for bit to the
     plain version on f16 block 0), each timed (pipelined, stage split,
     profile); the EDACS monitor (channels read in the standard, EA and
     ESK modes and inverted) with every frame a block holds accepted
     with the vector's messages and the JAX catalog's lines, channels
     0-1 equal to the CPU path's, the frames a top-K of 96 (the JAX
     package's) would accept counted beside the port's 128, timed
     (pipelined).  K8 must be launched exactly 4 times on the YSF and
     dPMR paths (one cascade a block), and is held bit for bit to its
     plain version and timed at their decoded PCM, one filter and the
     cascade.  In phase 2, K8 behind all four filters and as the cascade
     at [320, 24000] and at a ragged length, bit for bit against its
     plain version (the cascade against two plain calls); then timed
     beside its second design (``csrc/alt/one_pole_v2.cu``) and beside
     itself built at 16 and 32 rows a block (``DSD_K8_ROWS``), each held
     bit for bit to it, on aligned, ragged and unaligned rows; its cycles
     a step from the slope of its time over T; and the compiled loops
     (``cuobjdump -sass``) of K8, K6 and their earlier designs.  In phase
     6, K6 beside its first design (``csrc/alt/conv_k3_v1.cu``), held
     bit for bit to it.  These earlier designs are built, each by its own
     nvcc, beside the library in phase 1.

  8. the serial decode path: ``demod_fm``'s step at the C4FM cell's
     block [320, 144000] (channels 0-1 equal to the CPU path on dibits
     off the thresholds; its time by CUDA events), then
     ``decode_samples`` on the card over each whole 60 s stream of
     ``data/serial_tables.npz`` (``engine.serialvec``): every LDU
     accepted with the vector's voice bits, the keyed ones decrypted to
     its clear bits, the LC on every LDU1 and the TDULC, every LDU2's
     encryption sync; every EDACS frame with its message and every
     ProVoice superframe with its LID, BF and frames; every DMR burst's
     lines (CSBK catalog, data call with its CRC32, UDT text, short LC,
     voice LC header, PI header, terminator, embedded LC, talker alias,
     the RC4 MI refreshes) and every AMBE frame's bits, the RC4 and Basic
     Privacy calls decrypted to their clear bits, upright and on an
     inverted channel under ``force_polarity``; every X2-TDMA superframe
     the decoder walks with its 18 AMBE frames; every NXDN frame's line
     (RAN, SACCH part, the VCALL of each superframe, FACCH1 VCALL and
     TX_REL) and AMBE frame at both rates; every dPMR header, end and
     part with its talkgroup, source, channel code and 8 AMBE frames;
     every YSF frame's FICH fields, DCH2 text and AMBE or IMBE frames;
     every D-STAR header's octets and superframe's slow data and AMBE
     bits; every M17 frame's line (LSFs with their META, the LICH's
     LSFs, FN, A_DATA, the signature frames, VERIFIED, the SMS, the BERT
     counts) and every voice payload handed to Codec2 and sent as an IP
     frame; every P25p2 frame's timeslots (DUID, superframe position,
     ESS, MAC_PTT) and AMBE frame, the keyed half decrypted from its
     second superframe, with ``p2_params`` (and blind over its first 20
     s); nothing else
     emitted; the PCM finite and not silent (D-STAR and ProVoice
     synthesize none, nor M17 where libcodec2 does not load: the script
     says whether it loads); the first 10 s of M17 and P25p2 and the
     first 5 s of each older stream decoded on the card and on the CPU
     with equal events and voice bits and each slot's PCM within 2e-3 of
     the peak; the inverted DMR channel over its first 20 s.  Each stream's x-realtime and its split
     (front end, host walk, synthesis; M17's Codec2 host calls as its
     synthesis) are printed.  Then ``decode_samples(..., "auto")`` on
     the card on a 4 s probe of each family's stream, its pick equal to
     ``detect_mode``'s on the CPU; and the P25 call resampled from 48 to
     96 kHz on the card (``dsp.resampler``), written as a cs16 capture
     (``io.write_iq_capture``) and decoded by ``decode_capture`` on the
     card (back to 48 kHz on the card), judged whole, its first 5 s
     equal to the CPU path's.  The first 5 or 10 s of three streams
     (C4FM, DMR, P25p2) are also profiled.  ``"auto"`` is held to the
     JAX ``detect_mode``'s picks stored in ``serial_tables.npz`` (a CPU
     test holds the port's CPU picks to them).  Each phase's start time
     is printed.  The peak device memory and the launches of K1-K8
     during the phase (all 0) are printed.
  9. the wideband band and the trunked fleet (``data/fleet_tables.npz``,
     ``engine.fleetvec``; every carrier modulated at 48 kHz and placed
     in its bins of one FFT on the card).  Wideband: 254 of 256 bins of
     a 12.288 MHz band loaded with the P25 vector (own lead and noise,
     30 dB; bins 37 and 128, the Nyquist bin, empty), two 3 s blocks,
     adpcm then f16: every loaded channel accepts every LDU its block
     holds whole, consecutive, with the vector's IMBE bits but for at
     most 0.1% of the frames (the bank folds a carrier two bins away in
     at -31.8 dB, ROADMAP queue 3), the empty bins accept none; channels
     0-1 (f16) against the CPU path, the band channelized whole on the
     CPU; timed (6 blocks), the channelizer by CUDA events, device busy,
     peak memory; K1, K2 and K3 at its shapes.  The JAX bench's fleet
     cell (768 kHz CU8, CC at -96 kHz, 4 voice rows, hangtime 5 s,
     grace 0.5 s, the device pick): one grant, row 0 retargeted to +150
     kHz, its LDUs with the vector's IMBE bits, the parked rows silent;
     the host pick's grants, log and PCM equal (bit for bit), the CPU
     path's within 2e-3 * peak; ``step_pipelined`` on blocks 0, 0, 1
     gives the plain step's block-1 PCM at the flush; timed in the
     bench's double-buffered loop (``step(None, prefetch=...)``); K1 at
     the [1, 47999] and [4, 47999] rows, K4 at the pick's 48 words.  The
     2.4 MHz fleet (4 CCs, 16 voice rows, 6 blocks of 1 s, CU8, default
     hangtime and grace, the device pick, prefetched): 12 grants, 6
     releases (the calls that fall silent), their rows parked on CC 0,
     no busy or unresolved drops, the parked rows silent; each call's
     LDUs and exact frames reported beside the row extractor's gain over
     its carrier (the JAX bank's dip 9-19 kHz off a bin's centre, queue
     3); timed.  DMR, NXDN48, EDACS (analog row) and P25p1 with 2
     Phase 2 rows at 768 kHz, two blocks: the grant(s), the retargeted
     row, voice on it, stats, log, offsets and PCM equal to the CPU
     path's; K5 at the NXDN CC's words.  Each cell's kernel launches.
 10. the CLI and the live one-tuner path (``engine.livevec``): ``python
     -m dsdneo_tpu_torch -f1 --iq-replay`` in a fresh process with no
     ``--platform`` (the card) on 10 s of the P25 call with its ADP key
     (``--keys-dec``): every IMBE frame of the ``.imb`` it writes
     (``--mbe-out``) is the vector's clear voice with 0 ECC errors; its
     frame log (JSON, with the fields), event log (``-J``) and WAV equal
     the in-process CPU CLI's (``--platform cpu``) on the first 5 s;
     its wall time beside the library call ``decode_capture`` on the
     same capture.  In process, ``--trunk-wideband`` on 2.5 s of the
     bench's fleet cell (1 s steps and a 0.5 s last block) with
     ``DSD_NEO_DEEMPH=nfm DSD_NEO_AUDIO_LPF=3400``: its printed grant
     and summary equal the library ``TrunkedFleet``'s log and stats on
     the card, and its WAV the library's PCM conditioned by
     ``dsp.audio_filters.condition_audio``, bit for bit; the launch
     counters set to 0 just before the CLI's run and read just after
     (the kernels line's ``"cli"``): K1, K2, K4 and K8 launched, K3,
     K5, K6 and K7 not.  The closed loop in lockstep on the card and
     on the CPU (one tuner on the bench's CC, the grant of TG 101
     followed to its call through ``LiveEngine.tune``, back to the CC
     after the hangtime): the tunes CC → voice → CC, every one of the
     call's 99 IMBE frames exact, tunes and events equal to the CPU's.
     The port's ``FakeRtlTcpServer`` streams 4 s of the P25 call as CU8
     to ``RtlTcpClient``, into the ring and ``LiveEngine`` on the card
     (threads): at least 20 LDUs' IMBE frames, all the vector's clear
     voice.  Each run's realtime multiple and wall time, the card's
     name and power limit beside them.
 11. the CLI's frontends and extras and the batched host leftovers
     (``extras_phase``): M17 transmit (``-fZ``, ``-fP --m17-sms``,
     ``-fB`` written with ``-o iq:``) decoded back by ``-fz`` on the
     card and the CPU: lines equal, FN 0-49 in order, the LSF's CAN and
     callsigns, the SMS text, 50 BERT frames with 0 errors, no kernel
     launched; ``--fleet p25p1:cc:2 --frontend http`` on 1.5 s of the
     bench's CC, its ``/grid``, ``/events``, ``/calls`` and
     ``/snapshot`` polled from a thread and read at its stop (2
     channels, the NAC line, the grant of TG 101), its K1 and K4
     launches equal to the same fleet's without the frontend, that
     fleet's events and grid equal to the same fleet's on the CPU, and
     K1 and K4 held to their plain versions at its shapes; ``-f1
     --stream 0.25 --frontend http`` on 10 s of the P25 call: the
     snapshot (blocks, 4800 symbols/s, spectrum, eye) and every LDU's
     IMBE frames exact; rtl_tcp into ``LiveEngine`` on the card with
     ``AutoPpm`` and ``TunerAutogain`` behind spies (a 1500 Hz offset
     asks −2 ppm first and the call stays exact; a clipped feed steps
     the gain down), ``ui.terminal.run_live`` on that engine drawing
     on a pseudo-terminal, a snapshot a frame, its menu's tune reaching
     the engine;
     ``make_frontend_step`` of every four-level mode at [320, 48000]
     against the CPU, K1 held to its plain version with each channel
     filter; ``decode_block`` against ``decode_block_host`` at C=320 on
     the C4FM block (frames equal, PCM within ``HOST_PCM_REL``, the
     host path on the card equal to the CPU's) and ``frontend_sync``'s
     dibits against ``frontend_dispatch``'s.

 12. the multi-GPU slice (``mesh_phase``): ``dryrun_multichip(1)`` (one
     rank on the card under NCCL in a fresh process, every step of the
     JAX dryrun's contract with its checks); then a world of one rank
     under NCCL in this process: the P25 voice (24 candidates a
     channel), DMR voice (24), P25p2 voice (32) and P25 CC (64) steps on
     the first blocks of phase 3's and phase 5's paths at 320 channels,
     judged (every LDU and superframe a block holds whole picked, every
     whole TSDU's three TSBKs with the vector's payload bytes and a
     CRC-ok count of three each, every P2 slot stream voiced), channels
     0-1 against the port's CPU path (picks and blobs equal, PCM within
     2e-3 of the peak), timed (step ms, realtime multiple, device busy
     share); ``ShardedTrunkedFleet`` of 64 systems of 768 kHz CU8
     (``engine.fleetvec.system_band``: each system its own lead and
     noise; 1 CC and 4 voice rows; 1 s blocks: two of signal and a
     silent one) in the modes p25p1, dmr, nxdn48, edacs and p25_mixed:
     every system granted in block 0 (both slots in p25_mixed), its
     granted row voiced and the parked rows silent in block 1, every
     call released at 3 s, no drop; p25p1's first 8 systems each equal
     to ``TrunkedFleet(cc_device_pick=True)`` on its band (offsets
     after every block, one grant, one release: what the JAX pair
     agree on, ``tests/test_torch_trunkmesh.py``), the other modes'
     first 2 systems equal to the port's CPU path (log, offsets, PCM
     within 2e-3 of the peak); each mode timed (the P25 fleet also
     profiled); the launch counters set
     to 0 before the steps and read after the fleets (the kernels
     line's ``"mesh"``: K1, K2, K4, K5 launched, the others not); K1 at
     the fleet's CC rows [64, 47999] and voice rows [256, 47999], K2 at
     [320, 216] and [256, 72], K4 at 61,440 and 768 words, K5 at 512
     CACs held to their plain versions; then two ranks sharing the card
     under gloo (fresh processes, the inputs through memory-mapped
     files): the four steps and the P25 fleet equal to the world of one
     (picks, valid blobs, masks, fleet metrics, log, offsets, stats;
     PCM of rank 0's rows within 1e-6 of the peak: the synthesizers'
     noise phase follows a row's index in its shard), with rank 0's
     step times.

Each phase prints its start and its time.  The last lines of standard
output are the card's name and power limit,
a JSON object describing the kernels, and the contract line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
C = 320                      # channels, as the JAX package's bench runs them
FS = 48000.0
BLOCK_S = 3.0                # one P25 block of I/Q per channel
N_TIMED = 6                  # blocks in the pipelined timing loop
SEED = 20261016
CFO_MAX_HZ = 300.0           # CQPSK carrier offsets, inside the ±600 pull-in
DMR_MAX_LEAD = 96            # DMR leading offsets that keep 16 superframes
HBM_BPS = 3.35e12            # H100 SXM memory rate (bytes/s)
FP32_FLOPS = 67e12           # H100 SXM FP32 peak outside the tensor cores
K2_FLOP_PER_HARMONIC = 25    # K2's arithmetic per harmonic and frame
# per K3 sample, the loop-carried chain: one shared-memory row load
# (~30 cycles) and 5 dependent integer ops (compare, three selects, mask)
K3_CHAIN_CYCLES = 30 + 5 * 4
# per K2 step, the carry's own dependent chain in csrc/imbe_pred.cu, with
# latencies of ~25 cycles for a warp shuffle, 4 for an FP32 add, multiply
# or select, and ~55 for __fdiv_rn's fast path: the gather (shuffle +
# select) 29, the lerp (multiply, add) 8, the mask and the pair sum 8,
# the butterfly 5 x (shuffle + add) 145, the division 55, pred (subtract,
# two multiplies) 12, logm (select, add, multiply) 12, the select on act
# 4.  The per-chunk phases (the scan, the interpolation, voicing and
# amps) depend on no carry and are not in it.
K2_CHAIN_CYCLES = 29 + 8 + 8 + 5 * (25 + 4) + 55 + 12 + 12 + 4
# per K4 step, the metrics' own dependent chain in csrc/p25_trellis.cu
# (one thread per word reading its row from shared memory: the loads
# and the 16 nibble costs depend on no metric): an integer
# add, then the three compare-and-select pairs over prev 1..3, ~4 cycles
# each; no shuffle joins it
K4_CHAIN_CYCLES = 4 + 3 * (4 + 4)
# per K5 step in csrc/conv_k5.cu (one thread per word, the 16 states in
# its registers, so no shuffle joins the chain): the add of the branch
# cost (FP32), the compare and the select
K5_CHAIN_CYCLES = 4 + 4 + 4
# K4's and K5's first designs (one thread per word reading its row in
# place) at these word counts, as PERF.md section 6 records them (NVIDIA
# H100 80GB HBM3, 700 W; LLRs, materialised weights), for the lines of
# the present kernels
K4_BEFORE_MS = {38400: 0.1245, 131072: 0.4328}
K5_BEFORE_MS = {11840: 0.1398, 65536: 0.3494, 22720: 0.1240}
# per K6 step in csrc/conv_k3.cu: the integer add of the branch cost, the
# compare and the select (the four states' chains run side by side)
K6_CHAIN_CYCLES = 4 + 4 + 4
K6_SYNTH_N = 65536           # K6's larger grid (words)
# per K8 step in csrc/one_pole.cu: the fused multiply-add on the carried
# output (the product of the input is off the chain; the cascade's second
# chain runs beside the first, fed a step behind)
K8_CHAIN_CYCLES = 4
K8_T = 24000                 # 3 s of 8 kHz PCM
K8_RAGGED_T = 4001           # a length that is not a multiple of 4
# K6's first and K8's second design, as PERF.md section 6 records them
# (NVIDIA H100 80GB HBM3, 700 W; K8 one filter a launch), and the
# predictions written for the present kernels before their first run,
# (low, high) ms, by word count or row length
K6_BEFORE_MS = {888: 0.0679, 65536: 0.2930}
K6_PREDICTED_MS = {888: (0.006, 0.015), 65536: (0.04, 0.08)}
K8_BEFORE_MS = {24000: 0.3552, 22400: 0.3303, 17920: 0.2629, 4001: 0.1719}
K8_PREDICTED_MS = {("one filter", 24000): (0.06, 0.10),
                   ("cascade", 22400): (0.07, 0.12),
                   ("cascade", 17920): (0.055, 0.10),
                   ("one filter", 4001): (0.015, 0.03)}
EDACS_MODES = ("standard", "ea", "esk", "standard")  # by channel % 4;
                                                     # % 4 == 3 inverted
# the gated front end, card vs its CPU path: soft symbols within this
# (the FIR and the discriminator's atan2 round otherwise, ~1e-6, and a
# timing window that is mostly dead air takes its phase from the noise,
# which moves its live neighbours' instants; tests/test_torch_gated.py)
GATED_SOFT_TOL = 0.1
DMR_MAX_FAIL = 0.03           # DMR CSBKs that may fail BPTC + CRC (see
                              # judge_monitor)
K4_SYNTH_N = 131072           # K4's and K5's larger grids (words)
K5_SYNTH_N = 65536
SPIN_CYCLES = 20_000_000     # ~10 ms: the card's lead over the host in cuda_ms
TDMA_MAX_LEAD = 96           # X2, P2, NXDN leading offsets (dibits)
K7_SHAPES_N = (5120, 20480)  # K7's word counts beside the path's: the
                             # clear P2 block's with a keyring, synthetic
# K7's first design at 20,480 words (PERF.md section 6; NVIDIA H100 80GB
# HBM3, 700 W), and K7's targets by word count ("path": the ADP path's
# ~2,330 words): at most this many ms above an empty launch
# ("above_empty") or in all ("ms")
K7_BEFORE_MS = {20480: 0.0256}
K7_TARGET = {"path": ("above_empty", 0.001), 5120: ("above_empty", 0.001),
             20480: ("ms", 0.0044)}
# the P25 Phase 2 TDMA control channel: the JAX bench's stream (bench.py:604,
# tests/test_p2ccbatch.py): WACN, SYSID, NAC, the grant and the iden base
P2CC_KEY = (0xBEE00, 0x14C, 0x293)
P2CC_SUPERFRAMES = 6
P2CC_CENTER_HZ = 851_000_000.0
P2CC_GRANT_CH = (1 << 12) | 24
P2CC_TG = 101
K3_CHECK_ROWS = 32           # K3's new lengths: rows held to the plain loop
# phase 8's streams whose first seconds are also profiled
SERIAL_PROFILED = ("P25p1 C4FM call", "DMR BS call", "P25p2 clear + ADP")
WB_CH = 256                  # the wideband cell: 256 PFB channels of 48 kHz
WB_EMPTY = (37, 128)         # its empty bins: one, and the Nyquist bin
# the wideband bank (12 taps a branch, the JAX package's) folds a carrier
# two bins away in at -31.8 dB: at most this share of frames may differ
WB_BAD_SHARE = 1e-3
# decode_block against decode_block_host on the C4FM block: the host path
# synthesizes from float16 amplitudes and its float32 w0 comes from a
# float64 recurrence, so its phase drifts from the device path's over a
# 3 s block; the JAX package's own pair differs by 2.82e-2 of the peak
# on this generator's blocks (tests/test_torch_voicebatch_host.py), the
# JAX contract's 2e-2 holding on its shorter fixture only
HOST_PCM_REL = 3e-2
# kernel names in a profile
# phase 12, the multi-GPU slice: systems of the sharded fleet; the
# capacity (candidates a channel) of each channel step, enough for every
# sync a 3 s block holds (P2: about a third of its 72 sync matches);
# each fleet mode's (max_tsdus, max_ldus) as tests/test_trunkmesh.py
# sizes them, but p25p1's LDUs (the bench call's other frames outscore
# its LDUs in four top places of a 1 s block) and p25_mixed's, which
# holds both slots' grants and every sync match of a 1 s block; the Phase 2 band's WACN, SYSID, NAC; the P25 systems held
# to the single-device fleet; the systems held to the CPU path
MESH_S = 64
MESH_K = {"voice": 24, "dmr_voice": 24, "p2_voice": 32, "p25_cc": 64}
MESH_FLEET_K = {"p25p1": (4, 8), "dmr": (8, 8), "nxdn48": (8, 12),
                "edacs": (8, 2), "p25_mixed": (16, 24)}
MESH_P2 = (0x92065, 0x0D5, 0x293)
MESH_SINGLE = 8
MESH_CPU_S = 2
OURS = ("fir_disc", "imbe_pred", "adpcm_enc", "rs_syndromes", "p25_trellis",
        "conv_k5", "conv_k3", "one_pole")


def log(*a) -> None:
    print(*a, flush=True)


def k7_mma_table(n: int, nroots: int, fcr: int):
    """The matrix H of K7's int8-mma design (csrc/alt/rs_syndromes_mma.cu),
    as its lanes read it: uint8 [roots padded to 28, 6 * JP / 32 k-steps,
    32 lanes, 2 registers, 4 bytes], JP = 32 or 64 symbols.  Row
    (b, j), k-step s = JP/32 * b + j // 32, is bit b of symbol j; column
    (i, o) bit o of S_i: bit o of alpha^(b + (n-1-j)(fcr+i)); lane 4g + t
    holds k = 4t .. 4t + 3 and 16 + 4t .. of column o = g."""
    import numpy as np
    from dsdneo_tpu_torch.fec.rs import gf64_tables
    spb = 1 if n <= 32 else 2
    R = -(-nroots // 28) * 28
    gexp, _ = gf64_tables()
    b, j, i, o = np.ix_(np.arange(6), np.arange(32 * spb), np.arange(R),
                        np.arange(8))
    h = (((gexp[(b + (n - 1 - j) * (fcr + i)) % 63] >> np.minimum(o, 5)) & 1)
         * (j < n) * (i < nroots) * (o < 6))
    i, s, lane, reg, t = np.ix_(np.arange(R), np.arange(6 * spb),
                                np.arange(32), np.arange(2), np.arange(4))
    jj = (s % spb) * 32 + reg * 16 + (lane & 3) * 4 + t
    return np.ascontiguousarray(h[s // spb, jj, i, lane >> 2]
                                .astype(np.uint8))


def par_block(fn, tv, leads, seeds, n_samples: int, **kw):
    """``fn(tv, leads, seeds, n_samples, **kw)``, a ``[C, n, 2]`` block
    that ``fn`` builds channel by channel (a ``vector_block``), built over
    chunks of channels in a pool of threads (numpy's array work releases
    the GIL) and joined: bit for bit the block of one call."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor
    k = os.cpu_count() or 1
    leads, seeds = np.asarray(leads), np.asarray(seeds)
    chunks = [ix for ix in np.array_split(np.arange(len(leads)), 2 * k)
              if len(ix)]

    def part(ix):
        kw2 = dict(kw)
        if kw.get("cfo_hz") is not None:
            kw2["cfo_hz"] = np.asarray(kw["cfo_hz"])[ix]
        return fn(tv, leads[ix], seeds[ix], n_samples, **kw2)
    with ThreadPoolExecutor(k) as ex:
        return np.concatenate(list(ex.map(part, chunks)))


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds per call on the card (CUDA events).  The calls
    queue behind a spin of the card, so a kernel shorter than its
    wrapper's host time runs back to back and not at the host's pace."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take (ms) and what sets it."""
    t_mem, t_ops = n_bytes / HBM_BPS * 1e3, flops / FP32_FLOPS * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def sm_clock_mhz() -> float:
    """The card's top SM clock (nvidia-smi), for the recurrence floors."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True, timeout=30)
    return float(out.stdout.split()[0])


def sass_loops(cuobjdump: str, so: str, stem: str,
               whole: bool = False) -> list[str]:
    """The loops of at least 24 instructions (from a backward branch's
    target to its last backward branch) of the first function of library
    ``so`` whose name holds ``stem``, from ``cuobjdump -sass``: the size
    and instruction mix of each; with ``whole``, first the function's."""
    import collections
    import re
    import subprocess
    text = subprocess.run([cuobjdump, "-sass", so], check=True,
                          capture_output=True, text=True).stdout
    ops, cur = [], False
    for line in text.splitlines():
        if "Function :" in line:
            cur = stem in line and not ops
        elif cur and (m := re.search(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;",
                                     line)):
            ops.append((int(m.group(1), 16), m.group(2)))
    ends = {}                       # loop head -> its last backward branch
    for a, op in ops:
        m = re.search(r"\bBRA (0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) <= a:
            ends[int(m.group(1), 16)] = a
    def mix(body, top):
        c = collections.Counter(re.sub(r"^@!?U?P[0-9T]+\s+", "", op).split()[0]
                                for op in body)
        return ", ".join(f"{k} {v}" for k, v in c.most_common(top))

    out = ([f"whole function: {len(ops)} instructions ("
            + mix([op for _a, op in ops], 12) + ")"] if whole else [])
    for lo, hi in sorted(ends.items()):
        body = [op for a, op in ops if lo <= a <= hi]
        if len(body) >= 24:
            out.append(f"loop at 0x{lo:x}: {len(body)} instructions ("
                       + mix(body, 8) + ")")
    return out or [f"no loop of 24 instructions ({len(ops)} in all)"]


def no_reference_modules() -> None:
    """Fail if JAX or any module of the JAX package was imported."""
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "jaxlib", "dsdneo_tpu")
                 or m.startswith(("jax.", "jaxlib.", "dsdneo_tpu.")))
    if bad:
        raise RuntimeError(f"the port imported {bad[:8]}")


def check_pcm(label: str, pcm, limit: float | None = None):
    """PCM finite, every channel non-silent, and within ±``limit`` where
    one is given; returns the per-channel rms."""
    import numpy as np
    if not np.isfinite(pcm).all():
        raise RuntimeError(f"{label}: non-finite PCM")
    rms = np.sqrt(np.mean(pcm.astype(np.float64) ** 2, axis=1))
    if not (rms > 1e-3).all():
        raise RuntimeError(f"{label}: silent channels "
                           f"{np.flatnonzero(rms <= 1e-3)[:8]}")
    if limit is not None and float(np.abs(pcm).max()) > limit:
        raise RuntimeError(f"{label}: |pcm| reaches "
                           f"{float(np.abs(pcm).max()):.6f} > {limit:.6f}")
    return rms


def check_launches(label: str, counted, runs, idle) -> dict:
    """The counters after a path: every kernel in ``runs`` launched, every
    kernel in ``idle`` not (it would mean another front end or vocoder
    ran than the path names)."""
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"{label}: launches during the path: {launches}")
    for fn in runs:
        if fn.launches < 1:
            raise RuntimeError(f"{label}: kernel {fn.__name__} was not "
                               "launched on the path")
    for fn in idle:
        if fn.launches:
            raise RuntimeError(f"{label}: kernel {fn.__name__} is not on "
                               f"this path but was launched {fn.launches}x")
    return launches


def time_path(label: str, ident: str, pipe, blocks, block_s: float, pick,
              part=None):
    """The pipelined loop of the JAX package's bench over ``N_TIMED``
    blocks, the stage split of one block, and a profile of two blocks.
    ``pick(pipe, fe6)`` is the path's host picker; ``part``, where given,
    is (name, fn): ``fn(pipe)``, read after the split's decode, returns
    the seconds of a part of "pick + voice decode" that the pipeline
    times itself, and a line on it.  Returns the step in seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pipe.fetch_pcm(pipe.decode_block_async(blocks[0]))      # warm
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fe = pipe.frontend_dispatch(blocks[0])
    prev = None
    for i in range(N_TIMED):
        fe_next = pipe.frontend_dispatch(blocks[(i + 1) % 2])
        h = pipe.decode_from_frontend(pipe.frontend_finish(fe))
        if prev is not None:
            pipe.fetch_pcm(prev)
        prev = h
        fe = fe_next
    pipe.fetch_pcm(prev)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / N_TIMED
    log(f"{label} pipelined step ({ident}): {step_s * 1e3:.1f} ms per "
        f"{block_s:.4g} s block of {C} channels = "
        f"{C * block_s / step_s:.1f}x realtime")

    # stage split of one block, each stage synchronized
    stages = {}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fe = pipe.frontend_dispatch(blocks[1])
    torch.cuda.synchronize()
    stages["front end + sync"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    fe6 = pipe.frontend_finish(fe)
    stages["candidates to host"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    pick(pipe, fe6)
    stages["pick (host)"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    h = pipe.decode_from_frontend(fe6)
    torch.cuda.synchronize()
    stages["pick + voice decode"] = time.perf_counter() - t1
    note = ""
    if part is not None:
        sec, line = part[1](pipe)
        stages[f"of which {part[0]}"] = sec
        note = f"; {part[0]}: {line}"
    t1 = time.perf_counter()
    pipe.fetch_pcm(h)
    stages["PCM to host + expand"] = time.perf_counter() - t1
    log(f"{label} stages (ms): " + ", ".join(f"{k} {v * 1e3:.1f}"
                                            for k, v in stages.items())
        + note)

    # device time by kernel and busy share over two blocks
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(2):
            pipe.fetch_pcm(pipe.decode_block_async(blocks[i]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    dev_us, dev_n = {}, {}
    for e in prof.key_averages():            # device-side events only
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            key = next((k for k in OURS if f"{k}_kernel" in e.key), e.key)
            dev_us[key] = dev_us.get(key, 0.0) + e.self_device_time_total
            dev_n[key] = dev_n.get(key, 0) + e.count
    busy_ms = sum(dev_us.values()) / 2e3                    # per block
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    log(f"{label} profile, 2 blocks: device busy {busy_ms:.1f} ms per block "
        f"= {100 * busy_ms / (step_s * 1e3):.1f}% of the unprofiled "
        f"pipelined step ({step_s * 1e3:.1f} ms); profiled wall "
        f"{wall_ms / 2:.1f} ms per block (the profiler's overhead "
        f"included); per block: "
        + ", ".join(f"{k[:40]} {v / 2e3:.3f} ms" for k, v in top))
    # the port's kernels by name, top 12 or not: device time per launch
    # on the path itself, a reading that does not depend on cuda_ms
    log(f"{label} profile, 2 blocks, the port's kernels: " + ", ".join(
        f"{k} {dev_n[k]} launches, {dev_us[k] / dev_n[k] / 1e3:.4f} ms "
        f"per launch" if dev_n.get(k) else f"{k} not in the profile"
        for k in OURS))
    return step_s


def cc_groups(kind: str, evs) -> dict:
    """One channel's events of one block → {sync position: [lines]} of
    the blocks it parsed, without CRC-error lines.  P25: the TSBK lines
    of a TSDU (its header dropped); DMR: a CSBK's events; NXDN: a CAC's
    catalog events come before its Sync line, some at position 0, so the
    events are grouped up to each Sync line."""
    out, cur = {}, []
    for e in evs:
        if "CRC ERR" in e.line:
            continue
        if kind == "nxdn48":
            cur.append(e.line)
            if e.line.startswith("Sync: NXDN CC"):
                out[e.pos], cur = cur, []
        elif not (kind == "p25" and e.line.startswith("Sync:")):
            out.setdefault(e.pos, []).append(e.line)
    return out


def cc_expected(kind: str, ct, tv, lead: int, n_sym: int):
    """The vector's blocks a channel's block holds whole after ``lead``
    dibits: {sync position: (vector indices of its whole blocks, all
    blocks whole)}.  P25: TSDU j at s is accepted when its first trellis
    block is whole, and its block b is whole when s + need_b < n_sym;
    DMR: a burst at t >= 54 with t + 78 < n_sym; NXDN: t + 192 < n_sym."""
    out = {}
    for j, st in enumerate(tv["starts"].tolist()):
        t = lead + st
        if kind == "p25":
            need = ct.np["tsdu_offsets"].max(axis=1) + 1
            whole = [3 * j + b for b in range(3) if t + need[b] < n_sym]
            if whole:
                out[t] = (whole, len(whole) == 3)
        elif kind == "dmr":
            if t >= 54 and t + 78 < n_sym:
                out[t] = ([j], True)
        elif t + 192 < n_sym:
            out[t] = ([j], True)
    return out


def serial_phase(ident: str, dev, block, counted) -> dict:
    """Phase 8: the serial front end at the C4FM cell's block, then
    ``decode_samples`` on the card over the 60 s streams of
    ``data/serial_tables.npz`` (P25p1 C4FM and CQPSK, EDACS + ProVoice,
    DMR upright and inverted, X2-TDMA, NXDN48, NXDN96, dPMR, YSF,
    D-STAR, M17, P25p2 with its parameters and blind), each judged whole
    and its first 10 s (5 s for the streams before M17 and P25p2) held
    to the CPU path; ``"auto"`` on each family's
    probe against the CPU's pick; ``decode_capture`` of a 96 kHz
    capture; returns the kernels' launches during the phase."""
    import tempfile

    import numpy as np
    import torch
    from dsdneo_tpu_torch.dsp.resampler import resample
    from dsdneo_tpu_torch.engine import decoder as sdec
    from dsdneo_tpu_torch.engine import demod as sdemod
    from dsdneo_tpu_torch.engine import serialvec as SV
    from dsdneo_tpu_torch.io import IqMetadata, write_iq_capture
    from dsdneo_tpu_torch.vocoder import codec2, synth
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()

    # demod_fm's step at [320, 144000]: the card against the CPU path on
    # channels 0-1, dibits off the slicer's thresholds
    taps = torch.as_tensor(sdemod._taps_for("p25_c4fm", FS), device=dev)
    n_sym = int((block.shape[1] - 2 * 10) // 10)

    def step():
        return sdemod.demod_fm_step(block, taps, 10.0, True, n_sym)

    gd, gs, _p = step()
    cd, cs, _p = sdemod.demod_fm_step(block[:2].cpu(), taps.cpu(), 10.0,
                                      True, n_sym)
    gd2, gs2 = gd[:2].cpu().numpy(), gs[:2].cpu().numpy()
    off = np.min(np.abs(np.abs(cs.numpy())[..., None]
                        - np.array([0.0, 2.0])), axis=-1) > 0.05
    bad = int((gd2 != cd.numpy())[off].sum())
    if bad:
        raise RuntimeError(f"demod_fm at {list(block.shape[:2])}: {bad} "
                           "dibits off the thresholds differ from the CPU "
                           "path on channels 0-1")
    ms = cuda_ms(step, 5)
    x_np = torch.view_as_complex(block.contiguous()).cpu().numpy()
    t1 = time.perf_counter()
    sdemod.demod_fm(x_np, "p25p1", FS, device=dev)
    wall = (time.perf_counter() - t1) * 1e3
    log(f"serial: demod_fm at [{block.shape[0]}, {block.shape[1]}] "
        f"(the C4FM cell's block): {ms:.3f} ms on the card for the step "
        f"(CUDA events), {wall:.1f} ms for the call with the host copies; "
        f"channels 0-1 equal to the CPU path on {int(off.sum())} dibits off "
        f"the thresholds (soft within {np.abs(gs2 - cs.numpy()).max():.2e}) "
        f"[{ident}]")
    del gd, gs, x_np

    # the split of decode_samples: the front end (the demod call, on the
    # card), the synthesis (the voice frames' synthesize_frames, on the
    # card; M17's Codec2 decode, on the host) and the host walk (the rest)
    spent = {"front": 0.0, "synth": 0.0}
    c2_ok = codec2.available()
    log(f"serial: libcodec2 {'loads' if c2_ok else 'does not load'} here"
        + ("" if c2_ok else ": M17 is judged on its Codec2 payload bits and "
           "emits no PCM") + f" [{ident}]")

    def timed(key, fn):
        def wrap(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t
        return wrap

    real = (sdec.demod_fm, sdec.demod_cqpsk_path, synth.synthesize_frames,
            codec2.Codec2.decode)
    sdec.demod_fm = timed("front", real[0])
    sdec.demod_cqpsk_path = timed("front", real[1])
    synth.synthesize_frames = timed("synth", real[2])
    codec2.Codec2.decode = timed("synth", real[3])
    tv = SV.vector()
    dmr_kw = {"state_attrs": {"dmr_bp_key_id": int(tv["dmr_ids"][4])}}

    def decode(xs, mode, cq, where, kw=None):
        """One decode_samples call: (ctx, its voice-bit sinks, wall s,
        the split)."""
        for k in spent:
            spent[k] = 0.0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ctx, sinks = SV.decode_spied(xs, mode, cqpsk=cq,
                                     keyring=SV.keyring(tv), device=where,
                                     **(kw or {}))
        return ctx, sinks, time.perf_counter() - t1, dict(spent)


    streams = (
        ("P25p1 C4FM call", "p25p1", False, lambda: SV.p25_iq(tv),
         4800 * SV.P25_SPS, None),
        ("P25p1 CQPSK call", "p25p1", True,
         lambda: SV.p25_iq(tv, cqpsk=True), 4800 * SV.P25_SPS, None),
        ("EDACS + ProVoice", "provoice", False, lambda: SV.pv_iq(tv),
         9600 * SV.PV_SPS, None),
        ("DMR BS call", "dmr", False, lambda: SV.dmr_iq(tv),
         4800 * SV.DMR_SPS, dmr_kw),
        ("X2-TDMA", "x2tdma", False, lambda: SV.x2_iq(tv),
         6000 * SV.X2_SPS, None),
        ("NXDN48", "nxdn48", False, lambda: SV.nxdn_iq(tv, mode="nxdn48"),
         2400 * SV.NXDN_SPS["nxdn48"], None),
        ("NXDN96", "nxdn96", False, lambda: SV.nxdn_iq(tv, mode="nxdn96"),
         4800 * SV.NXDN_SPS["nxdn96"], None),
        ("dPMR", "dpmr", False, lambda: SV.dpmr_iq(tv),
         2400 * SV.DPMR_SPS, None),
        ("YSF", "ysf", False, lambda: SV.ysf_iq(tv), 4800 * SV.YSF_SPS,
         None),
        ("D-STAR", "dstar", False, lambda: SV.dstar_iq(tv),
         4800 * SV.DSTAR_SPS, None),
        ("M17", "m17", False, lambda: SV.m17_iq(tv), 4800 * SV.M17_SPS,
         {"state_attrs": SV.m17_attrs(tv)}),
        ("P25p2 clear + ADP", "p25p2", False, lambda: SV.p2_iq(tv),
         6000 * SV.P2_SPS, {"p2_params": SV.p2_params(tv)}))
    try:
        for name, mode, cq, make, per_s, attrs in streams:
            x = make()
            # the card against the CPU over the first 10 s of the streams
            # this slice added, 5 s of the older ones (the script's time)
            win_s = 10 if mode in ("m17", "p25p2") else 5
            n10 = win_s * per_s
            secs = len(x) / FS
            out = {}
            for where, xs in (("card", x), ("cpu10", x[:n10]),
                              ("card10", x[:n10])):
                out[where] = decode(xs, mode, cq,
                                    "cpu" if where == "cpu10" else dev,
                                    attrs)
            ctx, sinks, wall, sp = out["card"]
            got = SV.judge(mode, tv, ctx, sinks)
            pcm = np.concatenate([SV.pcm(ctx, s) for s in sorted(ctx.audio)]
                                 or [np.zeros(0, np.float32)])
            # ProVoice's IMBE-7100 frames and D-STAR's 3600x2400 ones are
            # not synthesized, nor M17's Codec2 without libcodec2
            if mode not in ("provoice", "dstar") and (mode != "m17"
                                                      or c2_ok):
                if not (np.isfinite(pcm).all() and np.abs(pcm).max() > 0.05):
                    raise RuntimeError(f"serial {name}: PCM not finite or "
                                       "silent")
            diff = SV.events_equal(out["cpu10"][0].events,
                                   out["card10"][0].events)
            if diff is not None:
                raise RuntimeError(f"serial {name}: the card's first "
                                   f"{win_s} s differ from the CPU path: "
                                   f"{diff}")
            c10, g10 = out["cpu10"][0], out["card10"][0]
            if sorted(c10.audio) != sorted(g10.audio):
                raise RuntimeError(f"serial {name}: the card's first "
                                   f"{win_s} s carry PCM on other slots")
            worst = 0.0
            for slot in c10.audio:
                a, b = SV.pcm(c10, slot), SV.pcm(g10, slot)
                if mode == "m17" and a.shape == b.shape:
                    # libcodec2's noise generator is one for the process:
                    # M17's PCM compares in fresh processes, below
                    continue
                if a.shape != b.shape or (a.size and np.abs(a - b).max()
                                          > 2e-3 * np.abs(a).max()):
                    raise RuntimeError(f"serial {name}: the card's first "
                                       f"{win_s} s PCM of slot {slot} is not "
                                       "within 2e-3 of the peak of the CPU "
                                       "path's")
                if a.size:
                    worst = max(worst, float(np.abs(a - b).max()))
            if not SV.sinks_equal(out["cpu10"][1], out["card10"][1]):
                raise RuntimeError(f"serial {name}: the card's first "
                                   f"{win_s} s voice bits differ from the "
                                   "CPU path's")
            if mode == "m17" and c2_ok:
                a = SV.m17_pcm_fresh(10 * 4800, "cpu")
                b = SV.m17_pcm_fresh(10 * 4800, "cuda")
                if a.shape != b.shape or not a.size or (
                        np.abs(a - b).max() > 2e-3 * np.abs(a).max()):
                    raise RuntimeError(f"serial {name}: the card's first 10 "
                                       "s PCM, decoded in a fresh process, "
                                       "is not within 2e-3 of the peak of "
                                       "the CPU path's")
                worst = float(np.abs(a - b).max())
            n10_pcm = sum(len(SV.pcm(g10, s)) for s in g10.audio)
            n_voice = sum(len(getattr(s, "bits", ())) for s in sinks)
            walk = wall - sp["front"] - sp["synth"]
            # device busy over the window, against its unprofiled wall (on
            # three streams: the script's time)
            if name in SERIAL_PROFILED:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    decode(x[:n10], mode, cq, dev, attrs)
                    torch.cuda.synchronize()
                dev_us = {}
                for e in prof.key_averages():
                    if (e.device_type == DeviceType.CUDA
                            and e.self_device_time_total > 0):
                        dev_us[e.key] = (dev_us.get(e.key, 0.0)
                                         + e.self_device_time_total)
                busy = sum(dev_us.values()) / 1e3
                top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:5]
                w10 = out["card10"][2] * 1e3
                log(f"serial {name} profile, first {win_s} s: device busy "
                    f"{busy:.1f} ms = {100 * busy / w10:.1f}% of the "
                    f"unprofiled decode ({w10:.1f} ms), idle "
                    f"{100 - 100 * busy / w10:.1f}%; top: "
                    + ", ".join(f"{k[:40]} {v / 1e3:.2f} ms"
                                for k, v in top) + f" [{ident}]")
            log(f"serial {name}: {secs:.1f} s decoded on the card in "
                f"{wall:.3f} s = {secs / wall:.2f}x realtime; split: front "
                f"end {sp['front'] * 1e3:.1f} ms, host walk "
                f"{walk * 1e3:.1f} ms, synthesis {sp['synth'] * 1e3:.1f} ms "
                f"({n_voice} voice frames); {len(ctx.events)} events;"
                f" judged: {got}; PCM {pcm.size} samples, peak "
                f"{float(np.abs(pcm).max()) if pcm.size else 0.0:.3f}; the "
                f"first {win_s} s equal to the CPU path ({n10_pcm} PCM "
                f"samples "
                f"within {worst:.2e}); the CPU path took "
                f"{out['cpu10'][2]:.3f} s for {win_s} s [{ident}]")
            if mode == "dmr":
                # the same stream on an inverted channel, read under the
                # inverted expectation: DMR's inverted syncs are the other
                # burst type's, so every hit is reinterpreted as its twin
                # (its first 20 s: the script's time)
                inv = {"state_attrs": {**attrs["state_attrs"],
                                       "force_polarity": {"dmr": True}}}
                n20 = 20 * 4800
                ctx, sinks, wall, sp = decode(
                    SV.dmr_iq(tv, n20, invert=True), mode, cq, dev, inv)
                got = SV.judge(mode, tv, ctx, sinks, n20, invert=True)
                log(f"serial {name}, inverted channel with force_polarity: "
                    f"20.0 s decoded on the card in {wall:.3f} s = "
                    f"{20 / wall:.2f}x realtime; judged: {got} "
                    f"[{ident}]")
            if mode == "p25p2":
                # blind, the first 20 s: the scramble parameters recovered
                # from the RS parity of the first scrambled SACCH burst
                n20 = 20 * per_s
                ctx, sinks, wall, sp = decode(x[:n20], mode, cq, dev)
                got = SV.judge(mode, tv, ctx, sinks, n20 // SV.P2_SPS,
                               blind=True)
                secs = n20 / FS
                log(f"serial {name}, blind (no p2_params): {secs:.1f} s "
                    f"decoded on the card in {wall:.3f} s = "
                    f"{secs / wall:.2f}x realtime; split: front end "
                    f"{sp['front'] * 1e3:.1f} ms, host walk "
                    f"{(wall - sp['front'] - sp['synth']) * 1e3:.1f} ms, "
                    f"synthesis {sp['synth'] * 1e3:.1f} ms; judged: {got} "
                    f"[{ident}]")

        # decode_samples(..., "auto") on the card on a 4 s probe of each
        # family's stream: its pick equal to the JAX detect_mode's, stored
        # beside the streams (a CPU test holds the port's CPU picks to it)
        picks, t_card = {}, 0.0
        for fam in SV.AUTO_FAMILIES:
            x = SV.auto_probe(tv, fam)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ctx = sdec.decode_samples(x, "auto", device=dev,
                                      keyring=SV.keyring(tv),
                                      state_attrs=SV.m17_attrs(tv))
            t_card += time.perf_counter() - t1
            if ctx.mode_name != SV.auto_pick(tv, fam):
                raise RuntimeError(
                    f"serial auto, {fam} probe: the card picks "
                    f"{ctx.mode_name!r}, the stored pick is "
                    f"{SV.auto_pick(tv, fam)!r}")
            picks[fam] = (ctx.mode_name, len(ctx.events))
        log(f"serial auto: decode_samples(..., 'auto') on the card on a 4 s "
            f"probe of each family's stream picks the stored JAX pick: "
            f"{picks}; {t_card:.3f} s on the card for the 11 (the "
            f"detection's 10 demod configurations each, then the decode) "
            f"[{ident}]")

        # decode_capture: the P25 call raised to 96 kHz by the resampler on
        # the card, written as a cs16 capture, decoded back at 48 kHz
        x = SV.p25_iq(tv)
        secs = len(x) / FS
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        x96 = resample(torch.from_numpy(x).to(dev), int(FS), 96000)
        torch.cuda.synchronize()
        t_rs = time.perf_counter() - t1
        x96 = 0.5 * x96.cpu().numpy()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "p25_c4fm_96k.iq")
            path10 = os.path.join(tmp, "p25_c4fm_96k_5s.iq")
            for p, xs in ((path, x96), (path10, x96[:480000])):
                write_iq_capture(p, xs, IqMetadata(sample_format="cs16",
                                                   sample_rate_hz=96000))
            cap = {}
            for key, p, where in (("card", path, dev),
                                  ("card10", path10, dev),
                                  ("cpu10", path10, "cpu")):
                sink = SV.ImbeSink()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ctx = sdec.decode_capture(p, "p25p1", keyring=SV.keyring(tv),
                                          mbe_sink=sink, device=where)
                cap[key] = (ctx, sink, time.perf_counter() - t1)
        ctx, sink, wall = cap["card"]
        got = SV.judge_p25(tv, ctx, sink)
        c10, g10 = cap["cpu10"][0], cap["card10"][0]
        diff = SV.events_equal(c10.events, g10.events)
        a, b = SV.pcm(c10), SV.pcm(g10)
        if diff is not None or a.shape != b.shape or (
                np.abs(a - b).max() > 2e-3 * np.abs(a).max()):
            raise RuntimeError("serial decode_capture: the card's first 5 s "
                               f"differ from the CPU path: {diff}")
        log(f"serial decode_capture: the P25 call ({secs:.1f} s) resampled "
            f"48 -> 96 kHz on the card in {t_rs * 1e3:.1f} ms, written as a "
            f"cs16 capture and decoded on the card (resampled back to 48 kHz "
            f"there) in {wall:.3f} s = {secs / wall:.2f}x realtime; judged: "
            f"{got}; its first 5 s equal to the CPU path's (events, PCM "
            f"within {np.abs(a - b).max():.2e}; the CPU path "
            f"{cap['cpu10'][2]:.3f} s) [{ident}]")
    finally:
        (sdec.demod_fm, sdec.demod_cqpsk_path, synth.synthesize_frames,
         codec2.Codec2.decode) = real
    peak = torch.cuda.max_memory_allocated()
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"serial phase: peak device memory {peak / 1e9:.3f} GB "
        f"({mem0 / 1e9:.3f} GB allocated before the phase); launches of "
        f"K1-K8 during the phase: {launches} (all 0: the serial path "
        f"reaches no kernel of the table, as in the JAX package) [{ident}]")
    return launches


def device_busy(fn, n: int) -> tuple[float, dict]:
    """Device time per call of ``fn`` over ``n`` calls under
    torch.profiler (ms), and the largest device operations (ms a call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_us = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            key = next((k for k in OURS if f"{k}_kernel" in e.key), e.key)
            dev_us[key] = dev_us.get(key, 0.0) + e.self_device_time_total
    top = dict(sorted(((k, v / n / 1e3) for k, v in dev_us.items()),
                      key=lambda kv: -kv[1])[:6])
    return sum(dev_us.values()) / n / 1e3, top


def fleet_split(fleet, block) -> str:
    """One step of a P25 fleet with the device pick taken apart, each
    stage synchronized: the rows (bank, NCO, halfband), the device pick
    and its blob to the host, the host parse, the voice rows' front end
    and candidates to the host, the pick and voice decode, the PCM to
    the host.  The fleet's control plane does not advance."""
    import torch
    t, out = time.perf_counter(), {}

    def lap(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        out[name] = (now - t) * 1e3
        t = now

    cc_rows, vc_rows, _v2, _s = fleet._rows(block)
    lap("rows")
    fetched = [a.cpu().numpy() for a in
               fleet._cc_body(int(cc_rows.shape[1]))(cc_rows)]
    lap("device pick + blob to host")
    n = fleet._cc_events_from_blob(*fetched)
    lap(f"host parse ({n} TSBKs)")
    fe = fleet.vc_pipe.frontend_finish(fleet.vc_pipe.frontend_dispatch(
        vc_rows))
    lap("voice front end + candidates to host")
    h = fleet.vc_pipe.decode_from_frontend(fe)
    lap("pick + voice decode")
    fleet.vc_pipe.fetch_pcm(h)
    lap("PCM to host")
    return ", ".join(f"{k} {v:.1f}" for k, v in out.items())


def fleet_phase(ident: str, dev, counted, show, check_k1, check_k3,
                three_tones, tables) -> dict:
    """Phase 9: the wideband band and the closed-loop trunked fleet
    (``engine.wideband``, ``engine.fleettrunk``); returns the kernels'
    launches by path."""
    import numpy as np
    import torch
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.dsp.channelizer import channel_frequencies
    from dsdneo_tpu_torch.engine import fleetvec as FV
    from dsdneo_tpu_torch.engine.fleettrunk import TrunkedFleet
    from dsdneo_tpu_torch.engine.trunk import ChannelMap
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu_torch.engine.wideband import (
        channelize_band_device, decode_wideband_voice_batched)
    from dsdneo_tpu_torch.fec import device as fdev
    from dsdneo_tpu_torch.protocol.p25 import encode
    from dsdneo_tpu_torch.vocoder import device as vdev
    k1fn, k2fn, k3fn, k7fn, k4fn, k5fn, k6fn, k8fn = counted
    launches = {}
    rng = np.random.default_rng(SEED + 9)

    def reset():
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # -- the wideband cell: 256 channels of a 12.288 MHz band --------------
    fs_w = WB_CH * FS
    n_w = int(fs_w * BLOCK_S)
    tv = tables.test_vector()
    freqs = channel_frequencies(WB_CH, fs_w)
    loaded = [k for k in range(WB_CH) if k not in WB_EMPTY]
    leads = dict(zip(loaded, rng.integers(30, len(tv["lead"]) + 1,
                                          len(loaded)).tolist()))
    n_sym = int(BLOCK_S * 4800) - 2
    t1 = time.perf_counter()
    wb_blocks = []
    for blk in range(2):
        seeds = rng.permutation(1 << 20)[:len(loaded)]
        parts = [(encode.c4fm_iq(encode.vector_stream(tv, leads[k],
                                                       n_sym + 2),
                                 seed=int(s)), int(freqs[k]))
                 for k, s in zip(loaded, seeds)]
        wb_blocks.append(FV.place(parts, fs_w, n_w, device=dev))
    torch.cuda.synchronize()
    log(f"wideband: {WB_CH} channels of a {fs_w / 1e6:.3f} MHz band, "
        f"{len(loaded)} loaded with P25 C4FM voice (own lead and noise, "
        f"30 dB), bins {sorted(WB_EMPTY)} empty; two {BLOCK_S:g} s blocks "
        f"of {n_w} samples built on the card in "
        f"{time.perf_counter() - t1:.1f} s [{ident}]")

    def judge_wb(pipe, label):
        """Every loaded channel accepts every LDU its block holds whole,
        consecutive, with the vector's IMBE bits but for at most
        ``WB_BAD_SHARE`` of the frames (the bank's fold two bins away,
        ROADMAP queue 3); the empty bins accept none.  Returns (LDUs,
        frames whose bits differ)."""
        bits, _errs, fch, forder = pipe.last_frames
        bits = bits.cpu().numpy()
        n_ldu = n_bad = 0
        for k in range(WB_CH):
            sel = np.flatnonzero(fch == k)
            fb = bits[sel[np.argsort(forder[sel], kind="stable")]]
            if k in WB_EMPTY:
                if fb.size:
                    raise RuntimeError(f"{label}: empty bin {k} accepted "
                                       f"{fb.shape[0] // 9} LDUs")
                continue
            n, bad = FV.judge_ldus(fb, tv["bits88"],
                                   leads[k] + tv["ldu_starts"], 0, n_sym,
                                   pipe._ldu_need, max_bad=9)
            n_ldu += n
            n_bad += bad
        if n_bad > WB_BAD_SHARE * 9 * n_ldu:
            raise RuntimeError(f"{label}: {n_bad} of {9 * n_ldu} frames' "
                               "IMBE bits differ from the vector")
        return n_ldu, n_bad

    wb_pcm = {}
    reset()
    for fmt in ("adpcm", "f16"):
        pipe = None
        for blk in range(2):
            if pipe is None:
                pipe = BatchedP25VoicePipeline(WB_CH, FS, pcm_fmt=fmt,
                                               device=dev, tables=tables)
            pcm, _f = decode_wideband_voice_batched(wb_blocks[blk], fs_w,
                                                    WB_CH, pcm_fmt=fmt,
                                                    pipe=pipe, device=dev)
            n_ldu, n_bad = judge_wb(pipe, f"wideband {fmt} block {blk}")
            if not np.isfinite(pcm).all():
                raise RuntimeError("wideband: non-finite PCM")
            quiet = np.abs(pcm[sorted(WB_EMPTY)]).max(initial=0.0)
            log(f"wideband {fmt} block {blk}: {len(loaded)} loaded channels "
                f"accept every LDU their block holds whole ({n_ldu} LDUs); "
                f"{9 * n_ldu - n_bad} of {9 * n_ldu} frames' IMBE bits equal "
                f"the vector's, {n_bad} differ (the fold two bins away); "
                f"the empty bins accept none (|pcm| {quiet:.2e}); PCM "
                f"{pcm.shape}")
            wb_pcm[fmt, blk] = pcm[:2]
            if fmt == "f16" and blk == 0:
                carry = [None if st is None else tuple(t[:2].cpu()
                                                       for t in st)
                         for st in pipe.voice_state()]
    launches["wideband"] = check_launches(
        "wideband", counted, (k1fn, k2fn, k3fn),
        (k7fn, k4fn, k5fn, k6fn, k8fn))
    peak = torch.cuda.max_memory_allocated()
    # channels 0-1 against the CPU path: the whole band channelized on
    # the CPU, those two rows through the CPU pipeline
    cpu_pipe = BatchedP25VoicePipeline(2, FS, pcm_fmt="f16", device="cpu",
                                       tables=params.load("cpu"))
    worst = 0.0
    t1 = time.perf_counter()
    for blk in range(2):
        if blk == 1:
            cpu_pipe.set_voice_state(*carry)
        ch, _f = channelize_band_device(wb_blocks[blk].cpu(), fs_w, WB_CH,
                                        device="cpu")
        want = cpu_pipe.decode_block(torch.view_as_real(ch[:2]))
        got = wb_pcm["f16", blk]
        if want.shape != got.shape or not (
                np.abs(got - want).max() <= 2e-3 * np.abs(want).max()):
            raise RuntimeError(f"wideband block {blk}: channels 0-1 differ "
                               "from the CPU path")
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"wideband channels 0-1 card vs CPU path (the band channelized "
        f"whole on the CPU, f16, two blocks): max abs err {worst:.3e} "
        f"(tol 2e-3 * peak); the CPU path took "
        f"{time.perf_counter() - t1:.1f} s")
    del cpu_pipe, ch
    # timed: the headline (adpcm), a fresh pipeline, the blocks in turn
    pipe = BatchedP25VoicePipeline(WB_CH, FS, pcm_fmt="adpcm", device=dev,
                                   tables=tables)

    def wb_step(i):
        return decode_wideband_voice_batched(wb_blocks[i % 2], fs_w, WB_CH,
                                             pcm_fmt="adpcm", pipe=pipe,
                                             device=dev)

    wb_step(0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(N_TIMED):
        wb_step(i)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / N_TIMED
    ch_ms = cuda_ms(lambda: channelize_band_device(
        wb_blocks[0], fs_w, WB_CH, device=dev), 3)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ch = torch.view_as_real(channelize_band_device(wb_blocks[1], fs_w, WB_CH,
                                                   device=dev)[0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    wb_fe = pipe.frontend_finish(pipe.frontend_dispatch(ch))
    t3 = time.perf_counter()
    wb_h = pipe.decode_from_frontend(wb_fe)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    pipe.fetch_pcm(wb_h)
    t5 = time.perf_counter()
    log(f"wideband stages (ms, one block): channelizer {1e3 * (t2 - t1):.1f}, "
        f"front end + sync + candidates to host {1e3 * (t3 - t2):.1f}, pick "
        f"+ voice decode {1e3 * (t4 - t3):.1f}, PCM to host + expand "
        f"{1e3 * (t5 - t4):.1f}")
    del ch, wb_fe, wb_h
    busy_ms, top = device_busy(lambda: wb_step(0), 2)
    log(f"wideband step ({ident}): {step_s * 1e3:.1f} ms per {BLOCK_S:g} s "
        f"block of {WB_CH} channels = {WB_CH * BLOCK_S / step_s:.1f}x "
        f"realtime (adpcm); the channelizer {ch_ms:.2f} ms (CUDA events); "
        f"device busy {busy_ms:.1f} ms per block = "
        f"{100 * busy_ms / (step_s * 1e3):.1f}% of the step; top: "
        + ", ".join(f"{k[:40]} {v:.2f} ms" for k, v in top.items())
        + f"; peak device memory {peak / 1e9:.3f} GB; launches "
        f"{launches['wideband']}")
    # the kernels at the wideband's shapes
    x = torch.view_as_real(channelize_band_device(
        wb_blocks[0], fs_w, WB_CH, device=dev)[0]).contiguous()
    check_k1(x, tables.taps, shape=list(x.shape[:2]))
    Tn = pipe.last_steps
    hold_k2(dev, tables, show, WB_CH, Tn)
    check_k3(three_tones(WB_CH, Tn * 160), shape=[WB_CH, Tn * 160],
             rows=K3_CHECK_ROWS)
    del x, pipe, wb_blocks, wb_pcm
    torch.cuda.empty_cache()

    # -- the trunked fleet, the JAX bench's cell ---------------------------
    ftv = FV.vector()
    u8 = FV.cu8_planes(FV.bench_band(ftv, device=dev)).cpu().numpy()
    nb = int(FV.BENCH_FS)
    blocks = [u8[:nb], u8[nb:2 * nb]]
    bkw = dict(n_voice_rows=4, center_hz=FV.BENCH_CENTER, hangtime_s=5.0,
               grant_grace_s=0.5)

    def bench_fleet(where=dev, pick=True):
        return TrunkedFleet(FV.BENCH_FS, [FV.BENCH_CC_OFF], device=where,
                            cc_device_pick=pick, **bkw)

    reset()
    fleet = bench_fleet()
    pcm0 = fleet.step(blocks[0])
    if not (fleet.stats.grants == 1 and fleet.offs[1] == FV.BENCH_VC_OFF
            and pcm0.shape[1] == 0):
        raise RuntimeError(f"fleet bench cell: block 0 {fleet.stats} "
                           f"{fleet.offs}")
    pcm1 = fleet.step(blocks[1])
    need = fleet.vc_pipe._ldu_need
    n_ldu, _bad = FV.judge_ldus(FV.row_frames(fleet.vc_pipe, 0),
                          ftv["bench_vc_bits88"], ftv["bench_vc_starts"],
                          4800, 4800 - 2, need)
    if np.abs(pcm1[1:]).max() != 0 or not np.abs(pcm1[0]).mean() > 1e-3:
        raise RuntimeError("fleet bench cell: parked rows not silent or the "
                           "granted row silent")
    launches["fleet_bench"] = check_launches(
        "fleet bench cell", counted, (k1fn, k2fn, k4fn),
        (k3fn, k7fn, k5fn, k6fn, k8fn))
    # the host pick, and the CPU path, on the same blocks
    host = bench_fleet(pick=False)
    cpu = bench_fleet("cpu")
    for f in (host, cpu):
        out = [f.step(b) for b in blocks]
        # the refreshes count the TSDUs each pick takes: the host pick
        # also takes those whose later trellis blocks the block end cuts
        same = (f.stats == fleet.stats if f is cpu else
                (f.stats.grants, f.stats.releases, f.stats.unresolved)
                == (fleet.stats.grants, fleet.stats.releases,
                    fleet.stats.unresolved))
        if not (same and f.log == fleet.log
                and f.offs.tolist() == fleet.offs.tolist()):
            raise RuntimeError(f"fleet bench cell: {f.cc_pipe.device} "
                               f"{'device' if f.cc_device_pick else 'host'} "
                               "pick differs")
        a = out[1]
        if f is host and not np.array_equal(a, pcm1):
            raise RuntimeError("fleet bench cell: the host pick's PCM "
                               "differs from the device pick's")
        if f is cpu and not (np.abs(a - pcm1).max()
                             <= 2e-3 * np.abs(a).max()):
            raise RuntimeError("fleet bench cell: PCM differs from the CPU "
                               "path")
    # step_pipelined retargets a block later: on blocks 0, 0, 1 its last
    # block (returned by the flush) is the plain step's block 1
    piped = bench_fleet(pick=False)
    outs = [piped.step_pipelined(blocks[i]) for i in (0, 0, 1)]
    outs.append(piped.flush_pipelined())
    if any(o.shape[1] for o in outs[:3]) or not np.array_equal(outs[3],
                                                               pcm1):
        raise RuntimeError("fleet bench cell: step_pipelined's PCM differs "
                           "from the plain step's a block later")
    log(f"fleet bench cell (768 kHz CU8, CC at -96 kHz, 4 voice rows, "
        f"device pick): 1 grant, row 0 retargeted to +150 kHz, {n_ldu} LDUs "
        f"on it with the vector's IMBE bits, parked rows silent; the host "
        f"pick gives the same grants, log and PCM (bit for bit; grant "
        f"refreshes {host.stats.grant_refreshes} against the device pick's "
        f"{fleet.stats.grant_refreshes}), the CPU "
        f"path the same within 2e-3 * peak; step_pipelined's first voiced "
        f"PCM equals the plain step's one block later")

    def bench_loop(k):
        fleet.step(blocks[0], prefetch=blocks[1])       # prime, uncounted
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(k):
            fleet.step(None, prefetch=blocks[i % 2])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t) / k
        fleet.step(None)
        return dt

    step_s = min(bench_loop(6) for _ in range(3))
    busy_ms, top = device_busy(lambda: fleet.step(blocks[1]), 2)
    log(f"fleet bench cell step ({ident}): {step_s * 1e3:.2f} ms per 1 s "
        f"block (the bench's double-buffered loop, best of 3 x 6) = "
        f"{1 / step_s:.1f}x band realtime, {16 / step_s:.1f}x in 48 kHz "
        f"channels; device busy {busy_ms:.2f} ms per step = "
        f"{100 * busy_ms / (step_s * 1e3):.1f}%; top: "
        + ", ".join(f"{k[:40]} {v:.3f} ms" for k, v in top.items()))
    log(f"fleet bench cell stages (ms, one step): "
        f"{fleet_split(fleet, blocks[1])}")
    rows = fleet._rows(blocks[0])
    check_k1(rows[0].contiguous(), fleet.cc_pipe.cc.front.taps,
             shape=list(rows[0].shape[:2]))
    check_k1(rows[1].contiguous(), fleet.cc_pipe.cc.front.taps,
             shape=list(rows[1].shape[:2]))
    hold_k4(dev, show, 3 * fleet._cc_k, "the device pick's TSDUs")
    del fleet, host, cpu, piped, rows

    # -- the trunked fleet at a size users run: 2.4 MHz, 16 voice rows ----
    band = FV.wide_band(ftv, device=dev)
    nb = int(FV.WIDE_FS)
    u8 = FV.cu8_planes(band).cpu().numpy()
    wblocks = [u8[i * nb:(i + 1) * nb] for i in range(FV.WIDE_SECONDS)]
    del band
    tg_of = {int(t): j for j, t in enumerate(ftv["wide_vc_tgs"])}
    # the row extractor's gain dips from 9 to 19 kHz off a bank bin's
    # centre (-29 dB at 14 kHz; the JAX package's bank, queue 3), and on a
    # 125 kHz raster most carriers meet it: each call's LDUs are counted
    # and their frames held to the vector, and reported with the gain
    offs_v = ftv["wide_vc_offs"]
    gain = np.min([FV.extractor_gain(FV.WIDE_FS, offs_v + d, dev)
                   for d in (-5000, 0, 5000)], axis=0)
    got_ldu = {j: [0, 0, 0] for j in range(len(offs_v))}
    reset()
    fleet = TrunkedFleet(FV.WIDE_FS, ftv["wide_cc_offs"].tolist(), 16,
                         center_hz=FV.WIDE_CENTER, cc_device_pick=True,
                         device=dev)
    t1 = time.perf_counter()
    for b, blk in enumerate(wblocks):
        calls = dict(fleet.calls)
        pcm = fleet.step(blk if b == 0 else None,
                         prefetch=wblocks[b + 1] if b + 1 < len(wblocks)
                         else None)
        for row, call in calls.items():
            j = tg_of[call.tg]
            frames = FV.row_frames(fleet.vc_pipe, row)
            want = ftv["wide_vc_bits88"][j]
            st = ftv["wide_vc_starts"][j]
            rel = st[st < FV.wide_silence(ftv, j)] - 4800 * b
            got_ldu[j][0] += frames.shape[0] // 9
            got_ldu[j][1] += int(sum((want == f).all(-1).any()
                                     for f in frames))
            got_ldu[j][2] += int(((rel >= 16) & (rel + need + 16
                                                 < 4800 - 2)).sum())
        idle = [r for r in range(16) if r not in fleet.calls]
        if pcm.shape[1] and np.abs(pcm[idle]).max(initial=0.0) != 0:
            raise RuntimeError(f"2.4 MHz fleet block {b}: a parked row "
                               "is not silent")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    st = fleet.stats
    kept = sorted(c.tg for c in fleet.calls.values())
    parked = all(fleet.offs[fleet.n_cc + r] == fleet.offs[0]
                 for r in range(16) if r not in fleet.calls)
    if not (st.grants == 12 and st.releases == 6 and st.busy_drops == 0
            and st.unresolved == 0 and parked
            and kept == sorted(ftv["wide_vc_tgs"][0::2].tolist())):
        raise RuntimeError(f"2.4 MHz fleet: {st}, calls {kept}")
    launches["fleet_wide"] = check_launches(
        "2.4 MHz fleet", counted, (k1fn, k2fn, k4fn),
        (k3fn, k7fn, k5fn, k6fn, k8fn))
    peak = torch.cuda.max_memory_allocated()
    rel = [line for line in fleet.log if "RELEASE" in line]
    log(f"2.4 MHz fleet (4 CCs, 16 voice rows, 6 blocks of 1 s, CU8, "
        f"device pick, prefetch): {st.grants} grants; per call (its "
        f"offset, the extractor's least gain over its carrier, LDUs "
        f"accepted of those its rows' blocks hold whole, frames equal to "
        f"the vector's of those decoded): "
        + ", ".join(f"{int(offs_v[j]):+d} Hz {gain[j]:.1f} dB "
                    f"{got_ldu[j][0]}/{got_ldu[j][2]} "
                    f"{got_ldu[j][1]}/{9 * got_ldu[j][0]}"
                    for j in range(len(offs_v)))        + f"; {st.releases} releases "
        f"({rel[0]} ... {rel[-1]}), the silent calls' rows parked on CC 0, "
        f"no busy or unresolved drops; {wall * 1e3 / 6:.1f} ms per block "
        f"with the judges; peak device memory {peak / 1e9:.3f} GB")
    fleet2 = TrunkedFleet(FV.WIDE_FS, ftv["wide_cc_offs"].tolist(), 16,
                          center_hz=FV.WIDE_CENTER, cc_device_pick=True,
                          device=dev)
    fleet2.step(wblocks[0], prefetch=wblocks[1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for b in range(1, 6):
        fleet2.step(None, prefetch=wblocks[b + 1] if b < 5 else None)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t1) / 5
    busy_ms, top = device_busy(lambda: fleet2.step(wblocks[2]), 2)
    log(f"2.4 MHz fleet step ({ident}): {step_s * 1e3:.1f} ms per 1 s block "
        f"(blocks 1-5, prefetched) = {1 / step_s:.1f}x band realtime, "
        f"{50 / step_s:.1f}x in 48 kHz channels; device busy "
        f"{busy_ms:.2f} ms per step = {100 * busy_ms / (step_s * 1e3):.1f}%; "
        f"top: " + ", ".join(f"{k[:40]} {v:.3f} ms" for k, v in top.items()))
    log(f"2.4 MHz fleet stages (ms, one step): "
        f"{fleet_split(fleet2, wblocks[2])}")
    rows = fleet2._rows(wblocks[1])
    check_k1(rows[1].contiguous(), fleet2.cc_pipe.cc.front.taps,
             shape=list(rows[1].shape[:2]))
    del fleet, fleet2, rows, wblocks

    # -- the other modes at 768 kHz, two blocks, against the CPU path -----
    specs = {"dmr": (460e6, 24), "nxdn48": (451e6, 0x0A5),
             "edacs": (860e6, 7), "p2": (851e6, None)}
    runs = {"dmr": (k1fn,), "nxdn48": (k1fn, k5fn), "edacs": (),
            "p2": (k1fn, k4fn)}
    for mode, (center, ch) in specs.items():
        key = {"nxdn48": "nxdn"}.get(mode, mode)
        cc_off, vc_off = (int(v) for v in ftv[f"{key}_offs"])
        band = FV.BANDS[mode](ftv, device=dev).cpu().numpy()
        mblocks = [band[:768000], band[768000:1536000]]
        kw = dict(center_hz=center)
        if mode == "p2":
            kw.update(n_voice_rows=1, p2_rows=2)
        else:
            cm = ChannelMap()
            cm.entries[ch] = center + vc_off
            kw.update(n_voice_rows=2, mode=mode, chan_map=cm)
        reset()
        res = {}
        for where in (dev, "cpu"):
            f = TrunkedFleet(FV.MODE_FS, [cc_off], device=where, **kw)
            out = [(f.step(b), f.p2_pcm) for b in mblocks]
            res[where] = (f, out)
            if where is dev:
                launches[f"fleet_{mode}"] = check_launches(
                    f"{mode} fleet", counted, runs[mode],
                    tuple(fn for fn in counted if fn not in runs[mode]))
        (g, gout), (c, cout) = res[dev], res["cpu"]
        if not (g.stats == c.stats and g.log == c.log
                and g.offs.tolist() == c.offs.tolist()):
            raise RuntimeError(f"{mode} fleet: card and CPU control planes "
                               f"differ: {g.stats} / {c.stats}")
        worst = 0.0
        for (gp, gp2), (cp, cp2) in zip(gout, cout):
            for a, b in ((cp, gp), (cp2, gp2)):
                if a.shape != b.shape:
                    raise RuntimeError(f"{mode} fleet: PCM shapes differ")
                if a.size and np.abs(a).max() > 0:
                    err = float(np.abs(a - b).max())
                    if err > 2e-3 * np.abs(a).max():
                        raise RuntimeError(f"{mode} fleet: PCM differs from "
                                           "the CPU path")
                    worst = max(worst, err)
        voice = gout[1][1][:2] if mode == "p2" else gout[1][0][:1]
        want_g = 2 if mode == "p2" else 1
        row_off = g.offs[g.n_cc + g.n_vc] if mode == "p2" else g.offs[1]
        if not (g.stats.grants == want_g and row_off == vc_off
                and (np.abs(voice).mean(axis=1) > 1e-3).all()):
            raise RuntimeError(f"{mode} fleet: {g.stats}, offs {g.offs}")
        log(f"{mode} fleet (768 kHz, two 1 s blocks): {g.stats.grants} "
            f"grant(s), the row retargeted to {vc_off:+d} Hz, voice on it; "
            f"stats, log and offsets equal to the CPU path's, PCM within "
            f"{worst:.2e} (tol 2e-3 * peak); launches "
            f"{launches[f'fleet_{mode}']}")
        if mode == "nxdn48":
            n5 = -(-len(g.cc_pipe.last_cacs[0]) // 32) * 32
            hold_k5(dev, show, g.cc_pipe.cc, n5)
    return launches


def cli_phase(ident: str, dev, counted) -> dict:
    """Phase 10: the CLI and the live one-tuner path on the card.

    ``python -m dsdneo_tpu_torch`` in a subprocess with no ``--platform``
    (the card) on 10 s of the P25 call with its ADP key: every IMBE frame
    of the ``.imb`` it writes is the vector's clear voice, and its event
    log, frame log and WAV equal the in-process CPU CLI's on the first
    5 s; in process, ``--trunk-wideband`` on 2.5 s of the JAX bench's
    fleet cell with the decoded-audio conditioning
    (``DSD_NEO_DEEMPH=nfm``, ``DSD_NEO_AUDIO_LPF=3400``): its grant,
    summary and WAV equal the library ``TrunkedFleet``'s on the card
    conditioned by the plain cascade on each row's concatenated blocks
    (the CLI carries the filters across its blocks; K8 from a carried
    state over those blocks equals it bit for bit), the card's fleet
    equals the CPU's on every block, the 0.5 s last one included, and
    the CLI launches K1, K2, K4 and K8; the closed loop of
    ``engine/livevec`` on the card (every LDU of the followed call exact,
    the tunes and events equal to the CPU's);
    the port's ``FakeRtlTcpServer`` streaming 4 s of the P25 call through
    ``RtlTcpClient`` into ``LiveEngine`` on the card.  Returns the
    launches of the CLI's run."""
    import csv
    import dataclasses as _dc
    import json as _json
    import shutil
    import subprocess
    import tempfile
    import wave

    import numpy as np
    import torch
    from dsdneo_tpu_torch.crypto.keyring import KeyRing
    from dsdneo_tpu_torch.dsp import audio_filters as af
    from dsdneo_tpu_torch.engine import fleetvec as FV
    from dsdneo_tpu_torch.engine import live, trunk
    from dsdneo_tpu_torch.engine import livevec as LV
    from dsdneo_tpu_torch.engine import serialvec as SV
    from dsdneo_tpu_torch.engine.decoder import decode_capture
    from dsdneo_tpu_torch.engine.fleettrunk import TrunkedFleet
    from dsdneo_tpu_torch.io import IqMetadata, read_iq_capture
    from dsdneo_tpu_torch.io import write_iq_capture
    from dsdneo_tpu_torch.io.mbe_files import read_mbe_file
    from dsdneo_tpu_torch.io.rtl_tcp import FakeRtlTcpServer, RtlTcpClient

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dsdneo_cli_")
    tv, fv = SV.vector(), FV.vector()
    kid, key = int(tv["p25_ids"][4]), int(tv["p25_ids"][3])
    keys = os.path.join(tmp, "keys.csv")
    with open(keys, "w") as f:
        f.write(f"id,key\n{kid},{key}\n")
    clear = np.unpackbits(tv["p25_clear88"], axis=-1)[..., :88]

    def wav(path):
        with wave.open(path, "rb") as w:
            return np.frombuffer(w.readframes(w.getnframes()), "<i2") \
                .astype(np.float32) / 32768.0

    # -- the serial replay in a subprocess, the card by default ----------
    n10, n5 = 10 * 4800, 5 * 4800
    cap10 = os.path.join(tmp, "p25_10s.iq")
    cap5 = os.path.join(tmp, "p25_5s.iq")
    meta = IqMetadata(sample_format="cf32", sample_rate_hz=48000)
    write_iq_capture(cap10, SV.p25_iq(tv, n10), meta)
    write_iq_capture(cap5, SV.p25_iq(tv, n5), meta)
    outs = {}
    for name in ("card", "cpu"):
        d = os.path.join(tmp, name)
        os.makedirs(d)
        outs[name] = d
    flags = ["-f1", "--keys-dec", keys, "--mbe-out", "{d}/voice.imb",
             "-o", "wav:{d}/out.wav", "-J", "{d}/events.log",
             "--frame-log", "{d}/frames.log", "--perf-csv", "{d}/perf.csv"]
    argv = [a.replace("{d}", outs["card"]) for a in flags]
    env = {**os.environ, "PYTHONPATH": HERE, "DSD_NEO_PDU_JSON": "1"}
    t1 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "dsdneo_tpu_torch",
                        "--iq-replay", cap10] + argv, cwd=HERE, env=env,
                       capture_output=True, text=True, timeout=600)
    wall_cli = time.perf_counter() - t1
    if p.returncode != 0:
        raise RuntimeError(f"python -m dsdneo_tpu_torch: exit "
                           f"{p.returncode}: {p.stderr[-800:]}")
    kind, frames = read_mbe_file(os.path.join(outs["card"], "voice.imb"))
    n_ldu = int(np.sum(tv["p25_ldu_pos"] + SV.P25_LDU_DIBITS <= n10))
    got = np.stack([b for _e, b in frames]) if frames else \
        np.zeros((0, 88), np.uint8)
    if not (kind == "imb" and got.shape[0] == 9 * n_ldu
            and np.array_equal(got, clear.reshape(-1, 88)[:9 * n_ldu])
            and not any(e for e, _b in frames)):
        raise RuntimeError(f"cli .imb: {got.shape[0]} frames, want the "
                           f"vector's {9 * n_ldu} clear frames exact")
    # the decode inside that run: the CLI's --perf-csv row of its
    # decode_capture call
    with open(os.path.join(outs["card"], "perf.csv")) as f:
        decode_s = sum(float(r["decode_ms"]) for r in csv.DictReader(f)) \
            / 1e3
    # a fresh process's start-up alone: the interpreter, torch's import,
    # the card's first allocation, the port's CLI and decoder imports
    probe = ("import json, time\nt0 = time.perf_counter()\nimport torch\n"
             "t1 = time.perf_counter()\ntorch.zeros(1, device='cuda')\n"
             "torch.cuda.synchronize()\nt2 = time.perf_counter()\n"
             "import dsdneo_tpu_torch.cli, dsdneo_tpu_torch.engine.decoder\n"
             "t3 = time.perf_counter()\n"
             "print(json.dumps([t1 - t0, t2 - t1, t3 - t2]))\n")
    t1 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", probe], cwd=HERE, env=env,
                       capture_output=True, text=True, timeout=300)
    wall_start = time.perf_counter() - t1
    if p.returncode != 0:
        raise RuntimeError(f"start-up probe: exit {p.returncode}: "
                           f"{p.stderr[-400:]}")
    s_torch, s_cuda, s_port = _json.loads(p.stdout.strip().splitlines()[-1])
    t1 = time.perf_counter()
    kr = KeyRing()
    kr.scalar[kid] = key
    decode_capture(cap10, "p25p1", keyring=kr, device=dev)
    wall_lib = time.perf_counter() - t1
    log(f"cli: python -m dsdneo_tpu_torch -f1 --iq-replay (10 s of the P25 "
        f"call, ADP key by --keys-dec, no --platform: the card) in a fresh "
        f"process: {wall_cli:.2f} s wall ({10.0 / wall_cli:.2f}x realtime); "
        f"every one of {got.shape[0]} IMBE frames of its .imb is the "
        f"vector's clear voice, 0 ECC errors; its decode_capture call "
        f"(--perf-csv decode_ms) {decode_s:.2f} s ({10.0 / decode_s:.2f}x), "
        f"the first decode in its process; a fresh process that only "
        f"starts {wall_start:.2f} s (torch import {s_torch:.2f} s, the "
        f"card's first allocation {s_cuda:.2f} s, the port's CLI and "
        f"decoder imports {s_port:.2f} s, the interpreter and exit "
        f"{wall_start - s_torch - s_cuda - s_port:.2f} s); the rest of the "
        f"CLI's wall (parsing, reading the capture, writing its outputs, "
        f"and whatever start-up differs) "
        f"{wall_cli - decode_s - wall_start:.2f} s; the library call "
        f"decode_capture on the same capture in this process, warm, "
        f"{wall_lib:.2f} s ({10.0 / wall_lib:.2f}x) [{ident}]")
    # the first 5 s against the CPU CLI in this process
    argv = [a.replace("{d}", outs["cpu"]) for a in flags]
    _rc, _err, wall_cpu = cli_in_process(
        ["--platform", "cpu", "--iq-replay", cap5] + argv,
        {"DSD_NEO_PDU_JSON": "1"})
    logs = {}
    for name, d in outs.items():
        with open(os.path.join(d, "frames.log")) as f:
            ents = [_json.loads(line) for line in f]
        with open(os.path.join(d, "events.log")) as f:
            logs[name] = (ents, f.read(), wav(os.path.join(d, "out.wav")))
    limit = n5 - 2 * SV.P25_LDU_DIBITS
    k = sum(e["pos"] < limit for e in logs["cpu"][0])
    (ce, ctext, cw), (ge, gtext, gw) = logs["cpu"], logs["card"]
    head = "".join(e["line"].rstrip("\n") + "\n" for e in ce[:k])
    n_pcm = 9 * 160 * int(np.sum(tv["p25_ldu_pos"] + SV.P25_LDU_DIBITS
                                 <= limit))
    if not (k > 40 and ge[:k] == ce[:k] and ctext.startswith(head)
            and gtext.startswith(head) and cw.shape[0] >= n_pcm
            and gw.shape[0] >= n_pcm):
        raise RuntimeError(f"cli: the card's event or frame log differs "
                           f"from the CPU CLI's on the first 5 s ({k} "
                           f"events)")
    err = float(np.abs(gw[:n_pcm] - cw[:n_pcm]).max())
    if err > 2e-3 * float(np.abs(cw[:n_pcm]).max()):
        raise RuntimeError(f"cli: WAV differs from the CPU CLI's ({err})")
    log(f"cli: its first {k} events (to symbol {limit}) and {n_pcm} WAV "
        f"samples equal to the CPU CLI's on the first 5 s (frame log with "
        f"fields and event log identical, PCM within {err:.2e}; the CPU "
        f"CLI {wall_cpu:.2f} s)")

    # -- --trunk-wideband with the conditioning, in process ---------------
    band = FV.bench_band(fv, device=dev, seconds=2.5).cpu().numpy()
    capb = os.path.join(tmp, "band.iq")
    write_iq_capture(capb, band, IqMetadata(
        sample_format="cf32", sample_rate_hz=int(FV.BENCH_FS),
        center_frequency_hz=int(FV.BENCH_CENTER)))
    cond = {"DSD_NEO_DEEMPH": "nfm", "DSD_NEO_AUDIO_LPF": "3400"}
    wavb = os.path.join(tmp, "voice.wav")
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    _rc, text, wall_tw = cli_in_process(
        ["--iq-replay", capb, "--trunk-wideband",
         f" {FV.BENCH_CC_OFF}:4:p25p1", "-o", "wav:" + wavb], cond)
    k1fn, k2fn, k3fn, k7fn, k4fn, k5fn, k6fn, k8fn = counted
    launches = check_launches("cli --trunk-wideband", counted,
                              (k1fn, k2fn, k4fn, k8fn),
                              (k3fn, k5fn, k6fn, k7fn))
    _m, samples = read_iq_capture(capb)
    B = int(FV.BENCH_FS)
    fleets, walls = {}, {}
    for where in (dev, "cpu"):
        # the library fleet stepped as the CLI steps it, on the card
        # (the CLI's kernels) and on the CPU (their plain versions)
        if where != "cpu":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        f = TrunkedFleet(FV.BENCH_FS, [FV.BENCH_CC_OFF], 4,
                         center_hz=FV.BENCH_CENTER, cc_device_pick=True,
                         device=where)
        blocks = [f.step(samples[i:i + B])
                  for i in range(0, samples.shape[0], B)]
        written = [(k, r) for k, pcm in enumerate(blocks) if pcm.shape[1]
                   for r in f.calls if np.abs(pcm[r]).mean() > 1e-4]
        walls[str(where)] = time.perf_counter() - t1
        fleets[str(where)] = (f, blocks, written)
    (f, blocks, written), (fc, cblocks, cwritten) = (fleets[str(dev)],
                                                     fleets["cpu"])
    wall_fl = walls[str(dev)]
    # every block, the 0.5 s last one included: the card's fleet (K1,
    # K2, K4 at the CLI's shapes) against the CPU's plain versions
    errs = []
    for k, (a, b) in enumerate(zip(blocks, cblocks)):
        if a.shape != b.shape:
            raise RuntimeError(f"--trunk-wideband block {k}: the card's PCM "
                               f"{a.shape}, the CPU's {b.shape}")
        if a.size:
            e = float(np.abs(a - b).max())
            if e > 2e-3 * float(np.abs(b).max()):
                raise RuntimeError(f"--trunk-wideband block {k}: the card's "
                                   f"PCM differs from the CPU's ({e})")
            errs.append(e)
    if not (f.log == fc.log and written == cwritten
            and _dc.asdict(f.stats) == _dc.asdict(fc.stats)):
        raise RuntimeError("--trunk-wideband: the card's library fleet "
                           "differs from the CPU's (log, rows or stats)")
    s = f.stats
    want = f.log + [
        f"trunk-wideband: {s.grants} grants, {s.grant_refreshes} "
        f"refreshes, {s.releases} releases, {s.unresolved} unresolved, "
        f"{s.busy_drops} busy-drops over {f.blocks} blocks"]
    # the conditioning's plain version (one_pole_plain twice, on the
    # CPU) on each written row's blocks concatenated: the CLI carries the
    # filters across its blocks, so its WAV is this bit for bit (K8 at
    # the CLI's [4, T] blocks)
    edges = np.cumsum([0] + [blk.shape[1] for blk in blocks])
    y = torch.from_numpy(np.concatenate(blocks, axis=1))
    for a in (af.deemphasis_pole(8000.0, 750.0),
              af.lowpass_pole(8000.0, 3400.0)):
        y = af.one_pole_plain(y, a)
    # K8 itself at those blocks, its state carried, against the plain
    # cascade on the concatenation (float32, tol 0)
    st = torch.zeros((blocks[0].shape[0], 2), dtype=torch.float32,
                     device=dev)
    k8 = torch.cat([af.condition_audio(torch.from_numpy(blk).to(dev),
                                       "nfm", 3400.0, state=st).cpu()
                    for blk in blocks if blk.shape[1]], 1)
    if not torch.equal(k8, y):
        raise RuntimeError(f"K8 from a carried state over the CLI's blocks "
                           f"differs from the plain cascade: "
                           f"{float((k8 - y).abs().max())}")
    y = y.numpy()
    cond = np.concatenate([y[r, edges[k]:edges[k + 1]] for k, r in written])
    q = (np.clip(cond, -1.0, 1.0) * 32767.0).astype(
        np.int16).astype(np.float32) / 32768.0
    if not (text.splitlines() == want and s.grants == 1
            and np.array_equal(wav(wavb), q) and q.size == 8640):
        raise RuntimeError(f"cli --trunk-wideband: {text!r} / {want} or its "
                           "WAV differs from the library fleet's PCM under "
                           "the plain conditioning")
    log(f"cli --trunk-wideband ' {FV.BENCH_CC_OFF}:4:p25p1' on 2.5 s of the "
        f"bench's 768 kHz cell (1 s steps, a 0.5 s last block), "
        f"DSD_NEO_DEEMPH=nfm DSD_NEO_AUDIO_LPF=3400: its lines (the grant of "
        f"TG 101 and the summary) equal the library TrunkedFleet's on the "
        f"card, and its WAV ({q.size} samples) equals that fleet's PCM "
        f"conditioned by the plain cascade (one_pole_plain twice) on each "
        f"row's concatenated blocks, bit for bit; the card's fleet equals "
        f"the CPU's on every block (log, rows, stats; PCM within "
        f"{max(errs):.2e}, tol 2e-3 of the peak; the CPU {walls['cpu']:.2f} "
        f"s); {wall_tw:.2f} s ({2.5 / wall_tw:.2f}x realtime of band) "
        f"against the library's {wall_fl:.2f} s ({2.5 / wall_fl:.2f}x) "
        f"[{ident}]")

    # -- the closed loop, the card against the CPU --------------------------
    loops = {}
    for where in (dev, "cpu"):
        t1 = time.perf_counter()
        loop = LV.ClosedLoop(live.LiveEngine, trunk.TrunkSM,
                             trunk.TrunkFollower, SV.ImbeSink(),
                             engine_kw={"device": where})
        loop.run(fv)
        got = LV.judge(loop, fv)
        loops[str(where)] = (loop, got, time.perf_counter() - t1)
    (g, gj, gw_s), (c, _cj, cw_s) = loops[str(dev)], loops["cpu"]
    if not (g.tunes == c.tunes and g.events == c.events):
        raise RuntimeError("closed loop: the card's tunes or events differ "
                           "from the CPU's")
    log(f"closed loop (one tuner, LiveEngine + TrunkFollower + TrunkSM in "
        f"lockstep): tunes {[k for _f, k in g.tunes]} (TG 101 at "
        f"{LV.VC_HZ / 1e6:.4f} MHz, back after the hangtime), {gj['ldus']} "
        f"LDUs, all {gj['frames']} IMBE frames exact, {gj['events']} events "
        f"equal to the CPU's; {gj['clock_s']:.2f} s of decoded blocks "
        f"(the muted block not counted) in {gw_s:.2f} s on the card "
        f"({gj['clock_s'] / gw_s:.2f}x), {cw_s:.2f} s on the CPU "
        f"[{ident}]")

    # -- the socket path: FakeRtlTcpServer → RtlTcpClient → LiveEngine ----
    srv = FakeRtlTcpServer(LV.cu8(SV.p25_iq(tv, 4 * 4800)))
    events = []
    eng = live.LiveEngine("p25p1", block_s=0.25, on_event=events.append,
                          device=dev)
    sink = SV.ImbeSink()
    eng.decoder.ctx.mbe_sink = sink
    eng.decoder.ctx.state.keyring = kr
    client = RtlTcpClient("127.0.0.1", srv.port, eng.ring,
                          sample_rate=48000, freq_hz=851_000_000)
    t1 = time.perf_counter()
    try:
        client.start()
        eng.start()
        deadline = time.time() + 60
        while time.time() < deadline and len(sink.bits) < 9 * 20:
            time.sleep(0.05)
        wall_sock = time.perf_counter() - t1
    finally:
        eng.stop()
        client.close()
        srv.close()
    got = np.asarray(sink.bits, np.uint8).reshape(-1, 88)
    if not (got.shape[0] >= 9 * 20
            and np.array_equal(got, clear.reshape(-1, 88)[:got.shape[0]])):
        raise RuntimeError(f"rtl_tcp live path: {got.shape[0]} frames, or "
                           "not the vector's")
    log(f"rtl_tcp live path (FakeRtlTcpServer → RtlTcpClient → ring → "
        f"LiveEngine on the card): {got.shape[0]} IMBE frames (the call's "
        f"first {got.shape[0] // 9} LDUs, ADP ones decrypted), all exact, "
        f"{len(events)} events, in {wall_sock:.2f} s for 4 s of signal "
        f"({4.0 / wall_sock:.2f}x realtime, unpaced) [{ident}]")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return {"cli": launches}


def cli_in_process(argv, env=None):
    """``cli.main(argv)`` of the port in this process: (exit code, its
    stderr, wall s), ``env`` set around it and the process-wide runtime
    config the CLI installs put back after; raises on a non-zero exit."""
    import contextlib
    import io

    from dsdneo_tpu_torch import cli
    from dsdneo_tpu_torch.runtime import config as rtcfg
    saved = rtcfg._config
    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    err = io.StringIO()
    t1 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(err):
            rc = cli.main(list(argv))
    finally:
        wall = time.perf_counter() - t1
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        rtcfg._config = saved
    if rc != 0:
        raise RuntimeError(f"cli {argv[:6]}: exit {rc}: "
                           f"{err.getvalue()[-400:]}")
    return rc, err.getvalue(), wall


def on_a_pty(fn, keys: list[bytes], *args, **kw):
    """``fn(*args, **kw)`` (a curses frontend) in a thread, drawing on a
    30x100 pseudo-terminal: fds 0 and 1 are the pty's slave and TERM is
    xterm for the call.  ``keys`` are typed into the master once the
    header is drawn.  Returns fn's result and the bytes it drew."""
    import fcntl
    import pty
    import select
    import struct
    import termios
    import threading
    master, slave = pty.openpty()
    fcntl.ioctl(slave, termios.TIOCSWINSZ, struct.pack("HHHH", 30, 100, 0, 0))
    sys.stdout.flush()
    saved, term = (os.dup(0), os.dup(1)), os.environ.get("TERM")
    res, out = [], bytearray()

    def body():
        try:
            res.append(fn(*args, **kw))
        except BaseException as e:          # re-raised below
            res.append(e)
    os.environ["TERM"] = "xterm"
    os.dup2(slave, 0)
    os.dup2(slave, 1)
    try:
        t = threading.Thread(target=body, daemon=True)
        t.start()
        typed, deadline = False, time.time() + 30
        while time.time() < deadline and (t.is_alive() or select.select(
                [master], [], [], 0)[0]):
            if select.select([master], [], [], 0.05)[0]:
                out += os.read(master, 65536)
            if not typed and b"dsd-neo-tpu" in out:
                for k in keys:
                    os.write(master, k)
                    time.sleep(0.1)
                typed = True
    finally:
        os.dup2(saved[0], 0)
        os.dup2(saved[1], 1)
        for fd in (*saved, slave, master):
            os.close(fd)
        if term is None:
            del os.environ["TERM"]
        else:
            os.environ["TERM"] = term
    if not res:
        raise RuntimeError(f"the frontend did not return in 30 s: "
                           f"{bytes(out[-300:])!r}")
    if isinstance(res[0], BaseException):
        raise res[0]
    return res[0], bytes(out)


class _HttpWatch:
    """Watches the port's HTTP frontends while a CLI runs in this
    process: a thread polls each started frontend's ``paths`` every
    0.2 s, keeping the last good reply of each, and a last read is taken
    as the frontend stops (so what it served at its end is kept)."""

    def __init__(self, paths):
        from dsdneo_tpu_torch.app_control import http as H
        self.H, self.paths = H, paths
        self.fronts, self.last, self.final, self.polls = [], {}, {}, 0
        self._real = (H.HttpFrontend.start, H.HttpFrontend.stop)
        watch = self

        def start(f):
            watch.fronts.append(f)
            return watch._real[0](f)

        def stop(f):
            watch.final = watch._read(f)
            watch._real[1](f)
        H.HttpFrontend.start, H.HttpFrontend.stop = start, stop
        self._halt = False
        self._t = __import__("threading").Thread(target=self._poll,
                                                 daemon=True)
        self._t.start()

    def _read(self, f) -> dict:
        import urllib.request
        out = {}
        for p in self.paths:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{f.port}{p}", timeout=5) as r:
                    out[p] = r.read()
            except OSError:
                pass
        return out

    def _poll(self) -> None:
        while not self._halt:
            for f in list(self.fronts):
                got = self._read(f)
                if got:
                    self.polls += 1
                    self.last.update(got)
            time.sleep(0.2)

    def close(self) -> None:
        self._halt = True
        self._t.join(timeout=10)
        self.H.HttpFrontend.start, self.H.HttpFrontend.stop = self._real


def extras_phase(ident: str, dev, counted, show, check_k1, c4fm,
                 tables) -> dict:
    """Phase 11: the CLI's frontends and extras and the batched host
    leftovers on the card.

    M17 transmit (``-fZ``/``-fP``/``-fB`` written as ``-o iq:``
    captures) decoded back by ``-fz --iq-replay`` on the card and on the
    CPU; ``--fleet p25p1:cc:2 --frontend http`` on the bench's control
    channel, its endpoints polled from a thread while it serves; ``-f1
    --stream 0.25 --frontend http`` on 10 s of the P25 call; the live
    one-tuner path (``FakeRtlTcpServer`` → ``RtlTcpClient`` →
    ``LiveEngine`` on the card) with ``AutoPpm`` and ``TunerAutogain``
    behind spies, and ``ui.terminal.run_live`` on that engine, drawing
    on a pseudo-terminal;
    ``engine.batched.make_frontend_step`` for every four-level FM mode
    (K1 held to its plain version at its shapes); ``decode_block``
    against ``decode_block_host`` and ``frontend_sync`` against
    ``frontend_dispatch`` at C = 320 on the C4FM block.  Returns the
    launches of its counted runs."""
    import json as _json
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dsdneo_tpu_torch.crypto.keyring import KeyRing
    from dsdneo_tpu_torch.engine import fleetvec as FV
    from dsdneo_tpu_torch.engine import live
    from dsdneo_tpu_torch.engine import livevec as LV
    from dsdneo_tpu_torch.engine import serialvec as SV
    from dsdneo_tpu_torch.engine import stream as ST
    from dsdneo_tpu_torch.engine.batched import make_frontend_step
    from dsdneo_tpu_torch.engine.fleet import FleetMonitor
    from dsdneo_tpu_torch.engine.modes import MODES
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.dsp import firdes
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu_torch.fec.device import imbe_ecc_batch
    from dsdneo_tpu_torch.io import IqMetadata, write_iq_capture
    from dsdneo_tpu_torch.io.auto_gain import TunerAutogain
    from dsdneo_tpu_torch.io.auto_ppm import AutoPpm
    from dsdneo_tpu_torch.io.rtl_tcp import FakeRtlTcpServer, RtlTcpClient
    from dsdneo_tpu_torch.protocol.p25 import encode
    from dsdneo_tpu_torch.ui.terminal import run_live

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="dsdneo_extras_")
    tv, fv = SV.vector(), FV.vector()
    kid, key = int(tv["p25_ids"][4]), int(tv["p25_ids"][3])
    keys = os.path.join(tmp, "keys.csv")
    with open(keys, "w") as f:
        f.write(f"id,key\n{kid},{key}\n")
    clear = np.unpackbits(tv["p25_clear88"], axis=-1)[..., :88] \
        .reshape(-1, 88)
    meta = IqMetadata(sample_format="cf32", sample_rate_hz=48000)
    counts = {}

    def zero():
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()

    def read():
        return {fn.__name__: fn.launches for fn in counted}

    k1fn, k2fn, k3fn, k7fn, k4fn, k5fn, k6fn, k8fn = counted

    # -- M17 transmit, then receive on the card and on the CPU -----------
    t1 = time.perf_counter()
    sms = "M17 SMS from the port, on the card"
    tx = {"stream": ["-fZ", "-M", "M17:7:N0CALL:TG1", "--tx-frames", "50"],
          "packet": ["-fP", "-M", "M17:3:AB1CD:W1AW", "--m17-sms", sms],
          "bert": ["-fB", "--tx-frames", "50"]}
    m17 = {}
    for kind, argv in tx.items():
        cap = os.path.join(tmp, f"m17_{kind}.iq")
        cli_in_process(argv + ["-o", "iq:" + cap])
        zero()
        _rc, card, _w = cli_in_process(["-fz", "--iq-replay", cap])
        if any(read().values()):
            raise RuntimeError(f"M17 receive: a kernel ran: {read()}")
        _rc, cpu, _w = cli_in_process(["--platform", "cpu", "-fz",
                                       "--iq-replay", cap])
        if card != cpu:
            raise RuntimeError(f"M17 {kind}: the card's lines differ from "
                               "the CPU's")
        lines = card.splitlines()
        if kind == "stream":
            fns = [int(ln.split("FN: ")[1].split()[0], 16)
                   for ln in lines if "STR" in ln and "FN: " in ln]
            ok = (fns == list(range(50))
                  and " CAN: 7 DST: TG1 SRC: N0CALL Voice (3200bps)"
                  in lines and "EOT" in lines[-1])
            m17[kind] = f"{len(fns)} stream frames, FN 0-49 in order"
        elif kind == "packet":
            ok = (" CAN: 3 DST: W1AW SRC: AB1CD Packet" in lines
                  and f" SMS: {sms}" in lines)
            m17[kind] = "LSF and SMS text"
        else:
            brt = [ln for ln in lines if "BRT" in ln]
            ok = (len(brt) == 50 and all("errors:0" in ln for ln in brt)
                  and all("LOCK" in ln for ln in brt[1:]))
            m17[kind] = (f"{len(brt)} BERT frames, "
                         f"{brt[-1].split('bits:')[1].split()[0]} bits, "
                         "0 errors")
        if not ok:
            raise RuntimeError(f"M17 {kind} round trip: {card[-600:]}")
    log(f"M17 transmit -> receive (-o iq: captures of -fZ, -fP --m17-sms, "
        f"-fB, each decoded by -fz --iq-replay on the card, lines equal "
        f"to --platform cpu's, no kernel launched): {m17}; "
        f"{time.perf_counter() - t1:.2f} s [{ident}]")

    # -- --fleet p25p1:cc:2 --frontend http --------------------------------
    t1 = time.perf_counter()
    cc = np.resize(fv["bench_cc_dibits"], 7200)           # 1.5 s of the CC
    capf = os.path.join(tmp, "fleet_cc.iq")
    write_iq_capture(capf, FV.c4fm48(cc, 1), meta)
    watch = _HttpWatch(("/grid", "/events?n=500", "/calls", "/snapshot"))
    zero()
    try:
        _rc, text, wall_f = cli_in_process(
            ["--iq-replay", capf, "--fleet", "p25p1:cc:2", "--frontend",
             "http", "--http-port", "0", "--duration", "3.2"])
    finally:
        watch.close()
    l_http = read()
    n_blk = int(text.split("fleet: ")[1].split()[0])
    got = watch.final
    grid = _json.loads(got["/grid"])["channels"]
    evs = _json.loads(got["/events?n=500"])["events"]
    calls = _json.loads(got["/calls"])["calls"]
    snap = _json.loads(got["/snapshot"])
    # the same fleet without the frontend, stepped as many blocks
    from dsdneo_tpu_torch.io import read_iq_capture
    _m, samples = read_iq_capture(capf)
    iq1 = np.stack([samples.real, samples.imag], -1).astype(np.float32)
    block = np.broadcast_to(iq1[None], (2,) + iq1.shape).copy()
    plain = FleetMonitor(fs=48000.0, device=dev)
    plain.assign("p25p1", 2, kind="cc")
    pipe = plain.groups[0].pipeline
    k4_n = []                 # K4's word count at each launch: 3 TSBKs
    zero()                    # a TSDU, the TSDUs padded to 64s
    for _ in range(n_blk):
        plain.decode_block(block)
        if pipe.last_tsdus is not None:
            k4_n.append(3 * (-(-len(pipe.last_tsdus[0]) // 64) * 64))
    k4_words = sorted(set(k4_n))
    l_plain = read()
    # ... and on the CPU: the kernels' plain versions under the same fleet
    host = FleetMonitor(fs=48000.0, device="cpu")
    host.assign("p25p1", 2, kind="cc")
    for _ in range(n_blk):
        host.decode_block(block)
    diff = [SV.events_equal(plain.events(c), host.events(c))
            for c in range(2)]
    n_ev = sum(len(plain.events(c)) for c in range(2))
    if not (len(grid) == 2 and all(c["state"] == "cc" for c in grid)
            and any("NAC/CC: 293" in e for e in evs)
            and any(c["tg"] == 101 for c in calls)
            and snap["blocks"] == n_blk >= 2 and watch.polls >= 1
            and l_http == l_plain and l_http["fir_discriminate"] == n_blk
            and l_http["p25_12_decode_batch"] == len(k4_n) >= 1
            and diff == [None, None]
            and plain.channel_dicts() == host.channel_dicts()):
        raise RuntimeError(f"fleet http console: grid {grid}, {len(evs)} "
                           f"events, {len(calls)} calls, snapshot "
                           f"{snap.get('blocks')}, launches {l_http} vs "
                           f"{l_plain}, K4 word counts {k4_words}; the "
                           f"card's fleet against the CPU's: {diff}")
    # K1 and K4 at the console's shapes, against their plain versions
    check_k1(torch.as_tensor(block, device=dev), pipe.tables.taps,
             shape=list(block.shape[:2]))
    for n4 in k4_words:
        hold_k4(dev, show, n4, "the fleet console's TSDUs")
    counts["fleet_http"] = l_http
    log(f"--fleet p25p1:cc:2 --frontend http on 1.5 s of the bench's P25 "
        f"CC (realtime-paced, --duration 3.2): {n_blk} blocks, "
        f"{watch.polls} polls of /grid /events /calls /snapshot from a "
        f"thread while it served; at its stop: {len(grid)} channels on "
        f"the grid (both 'cc'), {len(evs)} event lines (the NAC/CC 293 "
        f"line), {len(calls)} calls (the grant of TG 101); K1 "
        f"{l_http['fir_discriminate']}, K4 {l_http['p25_12_decode_batch']} "
        f"launches, equal to the same fleet without the frontend over "
        f"{n_blk} blocks, whose {n_ev} events and grid equal the same "
        f"fleet's on the CPU; K1 held at {list(block.shape[:2])} with its "
        f"{pipe.tables.taps.shape[0]} taps, K4 at {k4_words} words; "
        f"{wall_f:.2f} s wall "
        f"[{ident}]")

    # -- -f1 --stream 0.25 --frontend http -----------------------------------
    t1 = time.perf_counter()
    cap10 = os.path.join(tmp, "p25_10s.iq")
    write_iq_capture(cap10, SV.p25_iq(tv, 10 * 4800), meta)
    sinks = []
    init = ST.StreamDecoder.__init__

    def with_sink(self, *a, **kw):
        init(self, *a, **kw)
        self.ctx.mbe_sink = SV.ImbeSink()
        sinks.append(self.ctx.mbe_sink)
    ST.StreamDecoder.__init__ = with_sink
    watch = _HttpWatch(("/snapshot", "/events?n=1000", "/calls"))
    zero()
    try:
        _rc, text, wall_s = cli_in_process(
            ["-f1", "--iq-replay", cap10, "--stream", "0.25", "--frontend",
             "http", "--http-port", "0", "--iq-replay-rate", "8",
             "--keys-dec", keys])
    finally:
        watch.close()
        ST.StreamDecoder.__init__ = init
    snap = _json.loads(watch.final["/snapshot"])
    evs = _json.loads(watch.final["/events?n=1000"])["events"]
    n_ldu = int(np.sum(tv["p25_ldu_pos"] + SV.P25_LDU_DIBITS <= 10 * 4800))
    got = np.asarray(sinks[0].bits, np.uint8).reshape(-1, 88) if sinks \
        else np.zeros((0, 88), np.uint8)
    if not (len(sinks) == 1 and snap["blocks"] >= 2
            and snap["symbol_rate_hz"] == 4800 and snap["spectrum_db"]
            and snap["eye_symbols"] and watch.polls >= 1
            and sum("LDU" in e for e in evs) >= n_ldu
            and got.shape[0] >= 9 * n_ldu
            and np.array_equal(got, clear[:got.shape[0]])):
        raise RuntimeError(f"stream http: snapshot blocks "
                           f"{snap.get('blocks')}, {len(evs)} events, "
                           f"{got.shape[0]} IMBE frames (want "
                           f"{9 * n_ldu} exact)")
    log(f"-f1 --stream 0.25 --frontend http on 10 s of the P25 call "
        f"(--iq-replay-rate 8): snapshot at the end: {snap['blocks']} "
        f"blocks, symbol_rate_hz {snap['symbol_rate_hz']}, "
        f"{len(snap['spectrum_db'])} spectrum bins, "
        f"{len(snap['eye_symbols'])} eye symbols; {len(evs)} event lines; "
        f"all {got.shape[0]} IMBE frames of {n_ldu} LDUs exact (ADP ones "
        f"decrypted); {watch.polls} polls while it served; launches "
        f"{read()}; {wall_s:.2f} s wall [{ident}]")

    # -- the live one-tuner path with auto-PPM and the tuner autogain ------
    kr = KeyRing()
    kr.scalar[kid] = key
    live_out = {}
    for case, cfo, scale in (("cfo", 1500.0, 1.0), ("clip", 0.0, 4.0)):
        x = SV.p25_iq(tv, 4 * 4800)
        x = (x * np.exp(2j * np.pi * cfo * np.arange(x.shape[0]) / 48000.0)
             * scale).astype(np.complex64)
        srv = FakeRtlTcpServer(LV.cu8(x))
        ppm, gain, events = [], [], []
        eng = live.LiveEngine("p25p1", block_s=0.25,
                              on_event=events.append, device=dev)
        sink = SV.ImbeSink()
        eng.decoder.ctx.mbe_sink = sink
        eng.decoder.ctx.state.keyring = kr
        clock = iter(range(1 << 30))
        eng.auto_ppm = AutoPpm(ppm.append, 851e6)
        eng.auto_gain = TunerAutogain(gain.append, window_blocks=4,
                                      now_fn=lambda: float(next(clock)))
        client = RtlTcpClient("127.0.0.1", srv.port, eng.ring,
                              sample_rate=48000, freq_hz=851_000_000)
        t1 = time.perf_counter()
        try:
            client.start()
            eng.start()
            deadline = time.time() + 60
            while time.time() < deadline and (
                    (case == "cfo" and (len(sink.bits) < 9 * 20
                                        or not ppm))
                    or (case == "clip" and len(gain) < 2)):
                time.sleep(0.05)
            # the frames before the frontend's retune are the call's
            got = np.asarray(list(sink.bits), np.uint8).reshape(-1, 88)
            if case == "cfo":
                # the live frontend on that engine, on a terminal: its
                # menu's tune reaches the engine between its blocks
                n_snap, snap_fn = [0], eng.metrics.snapshot

                def snap_counted():
                    n_snap[0] += 1
                    return snap_fn()
                eng.metrics.snapshot = snap_counted
                t2 = time.perf_counter()
                drawn, out = on_a_pty(
                    run_live, [b"m", b"\r", b"\r", b"851.0125", b"\r"],
                    eng, duration=0.0, events=["live line"],
                    max_idle_polls=8)
                t3 = time.time()
                while eng.retunes == 0 and time.time() - t3 < 5:
                    time.sleep(0.05)
                ui = (drawn, n_snap[0], eng.freq_hz, eng.retunes,
                      time.perf_counter() - t2,
                      b"dsd-neo-tpu LIVE | p25p1 | " in out,
                      b"sent tune 851012500.0" in out)
        finally:
            eng.stop()
            client.close()
            srv.close()
        live_out[case] = (ppm, gain, got, time.perf_counter() - t1)
        if case == "cfo":
            if not (ppm and ppm[0] == -2
                    and got.shape[0] >= 9 * 20
                    and np.array_equal(got, clear[:got.shape[0]])
                    and ui[0] is True and ui[1] >= 8
                    and ui[2:4] == (851012500.0, 1) and all(ui[5:])):
                raise RuntimeError(f"live auto-PPM: ppm {ppm}, "
                                   f"{got.shape[0]} frames; run_live on a "
                                   f"pty (drawn, snapshots, freq, retunes, "
                                   f"s, header, tune sent): {ui}")
        elif not (gain[:2] == [300, 250]):
            raise RuntimeError(f"live autogain on a clipped feed: {gain}")
    (ppm, _g, got, w_cfo), (_p, gain, _got, w_clip) = (live_out["cfo"],
                                                      live_out["clip"])
    log(f"live path (FakeRtlTcpServer -> RtlTcpClient -> LiveEngine on the "
        f"card) with AutoPpm and TunerAutogain behind spies: a 1500 Hz "
        f"carrier offset (1.76 ppm at 851 MHz) asks set_ppm {ppm} (the "
        f"first step -2, the loop's largest: negative for a positive "
        f"offset), and the call's {got.shape[0]} IMBE frames stay exact; "
        f"ui.terminal.run_live on that engine, on a pty, drew {ui[1]} "
        f"frames (a metrics snapshot each, 8 idle polls the least) and "
        f"its menu's tune (m, Enter, Enter, 851.0125, Enter) retuned the "
        f"engine to {ui[2]:.0f} Hz, {ui[4]:.2f} s; a clipped feed (x4) "
        f"steps set_gain "
        f"{gain} (the 30 dB seed, then down 5 dB a window); {w_cfo:.2f} + "
        f"{w_clip:.2f} s [{ident}]")

    # -- make_frontend_step for every four-level FM mode ------------------
    t1 = time.perf_counter()
    Bm = 48000
    rng = np.random.default_rng(SEED + 11)
    four = [m for m, cfg in MODES.items() if cfg.four_level]
    profiles = {}
    for m in four:
        profiles.setdefault(MODES[m].lpf_profile, m)
    def fsk_block(m: str, n_ch: int = min(16, C)) -> torch.Tensor:
        """[C, Bm, 2] of the mode's four-level FSK at its own rate
        (``n_ch`` distinct channels, tiled to C), on the card."""
        rate = MODES[m].symbol_rate
        sps = int(round(48000.0 / rate))
        z = np.stack([encode.c4fm_iq(
            rng.integers(0, 4, Bm // sps + 2).astype(np.uint8), sps=sps,
            dev_hz=1800.0 * rate / 4800.0,
            seed=int(rng.integers(1 << 30)))[:Bm] for _ in range(n_ch)])
        z = np.tile(z, (C // n_ch, 1))
        return torch.from_numpy(np.stack([z.real, z.imag], -1).astype(
            np.float32)).to(dev)

    xs = {m: fsk_block(m) for m in four}
    for prof, m in profiles.items():
        taps = torch.as_tensor(firdes.channel_lpf(48000.0, prof),
                               device=dev)
        check_k1(xs[m], taps, shape=[C, Bm, prof])
    zero()
    step_err = {}
    for m in four:
        x = xs[m]
        dd, ds, _p = make_frontend_step(m, Bm, device=dev)(x)
        hd, hs, _hp = make_frontend_step(m, Bm, device="cpu")(x[:2].cpu())
        e = float((ds[:2].cpu() - hs).abs().max())
        hs = hs.numpy()
        off = (np.abs(hs) > 2e-4) & (np.abs(np.abs(hs) - 2.0) > 2e-4)
        if not (e <= 2e-4 and np.array_equal(dd[:2].cpu().numpy()[off],
                                             hd.numpy()[off])):
            raise RuntimeError(f"make_frontend_step({m}): the card differs "
                               f"from the CPU ({e})")
        step_err[m] = e
    l_step = read()
    if l_step["fir_discriminate"] != len(four) or any(
            v for k, v in l_step.items() if k != "fir_discriminate"):
        raise RuntimeError(f"make_frontend_step launches: {l_step}")
    counts["frontend_step"] = l_step
    log(f"make_frontend_step at [{C}, {Bm}] for the {len(four)} four-level "
        f"modes {four}: soft symbols of channels 0-1 within "
        f"{max(step_err.values()):.2e} of the CPU path (tol 2e-4), dibits "
        f"equal off the thresholds; K1 launched once a mode; K1 held to "
        f"its plain version at [{C}, {Bm}] with each of the "
        f"{len(profiles)} channel filters {sorted(profiles)}; "
        f"{time.perf_counter() - t1:.2f} s [{ident}]")

    # -- decode_block against decode_block_host at C = 320 ------------------
    t1 = time.perf_counter()
    pa = BatchedP25VoicePipeline(C, device=dev, tables=tables)
    pb = BatchedP25VoicePipeline(C, device=dev, tables=tables)
    zero()
    pcm = pa.decode_block(c4fm)
    l_dev = read()
    bits, errs, fch, forder = pa.last_frames
    zero()
    t2 = time.perf_counter()
    host = pb.decode_block_host(c4fm)
    torch.cuda.synchronize()
    w_host = time.perf_counter() - t2
    l_host = read()
    # the host path on the CPU, channels 0-1
    host_cpu = BatchedP25VoicePipeline(
        2, device="cpu", tables=params.load("cpu")).decode_block_host(
        c4fm[:2].cpu())
    e_cpu = float(np.abs(host[:2] - host_cpu).max()) \
        if host_cpu.shape == host[:2].shape else float("inf")
    dib, bd, bs, nm = pb.frontend_sync(c4fm)
    fe = pb.frontend_dispatch(c4fm)
    frames, hch, hord = pb.find_voice_frames_best(dib, bd, bs,
                                                  dib.shape[1], nm)
    hb, herr = imbe_ecc_batch(torch.as_tensor(frames, device=dev), tables)
    o1 = np.lexsort((forder, fch))
    o2 = np.lexsort((hord, hch))
    # the device path pads its steps to 27s: the tail past the host
    # path's frames must be silence (the JAX contract's comparison)
    n = host.shape[1]
    peak = float(np.abs(host).max())
    tail = float(np.abs(pcm[:, n:]).max()) if pcm.shape[1] > n else 0.0
    e = float(np.abs(pcm[:, :n] - host).max()) \
        if pcm.shape[0] == host.shape[0] and pcm.shape[1] >= n > 0 \
        else float("inf")
    if not (np.array_equal(dib, fe[0].cpu().numpy())
            and np.array_equal(fch[o1], hch[o2])
            and np.array_equal(forder[o1], hord[o2])
            and np.array_equal(bits.cpu().numpy()[o1],
                               hb.cpu().numpy()[o2])
            and int(herr.max()) == 0 and e <= HOST_PCM_REL * peak
            and peak > 0 and tail < 1e-6
            and e_cpu <= 2e-3 * float(np.abs(host_cpu).max())
            and l_host["fir_discriminate"] == 1
            and l_host["prediction_scan"] == 0):
        raise RuntimeError(f"decode_block_host: frames or PCM differ from "
                           f"decode_block (PCM {e} of peak {peak}), or "
                           f"launches {l_host}")
    counts["host_decode"] = l_host
    counts["device_decode"] = l_dev
    log(f"decode_block vs decode_block_host at [{C}, {c4fm.shape[1]}] on the "
        f"C4FM block: {frames.shape[0]} voice frames equal (channel, step "
        f"and ECC-decoded bits, 0 errors), PCM within {e:.2e} "
        f"({e / peak:.2e} of the peak; tol {HOST_PCM_REL}) over its "
        f"{n // 160} frame steps, the device path's padded tail silent; "
        f"the host path on the card equal to it on the CPU on channels "
        f"0-1 within {e_cpu:.2e} (tol 2e-3 of the peak); frontend_sync's dibits equal "
        f"frontend_dispatch's; launches device {l_dev}, host {l_host}; the "
        f"host path {w_host:.2f} s [{ident}]")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s [{ident}]")
    return counts


def _sync(dev) -> None:
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def mesh_fleet_spec(mode: str, S: int):
    """Phase 12's sharded fleet of ``S`` systems in ``mode``: (its
    keyword arguments without the mesh, [(lead, noise seed)] of every
    system).  The sizes are those of ``tests/test_trunkmesh.py``."""
    import numpy as np
    from dsdneo_tpu_torch.engine import fleetvec as FV
    from dsdneo_tpu_torch.engine.trunk import ChannelMap
    center, ch, _prefix = FV.SYSTEM_MODES[mode]
    cc_off, vc_off = FV.system_offsets(FV.vector(), mode)
    cm = None
    if ch is not None:
        cm = ChannelMap()
        cm.entries[ch] = center + vc_off
    max_tsdus, max_ldus = MESH_FLEET_K[mode]
    kw = dict(n_systems=S, fs=FV.MODE_FS, B=int(FV.MODE_FS),
              cc_offsets_hz=[cc_off] * S, n_voice_rows=4, centers_hz=center,
              mode=mode, hangtime_s=0.6, grant_grace_s=0.5, chan_map=cm,
              max_tsdus=max_tsdus, max_ldus=max_ldus,
              p2_params=MESH_P2 if mode == "p25_mixed" else None)
    rng = np.random.default_rng(SEED + 12 + list(MESH_FLEET_K).index(mode))
    systems = [(int(rng.integers(0, 97)), int(rng.integers(1 << 20)))
               for _ in range(S)]
    return kw, systems


def mesh_blocks(mode: str, systems, dev) -> list:
    """The 1 s CU8 blocks ``[len(systems), 768000, 2]`` on ``dev`` of
    ``systems``' bands (``fleetvec.system_band``: own lead and noise),
    two of signal, then a silent block as float32 zero planes (CU8 has
    no zero: its midpoint carries a DC offset that an analog row would
    hear)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from dsdneo_tpu_torch.engine import fleetvec as FV
    tv = FV.vector()
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        bands = list(ex.map(lambda ls: FV.cu8_planes(FV.system_band(
            tv, mode, ls[0], ls[1], device=dev)), systems))
    bands = torch.stack(bands)
    nb = int(FV.MODE_FS)
    return [bands[:, :nb], bands[:, nb:2 * nb],
            torch.zeros((len(systems), nb, 2), dtype=torch.float32,
                        device=dev)]


def mesh_steps(mesh, x: dict):
    """Phase 12's four channel steps at full width over the rank's rows
    of ``x`` (global ``[C, B, 2]`` arrays or tensors, ``MESH_K`` the
    capacities): {name: (step, the rank's input)}."""
    from dsdneo_tpu_torch.parallel import mesh as PM
    C_all = x["voice"].shape[0]
    made = {
        "voice": PM.make_sharded_voice_step(
            mesh, C_all, x["voice"].shape[1], max_ldus=MESH_K["voice"]),
        "dmr_voice": PM.make_sharded_dmr_voice_step(
            mesh, C_all, x["dmr_voice"].shape[1],
            max_sf=MESH_K["dmr_voice"]),
        "p2_voice": PM.make_sharded_p2_voice_step(
            mesh, C_all, x["p2_voice"].shape[1],
            max_frames=MESH_K["p2_voice"]),
        "p25_cc": PM.make_sharded_p25_cc_step(
            mesh, C_all, x["p25_cc"].shape[1], max_tsdus=MESH_K["p25_cc"])}
    return {k: (st, shard(x[k])) for k, (st, shard) in made.items()}


def mesh_run_steps(mesh, steps: dict) -> dict:
    """Each step once: {name: (its outputs but the fleet metric, gathered
    in rank order; the fleet metric; the voice picks gathered, or
    None)}."""
    from dsdneo_tpu_torch.parallel import dist as pdist
    out = {}
    for name, (st, xs) in steps.items():
        res = st(xs)
        picks = getattr(getattr(st, "body", None), "picks", None)
        out[name] = (tuple(pdist.gather_rows(mesh, r) for r in res[:-1]),
                     res[-1].item(),
                     None if picks is None else pdist.gather_rows(mesh,
                                                                  picks))
    return out


def mesh_time(fn, arg, dev, n: int = 3) -> float:
    """Seconds per call of ``fn(arg)`` after one warm call, each call
    synchronized."""
    fn(arg)
    _sync(dev)
    t = time.perf_counter()
    for _ in range(n):
        fn(arg)
        _sync(dev)
    return (time.perf_counter() - t) / n


def mesh_fleet_run(mesh, mode: str, blocks, S: int) -> dict:
    """The sharded fleet of ``S`` systems over ``blocks`` (all systems'
    rows, or the rank's): PCM and offsets after every step gathered,
    each step's wall ms, the fleet's gathered view."""
    from dsdneo_tpu_torch.parallel import dist as pdist
    from dsdneo_tpu_torch.parallel.trunkfleet import ShardedTrunkedFleet
    kw, _systems = mesh_fleet_spec(mode, S)
    f = ShardedTrunkedFleet(mesh, **kw)
    pcm, offs, ms = [], [], []
    for b in blocks:
        _sync(mesh.device)
        t = time.perf_counter()
        p = f.step(b)
        ms.append((time.perf_counter() - t) * 1e3)
        pcm.append(pdist.gather_rows(mesh, p))
        offs.append(pdist.gather_rows(mesh, f.offs))
    return {"fleet": f, "pcm": pcm, "offs": offs, "ms": ms,
            "view": f.gather()}


def mesh_gloo_rank(mesh, paths: dict, S: int) -> dict | None:
    """One rank of phase 12's gloo run: the four channel steps on the
    rank's rows of the inputs saved at ``paths`` (memory-mapped), each
    timed, and the P25 sharded fleet on the rank's systems; rank 0
    returns the gathered outputs and its times."""
    import numpy as np
    x = {k: np.load(p, mmap_mode="r") for k, p in paths.items()}
    steps = mesh_steps(mesh, x)
    out = mesh_run_steps(mesh, steps)
    ms = {k: mesh_time(st, xs, mesh.device, 2) * 1e3
          for k, (st, xs) in steps.items()}
    del steps
    _kw, systems = mesh_fleet_spec("p25p1", S)
    mine = systems[mesh.rows(S, "system")]
    fl = mesh_fleet_run(mesh, "p25p1", mesh_blocks("p25p1", mine,
                                                   mesh.device), S)
    fl.pop("fleet")
    return {"steps": out, "ms": ms, "fleet": fl} if mesh.rank == 0 else None


def judge_mesh_steps(out: dict, mi: dict) -> str:
    """The channel steps' outputs against the vectors: every channel's
    LDUs and DMR superframes picked as the block holds them whole, the
    valid TSDUs those the block holds whole with the vector's TSBKs and
    a CRC-ok count of three each, every P2 slot stream voiced."""
    import numpy as np
    n_ldu = out["voice"][2].sum(axis=1)
    if not np.array_equal(n_ldu, mi["want_ldus"]):
        bad = np.flatnonzero(n_ldu != mi["want_ldus"])
        raise RuntimeError(f"mesh voice step: LDUs picked on channels "
                           f"{bad[:8]}: {n_ldu[bad[:8]]}, the vector's "
                           f"{mi['want_ldus'][bad[:8]]}")
    n_sf = out["dmr_voice"][2].sum(axis=1)
    d_n = np.array([len(w[0]) for w in mi["d_want"]])
    if not np.array_equal(n_sf, d_n):
        bad = np.flatnonzero(n_sf != d_n)
        raise RuntimeError(f"mesh DMR step: superframes picked on channels "
                           f"{bad[:8]}: {n_sf[bad[:8]]}, the vector's "
                           f"{d_n[bad[:8]]}")
    ct, mtv, m_leads, m_nsym = mi["cc"]
    (blob, valid), cc_ok, _ = out["p25_cc"]
    n_tsdu = 0
    for c in range(blob.shape[0]):
        want = [js for _t, (js, whole) in cc_expected(
            "p25", ct, mtv, int(m_leads[c]), m_nsym).items() if whole]
        got = blob[c][valid[c]].reshape(-1, 3, 38)
        if got.shape[0] != len(want):
            raise RuntimeError(f"mesh CC step: channel {c} took "
                               f"{got.shape[0]} TSDUs, the block holds "
                               f"{len(want)} whole")
        pays = [bytes(mtv["payloads"][j]) for js in want for j in js]
        # the candidates come best first: the TSBKs compared as multisets
        if not ((got[:, :, 12] == 1).all() and sorted(
                map(bytes, got[:, :, :12].reshape(-1, 12))) == sorted(pays)):
            raise RuntimeError(f"mesh CC step: channel {c}'s TSBKs differ "
                               "from the vector's")
        n_tsdu += len(want)
    if cc_ok != 3 * n_tsdu:
        raise RuntimeError(f"mesh CC step: fleet CRC-ok count {cc_ok}, "
                           f"{3 * n_tsdu} TSBKs whole")
    if not (np.abs(out["p2_voice"][0][0]).max(axis=1) > 1e-3).all():
        raise RuntimeError("mesh P2 step: silent slot streams")
    return (f"every channel's LDUs {int(n_ldu.min())}..{int(n_ldu.max())} "
            f"and DMR superframes {int(n_sf.min())}..{int(n_sf.max())} "
            f"picked as the vectors hold them whole, {n_tsdu} TSDUs with "
            f"the vector's TSBKs (CRC-ok count {cc_ok}), all "
            f"{out['p2_voice'][0][0].shape[0]} P2 slot streams voiced")


def judge_mesh_fleet(mode: str, res: dict, S: int) -> None:
    """A mode's sharded fleet over its three blocks: every system's grant
    (both slots for ``p25_mixed``) taken in block 0 with its voice row on
    the granted channel and the others parked, the granted rows voiced
    in block 1 and the parked rows silent, every call released at 3 s
    and every row parked, no drop."""
    import numpy as np
    from dsdneo_tpu_torch.engine import fleetvec as FV
    _cc_off, vc_off = FV.system_offsets(FV.vector(), mode)
    n_calls = 2 if mode == "p25_mixed" else 1
    st = res["view"].stats
    o0 = res["offs"][0]
    e1 = np.abs(res["pcm"][1]).mean(axis=2)          # [S, R_v]
    bad = {"not granted in block 0": np.flatnonzero(
               (o0[:, 1] != vc_off) | (o0[:, 2:] != o0[:, :1]).any(1)),
           "not parked at 3 s": np.flatnonzero(
               (res["offs"][2] != res["offs"][2][:, :1]).any(1)),
           "granted rows silent": np.flatnonzero(
               (e1[:, :n_calls] <= 1e-3).any(1)),
           "parked rows voiced": np.flatnonzero(
               (e1[:, n_calls:] != 0).any(1))}
    bad = {k: v[:8].tolist() for k, v in bad.items() if v.size}
    if (bad or st.grants != n_calls * S or st.releases != st.grants
            or st.busy_drops or st.unresolved or st.policy_drops
            or any(r["state"] not in ("cc", "idle")
                   for r in res["view"].rows)):
        raise RuntimeError(f"mesh fleet {mode}: {st}; systems {bad}")


def compare_mesh_runs(two: dict, one: dict, p25_one: dict, S: int) -> float:
    """The gloo run's outputs (``two``) against the world of one's: voice
    picks, valid blobs, masks and the fleet metrics equal; the PCM of
    rank 0's rows within 1e-6 of the peak (the synthesizers' noise phase
    follows a row's index in its shard); the P25 fleet's log, stats and
    offsets equal and rank 0's systems' PCM within 1e-6 of the peak.
    Returns the largest PCM difference over its peak."""
    import numpy as np
    worst = 0.0

    def close(a, b):
        nonlocal worst
        peak = max(float(np.abs(b).max()), 1e-12)
        d = float(np.abs(a - b).max()) / peak
        worst = max(worst, d)
        return d <= 1e-6

    for name, (arrs, metric, picks) in two["steps"].items():
        a1, m1, p1 = one[name]
        same = ((picks is None or np.array_equal(picks, p1))
                and abs(metric - m1) <= 1e-6 * max(abs(m1), 1e-12))
        if name == "p25_cc":
            v = a1[1]
            same = same and np.array_equal(arrs[1], v) and np.array_equal(
                arrs[0][v], a1[0][v])
        else:
            half = arrs[0].shape[0] // 2
            same = same and close(arrs[0][:half], a1[0][:half])
        if not same:
            raise RuntimeError(f"mesh gloo run: {name} differs from the "
                               "world of one")
    fl = two["fleet"]
    half = S // 2
    if not (fl["view"].log == p25_one["view"].log
            and fl["view"].stats == p25_one["view"].stats
            and all(np.array_equal(a, b)
                    for a, b in zip(fl["offs"], p25_one["offs"]))
            and all(close(a[:half], b[:half])
                    for a, b in zip(fl["pcm"], p25_one["pcm"]))):
        raise RuntimeError("mesh gloo run: the P25 fleet differs from the "
                           "world of one")
    return worst


def mesh_phase(ident: str, dev, counted, show, check_k1, mi: dict) -> dict:
    """Phase 12: the multi-GPU slice (``parallel.mesh``,
    ``parallel.trunkfleet``) on the one card: ``dryrun_multichip(1)``;
    in this process a world of one rank under NCCL runs the four channel
    steps at full width and ``ShardedTrunkedFleet`` of ``MESH_S``
    systems in each mode, judged, held to the port's CPU path (the P25
    fleet to ``TrunkedFleet(cc_device_pick=True)``), timed; K1, K2, K4
    and K5 held to their plain versions at the path's shapes; then two
    ranks sharing the card under gloo, equal to the world of one.
    Returns the kernels' launches on the path."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from dsdneo_tpu_torch import params
    from dsdneo_tpu_torch.engine.fleettrunk import (TrunkedFleet,
                                                    make_row_extractor_body)
    from dsdneo_tpu_torch.parallel import dist as pdist
    from dsdneo_tpu_torch.parallel import mesh as PM
    k1fn, k2fn, k3fn, k7fn, k4fn, k5fn, k6fn, k8fn = counted
    t_phase = time.perf_counter()

    def at() -> str:
        return f"{time.perf_counter() - t_phase:.1f} s into phase 12"

    # -- the multi-chip dry run on one rank under NCCL ------------------
    t1 = time.perf_counter()
    dry = PM.dryrun_multichip(1)[0]
    log(f"mesh: dryrun_multichip(1) (one rank on cuda:0 under NCCL, a "
        f"fresh process): every step ran with its shape, finiteness and "
        f"count checks; fleet power {dry['frontend_power']:.4f}, CC ok "
        f"{dry['cc_ok']}, PCM shapes {dry['pcm_shapes']}; "
        f"{time.perf_counter() - t1:.1f} s [{ident}; {at()}]")

    # -- a world of one rank under NCCL in this process ----------------
    t1 = time.perf_counter()
    mesh = pdist.init_mesh(0, 1, f"tcp://127.0.0.1:{pdist.free_port()}",
                           dev)
    if mesh.backend != "nccl":
        raise RuntimeError(f"mesh: backend {mesh.backend}, not NCCL")
    x = {k: mi[k] for k in ("voice", "dmr_voice", "p2_voice", "p25_cc")}
    Cm = x["voice"].shape[0]
    blocks = {}
    for mode in MESH_FLEET_K:
        _kw, systems = mesh_fleet_spec(mode, MESH_S)
        blocks[mode] = mesh_blocks(mode, systems, dev)
    t_bands = time.perf_counter() - t1
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    steps = mesh_steps(mesh, x)
    out = mesh_run_steps(mesh, steps)
    fleets = {mode: mesh_fleet_run(mesh, mode, blocks[mode], MESH_S)
              for mode in MESH_FLEET_K}
    torch.cuda.synchronize()
    launches = {"mesh": check_launches(
        "mesh path (the four channel steps, then the sharded fleet in five "
        "modes, one rank under NCCL)", counted, (k1fn, k2fn, k4fn, k5fn),
        (k3fn, k7fn, k6fn, k8fn))}
    peak = torch.cuda.max_memory_allocated()
    log(f"mesh path: the steps and the fleets ran once [{at()}]")

    # -- the channel steps: judged, against the CPU on channels 0-1, timed
    judged = judge_mesh_steps(out, mi)
    tab = {"voice": params.load("cpu"), "dmr_voice": params.load_dmr("cpu"),
           "p2_voice": params.load_tdma("p25p2", "cpu"),
           "p25_cc": params.load_cc("p25", "cpu")}
    make = {"voice": PM._p25_voice_body, "dmr_voice": PM._dmr_voice_body,
            "p2_voice": PM._p2_voice_body, "p25_cc": PM._p25_cc_body}
    for name, (st, xs) in steps.items():
        t2 = time.perf_counter()
        body = make[name](2, xs.shape[1], FS, MESH_K[name],
                          tables=tab[name])
        ref = [r.numpy() for r in body(xs[:2].cpu())]
        got = out[name][0]
        if name == "p25_cc":
            # an invalid candidate's blob decodes the drop row's gather
            # (the shard's last channel), so the blobs of the valid ones
            e = 0.0
            v = ref[1]
            ok = (np.array_equal(got[1][:2], v)
                  and np.array_equal(got[0][:2][v], ref[0][v]))
        else:
            rows = ref[0].shape[0]            # P2: two slots a channel
            e = float(np.abs(got[0][:rows] - ref[0]).max())
            ok = (np.array_equal(out[name][2][:2], body.picks.numpy())
                  and e <= 2e-3 * float(np.abs(ref[0]).max()))
        if not ok:
            raise RuntimeError(f"mesh {name}: channels 0-1 differ from the "
                               f"CPU path ({e})")
        cpu_s = time.perf_counter() - t2
        sec = mesh_time(st, xs, dev)
        busy_ms, top = device_busy(lambda: st(xs), 1)
        block_s = xs.shape[1] / FS
        log(f"mesh {name} step at [{Cm}, {xs.shape[1]}] ({block_s:.4f} s "
            f"blocks, K={MESH_K[name]}): {sec * 1e3:.1f} ms = "
            f"{Cm * block_s / sec:.1f}x realtime; device busy "
            f"{busy_ms:.2f} ms = {100 * busy_ms / (sec * 1e3):.1f}%; "
            f"channels 0-1 vs the CPU path ({cpu_s:.1f} s): max abs err "
            f"{e:.2e} (tol 2e-3 * peak; picks and blobs equal); top: "
            + ", ".join(f"{k[:32]} {v:.3f}" for k, v in top.items())
            + f" [{ident}; {at()}]")
    log(f"mesh channel steps judged: {judged} [{at()}]")

    # -- the sharded fleet in each mode ----------------------------------
    cpu = pdist.cpu_mesh(mesh)
    for mode, res in fleets.items():
        judge_mesh_fleet(mode, res, MESH_S)
        t2 = time.perf_counter()
        if mode == "p25p1":
            # the single-device fleet with the device pick on each of the
            # first systems: the same offsets after every block, one
            # grant and one release (tests/test_torch_trunkmesh.py holds
            # the JAX pair to the same)
            kw, _s = mesh_fleet_spec(mode, 1)
            for s in range(MESH_SINGLE):
                one = TrunkedFleet(kw["fs"], kw["cc_offsets_hz"], 4,
                                   center_hz=kw["centers_hz"],
                                   hangtime_s=0.6, grant_grace_s=0.5,
                                   cc_device_pick=True, device=dev)
                for i, b in enumerate(blocks[mode]):
                    one.step(b[s])
                    if one.offs.tolist() != res["offs"][i][s].tolist():
                        raise RuntimeError(
                            f"mesh fleet p25p1: system {s} block {i}: "
                            f"offsets {res['offs'][i][s].tolist()}, the "
                            f"single-device fleet's {one.offs.tolist()}")
                if (one.stats.grants, one.stats.releases) != (1, 1):
                    raise RuntimeError(f"mesh fleet p25p1: system {s}'s "
                                       f"single-device fleet {one.stats}")
            held = (f"systems 0-{MESH_SINGLE - 1} each equal to "
                    f"TrunkedFleet(cc_device_pick=True) on its band "
                    f"(offsets after every block, 1 grant, 1 release)")
        else:
            # the port's CPU path on the first systems (their rows keep
            # their local indices, so the AMBE noise phases are the same)
            ref = mesh_fleet_run(cpu, mode, [b[:MESH_CPU_S].cpu()
                                             for b in blocks[mode]],
                                 MESH_CPU_S)
            lines = [ln for ln in res["view"].log
                     if int(ln.split(" sys ")[1].split()[0]) < MESH_CPU_S]
            pe = max(float(np.abs(a[:MESH_CPU_S] - b).max())
                     / max(float(np.abs(b).max()), 1e-9)
                     for a, b in zip(res["pcm"], ref["pcm"]))
            if not (lines == ref["view"].log and all(
                    np.array_equal(a[:MESH_CPU_S], b)
                    for a, b in zip(res["offs"], ref["offs"]))
                    and pe <= 2e-3):
                raise RuntimeError(f"mesh fleet {mode}: systems 0-"
                                   f"{MESH_CPU_S - 1} differ from the CPU "
                                   f"path (PCM {pe:.2e} of the peak)")
            held = (f"systems 0-{MESH_CPU_S - 1} equal to the port's CPU "
                    f"path (log, offsets after every block; PCM within "
                    f"{pe:.2e} of its peak, tol 2e-3)")
        t_held = time.perf_counter() - t2
        f, st = res["fleet"], res["view"].stats
        # the step: the mean of the judged blocks after the first (which
        # sets up the FFT plans); the P25 fleet also profiled
        sec = sum(res["ms"][1:]) / len(res["ms"][1:]) / 1e3
        busy = "not profiled (the P25 fleet is)"
        if mode == "p25p1":
            busy_ms, _top = device_busy(lambda: f.step(blocks[mode][1]), 1)
            busy = (f"device busy {busy_ms:.2f} ms a step "
                    f"({100 * busy_ms / (sec * 1e3):.1f}%)")
        log(f"mesh fleet {mode}: {MESH_S} systems of 768 kHz CU8 (own lead "
            f"and noise), 1 CC and 4 voice rows each, 1 s blocks: "
            f"{st.grants} grants, {st.releases} releases at 3 s, parked "
            f"rows silent, no drops; {held} ({t_held:.1f} s); the judged "
            f"steps " + "/".join(f"{m:.1f}" for m in res["ms"])
            + f" ms: {sec * 1e3:.1f} ms a step after the first = "
            f"{MESH_S / sec:.1f}x realtime in systems "
            f"({16 * MESH_S / sec:.0f}x in 48 kHz bins); {busy} "
            f"[{ident}; {at()}]")
    log(f"mesh path: the {MESH_S} bands of 5 modes built in {t_bands:.1f} "
        f"s; peak device memory {peak / 1e9:.3f} GB ({mem0 / 1e9:.3f} GB "
        f"allocated before the path) [{ident}; {at()}]")

    # -- K1, K2, K4, K5 at the path's new shapes ------------------------
    res = fleets["p25p1"]
    ex = make_row_extractor_body(16)
    rows = torch.stack([ex(blocks["p25p1"][1][s], torch.as_tensor(
        res["offs"][0][s], device=dev)) for s in range(MESH_S)])
    planes = torch.view_as_real(rows)                    # [S, 5, B', 2]
    taps = mi["tables"].taps
    check_k1(planes[:, 0].contiguous(), taps,
             shape=list(planes[:, 0].shape[:2]))
    check_k1(planes[:, 1:].reshape(-1, *planes.shape[2:]).contiguous(),
             taps, shape=[MESH_S * 4, planes.shape[2]])
    hold_k2(dev, mi["tables"], show, Cm, MESH_K["voice"] * 9,
            "the mesh voice step's steps")
    hold_k2(dev, mi["tables"], show, MESH_S * 4,
            MESH_FLEET_K["p25p1"][1] * 9, "the sharded fleet's voice rows")
    hold_k4(dev, show, 3 * Cm * MESH_K["p25_cc"], "the mesh CC step's TSDUs")
    hold_k4(dev, show, 3 * MESH_S * MESH_FLEET_K["p25p1"][0],
            "the sharded fleet's TSDUs")
    hold_k5(dev, show, params.load_cc("nxdn48", dev),
            MESH_S * MESH_FLEET_K["nxdn48"][0],
            "the sharded NXDN fleet's CACs a block")
    log(f"mesh path: K1, K2, K4, K5 held at its shapes [{at()}]")
    p25_one = fleets["p25p1"]
    p25_one.pop("fleet")
    del rows, planes, steps, fleets, blocks, res
    pdist.close_mesh(mesh)
    torch.cuda.empty_cache()

    # -- two ranks sharing the card under gloo --------------------------
    t1 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mesh_")
    try:
        paths = {}
        for k, v in x.items():
            paths[k] = os.path.join(tmp, f"{k}.npy")
            np.save(paths[k], v.cpu().numpy())
        two = pdist.spawn(mesh_gloo_rank, 2, paths, MESH_S,
                          device=str(dev), backend="gloo")[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    worst = compare_mesh_runs(two, out, p25_one, MESH_S)
    log(f"mesh gloo run (2 ranks sharing {dev}, fresh processes): the four "
        f"channel steps and the P25 fleet equal to the world of one (picks, "
        f"valid blobs, masks, fleet metrics, log, offsets, stats; rank 0's "
        f"PCM rows within {worst:.2e} of the peak, tol 1e-6); rank 0's "
        f"step ms " + ", ".join(f"{k} {v:.1f}" for k, v in two["ms"].items())
        + ", the fleet's " + "/".join(f"{m:.1f}" for m in two["fleet"]["ms"])
        + f"; {time.perf_counter() - t1:.1f} s [{ident}; {at()}]")
    return launches


def hold_k2(dev, tables, show, Cx: int, Tn: int,
            what: str = "the wideband path's steps") -> None:
    """K2 against its plain version on random grids of ``[Cx, Tn]``."""
    import torch
    from dsdneo_tpu_torch.vocoder import device as vdev
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    L = torch.randint(9, 57, (Cx, Tn), generator=g, dtype=torch.int32)
    args = (torch.rand((Cx, Tn, 56), generator=g) * 10.0 - 2.0,
            0.08 + 0.2 * torch.rand((Cx, Tn), generator=g), L,
            torch.clamp((L + 2) // 3, max=12),
            (torch.rand((Cx, Tn, 12), generator=g) > 0.3).float(),
            (torch.rand((Cx, Tn), generator=g) > 0.1).float(),
            torch.rand((Cx, 56), generator=g) * 6.0,
            torch.randint(0, 57, (Cx,), generator=g, dtype=torch.int32))
    args = tuple(a.contiguous().to(dev) for a in args)
    consts = (tables.pred_decay, tables.imbe_amp_scale)
    got = vdev.prediction_scan(*args, *consts)
    want = vdev.prediction_scan_plain(*args, *consts)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    k_ms = cuda_ms(lambda: vdev.prediction_scan(*args, *consts), 20)
    plain_ms = cuda_ms(lambda: vdev.prediction_scan_plain(*args, *consts), 2)
    b_ms, b_by = bound(nbytes(*args, *got),
                       Cx * Tn * 56 * K2_FLOP_PER_HARMONIC)
    log(f"K2 imbe_pred [{Cx},{Tn}] ({what}): max_abs_err {err:.3e} (tol "
        f"rtol 1e-5, atol 1e-5)")
    show("imbe_pred", err, k_ms, plain_ms, b_ms, b_by, shape=[Cx, Tn])


def hold_k4(dev, show, n: int, what: str) -> None:
    """K4 against its plain version on ``n`` random words."""
    import torch
    from dsdneo_tpu_torch.fec import device as fdev
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    bits = torch.randint(0, 2, (n, 196), generator=g,
                         dtype=torch.uint8).to(dev)
    gb, gc = fdev.p25_12_decode_batch(bits)
    wb, wc = fdev.p25_12_decode_plain(bits)
    if not (torch.equal(gb, wb) and torch.equal(gc, wc)):
        raise RuntimeError(f"K4 disagrees with its plain version at {n}")
    k_ms = cuda_ms(lambda: fdev.p25_12_decode_batch(bits), 20)
    plain_ms = cuda_ms(lambda: fdev.p25_12_decode_plain(bits), 2)
    b_ms, b_by = bound(nbytes(bits, gb, gc), 0)
    log(f"K4 p25_trellis [{n},196] ({what}): bits and costs equal the "
        f"plain version's (tol 0)")
    show("p25_trellis", 0.0, k_ms, plain_ms, b_ms, b_by, shape=[n, 196],
         form="uint8 bits")


def hold_k5(dev, show, cc, n: int,
            what: str = "the NXDN fleet's CACs a block") -> None:
    """K5 against its plain version on ``n`` random CAC words with the
    CAC's weight row broadcast (the NXDN fleet's control channel)."""
    import torch
    from dsdneo_tpu_torch.fec import device as fdev
    g = torch.Generator(device="cpu").manual_seed(SEED + 5)
    sym = torch.randint(0, 2, (n, 350), generator=g).float().to(dev)
    wt = cc.cac_wt.to(dev).reshape(1, -1).expand(n, -1)
    got = fdev.conv_k5_decode_batch(sym, wt)
    if not torch.equal(got, fdev.conv_k5_decode_plain(sym, wt)):
        raise RuntimeError(f"K5 disagrees with its plain version at {n}")
    k_ms = cuda_ms(lambda: fdev.conv_k5_decode_batch(sym, wt), 20)
    plain_ms = cuda_ms(lambda: fdev.conv_k5_decode_plain(sym, wt), 1)
    b_ms, b_by = bound(nbytes(sym, wt[0], got), 0)
    log(f"K5 conv_k5 [{n},350] ({what}): bits equal the plain version's "
        f"(tol 0)")
    show("conv_k5", 0.0, k_ms, plain_ms, b_ms, b_by, shape=[n, 350],
         form="broadcast weight row")


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "dsdneo_tpu_torch")):
        print("chip_smoke.py: the dsdneo_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 3
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 2

    # -- 1. set-up ---------------------------------------------------------
    from dsdneo_tpu_torch import device, kernels, params
    from dsdneo_tpu_torch.dsp import audio_filters as af
    from dsdneo_tpu_torch.dsp import cqpsk, firdes
    from dsdneo_tpu_torch.dsp.frontend import fir_complex
    from dsdneo_tpu_torch.engine import voicestate          # noqa: F401
    from dsdneo_tpu_torch.crypto.keyring import KeyRing
    from dsdneo_tpu_torch.engine.dmrbatch import BatchedDmrVoicePipeline
    from dsdneo_tpu_torch.engine.nxdnbatch import BatchedNxdnVoicePipeline
    from dsdneo_tpu_torch.engine.p2batch import BatchedP2VoicePipeline
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu_torch.engine.x2batch import BatchedX2VoicePipeline
    from dsdneo_tpu_torch.fec import device as fdev
    from dsdneo_tpu_torch.fec.rs import gf64_tables, rs_63_35
    from dsdneo_tpu_torch.ops import audio_wire, fir_discriminate as k1mod
    from dsdneo_tpu_torch.protocol.dmr import encode as dmr_encode
    from dsdneo_tpu_torch.protocol.nxdn import encode as nxdn_encode
    from dsdneo_tpu_torch.protocol.p25 import encode
    from dsdneo_tpu_torch.symbols import timing             # noqa: F401
    from dsdneo_tpu_torch.vocoder import device as vdev

    t_start = time.perf_counter()
    marks = []

    def mark(name=None):
        """Log the previous phase's time and the start of phase ``name``
        (none at the end)."""
        now = time.perf_counter() - t_start
        if marks:
            log(f"phase {marks[-1][0]} took {now - marks[-1][1]:.1f} s")
        if name is not None:
            marks.append((name, now))
            log(f"phase {name} starts at {now:.1f} s")

    dev = device.require_cuda()
    ident = device.card_identity().splitlines()[0]
    log(ident)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_count {torch.cuda.device_count()}")
    no_reference_modules()
    mark("1 (the kernels' build and the set-up)")
    # full float32 for every matmul the paths take; the convolution of the
    # CQPSK path (fir_complex) switches cuDNN's TF32 off itself, and its
    # check in phase 2 runs with the process's switch on
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the designs that lost to the kernels (not shipped), each built by its
    # own nvcc beside the library's build: K4's and K5's lanes per word,
    # K6's first design, K7's first, bit-sliced and int8-mma designs, K8's
    # second design and the present K8 at 16 and 32 rows a block
    import ctypes
    import subprocess
    alt_src = {"viterbi_lanes": ("alt/viterbi_lanes.cu", []),
               "conv_k3_v1": ("alt/conv_k3_v1.cu", []),
               "rs_syndromes_v1": ("alt/rs_syndromes_v1.cu", []),
               "rs_syndromes_v2": ("alt/rs_syndromes_v2.cu", []),
               "rs_syndromes_mma": ("alt/rs_syndromes_mma.cu", []),
               "one_pole_v2": ("alt/one_pole_v2.cu", []),
               "one_pole_rows16": ("one_pole.cu", ["-DDSD_K8_ROWS=16"]),
               "one_pole_rows32": ("one_pole.cu", ["-DDSD_K8_ROWS=32"])}
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    alt_cc = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, *defs, "-shared", "-o",
         os.path.join(kernels.BUILD_DIR, f"{name}.so"),
         os.path.join(kernels.CSRC, src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, defs) in alt_src.items()}
    try:
        info = kernels.build_info()
    finally:
        alt_log = {name: cc.communicate()[0] for name, cc in alt_cc.items()}
    alt = {}
    for name, cc in alt_cc.items():
        if cc.returncode:
            raise RuntimeError(f"nvcc failed on {alt_src[name][0]}:\n"
                               f"{alt_log[name]}")
        alt[name] = ctypes.CDLL(os.path.join(kernels.BUILD_DIR, f"{name}.so"))
        for k, v in sorted(kernels.ptxas_report(alt_log[name]).items()):
            log(f"design not shipped, {name}, {k}: {v['registers']} "
                f"registers, {v['stack']} bytes stack frame")
    lanes = alt["viterbi_lanes"]
    lanes.dsd_conv_k5_lanes.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_void_p]
    lanes.dsd_p25_trellis_lanes.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p]
    alt["conv_k3_v1"].dsd_conv_k3.argtypes = kernels._SIGNATURES[
        "dsd_conv_k3"]
    # words, exp table, log table, out, N, n, nroots, fcr, stream
    alt["rs_syndromes_v1"].dsd_rs_syndromes.argtypes = [
        ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    # words, exp table, out, N, n, nroots, fcr, stream
    alt["rs_syndromes_v2"].dsd_rs_syndromes.argtypes = [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    # words, table (k7_mma_table), out, N, n, nroots, stream
    alt["rs_syndromes_mma"].dsd_rs_syndromes_mma.argtypes = [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    # x, out, R, T, a, b, diff, stream: one filter a launch
    alt["one_pole_v2"].dsd_one_pole.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    for rows in (16, 32):
        alt[f"one_pole_rows{rows}"].dsd_one_pole.argtypes = \
            kernels._SIGNATURES["dsd_one_pole"]
    log(f"kernels built in {info['seconds']:.2f} s -> "
        f"{os.path.relpath(info['path'], HERE)}")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())
    # the instances of K4 (2), K5 (2), K6 (2), K7 (1) and K8 (6: 3 modes
    # x aligned or not): registers, stack and spills; none may use local
    # memory
    want_inst = {"p25_trellis_kernel": 2, "conv_k5_kernel": 2,
                 "conv_k3_kernel": 2, "rs_syndromes_kernel": 1,
                 "one_pole_kernel": 6}
    res = kernels.ptxas_report(info["log"])
    for stem, count in want_inst.items():
        inst = {k: v for k, v in res.items() if stem in k}
        if len(inst) != count:
            raise RuntimeError(f"expected {count} {stem} instances in the "
                               f"build log, found {sorted(inst)}")
        for k, v in sorted(inst.items()):
            log(f"K4-K8 resources, {k}: {v['registers']} registers, "
                f"{v['stack']} bytes stack frame, {v['spill_stores']} / "
                f"{v['spill_loads']} bytes spill stores / loads")
            if v["stack"] or v["spill_stores"] or v["spill_loads"]:
                raise RuntimeError(f"{k} uses local memory")

    t0 = time.perf_counter()
    tables = params.load(dev)
    tv = tables.test_vector()
    B = int(FS * BLOCK_S)
    n_sym = int(B // (FS / tables.symbol_rate)) - 2
    rng = np.random.default_rng(SEED)
    leads = rng.integers(30, len(tv["lead"]) + 1, size=C)
    seeds = rng.permutation(1 << 20)[:2 * C]
    setup_s = {}
    t_part = [t0]

    def lap(name):
        now = time.perf_counter()
        setup_s[name] = setup_s.get(name, 0.0) + now - t_part[0]
        t_part[0] = now

    lap("tables")
    blocks = [torch.as_tensor(par_block(encode.vector_block, tv, leads,
                                        seeds[i::2], B)).to(dev)
              for i in range(2)]
    want_ldus = np.array([encode.expected_ldus(tv, int(l), n_sym)
                          for l in leads])
    # CQPSK: the same vector, own carrier offset per channel; the
    # differential demodulator gives its first symbol up, so every sync
    # sits one dibit earlier
    cfo = rng.uniform(-CFO_MAX_HZ, CFO_MAX_HZ, size=C)
    lap("P25")
    # the pool's blocks are the serial blocks: the first P25 block built
    # once more in one call, compared and timed
    serial0 = encode.vector_block(tv, leads, seeds[0::2], B)
    if not np.array_equal(serial0, blocks[0].cpu().numpy()):
        raise RuntimeError("set-up: the thread pool's P25 block differs "
                           "from the serial build")
    del serial0
    lap("the P25 block again, serially")
    q_blocks = [torch.as_tensor(par_block(
        encode.vector_block, tv, leads, seeds[i::2], B, modulation="cqpsk",
        cfo_hz=cfo)).to(dev) for i in range(2)]
    lap("CQPSK")
    q_want_ldus = np.array([encode.expected_ldus(tv, int(l) - 1, n_sym)
                            for l in leads])
    # DMR: the 8-superframe stream, own leading offset per channel
    dtab = params.load_dmr(dev)
    dtv = dtab.test_vector()
    d_B = len(dtv["dibits"]) * 10
    d_block_s = d_B / FS
    d_n_sym = d_B // 10 - 2
    d_leads = rng.integers(0, DMR_MAX_LEAD + 1, size=C)
    d_seeds = rng.permutation(1 << 20)[:2 * C]
    d_blocks = [torch.as_tensor(par_block(
        dmr_encode.vector_block, dtv, d_leads, d_seeds[i::2], d_B)).to(dev)
        for i in range(2)]
    lap("DMR")
    d_want = [dmr_encode.expected_frames(dtv, int(l), d_n_sym)
              for l in d_leads]
    # X2, P2, NXDN48: the vectors of data/tdma_tables.npz, own lead of
    # 0-96 random dibits and own noise per channel
    def tdma_blocks(tv, sps, n_samples, modulate, n_ch=C):
        leads = rng.integers(0, TDMA_MAX_LEAD + 1, size=n_ch)
        sd = rng.permutation(1 << 20)[:2 * n_ch]
        return tv, leads, [torch.as_tensor(par_block(
            dmr_encode.vector_block, tv, leads, sd[i::2], n_samples,
            sps=sps, modulate=modulate, lead_dibits=tv.get("lead"))).to(dev)
            for i in range(2)]

    xtab = params.load_tdma("x2tdma", dev)
    x_B = len(xtab.test_vector()["dibits"]) * 8
    xtv, x_leads, x_blocks = tdma_blocks(xtab.test_vector(), 8, x_B,
                                         encode.tdma_fm_iq)
    x_n_sym = x_B // 8 - 2
    x_want = [dmr_encode.expected_frames(xtv, int(l), x_n_sym)
              for l in x_leads]
    lap("X2")
    ptab = params.load_tdma("p25p2", dev)
    p_B = len(ptab.test_vector()["dibits"]) * 8
    ptv, p_leads, p_blocks = tdma_blocks(ptab.test_vector(), 8, p_B,
                                         encode.tdma_fm_iq)
    lap("P2")
    ntab = params.load_tdma("nxdn48", dev)
    n_B = int(FS * BLOCK_S)
    ntv, n_leads, n_blocks = tdma_blocks(ntab.test_vector(), 20, n_B,
                                         nxdn_encode.modulator("nxdn48"))
    lap("NXDN48")
    adp = {k[4:]: v for k, v in ptab.test_vector().items()
           if k.startswith("adp_")}
    a_B = len(adp["dibits"]) * 8
    _atv, _a_leads, a_blocks = tdma_blocks(adp, 8, a_B, encode.tdma_fm_iq)
    lap("ADP")
    # the control-channel monitors: the vectors of data/cc_tables.npz,
    # 3 s blocks, own lead of 0-96 dibits (a suffix of the vector's
    # filler, which scores no false sync) and own noise per channel
    mon = {}
    for kind, sps, modulate in (
            ("p25", 10, lambda d, s: encode.c4fm_clean(d, s)),
            ("dmr", 10, dmr_encode.dmr_fm_iq),
            ("nxdn48", 20, nxdn_encode.modulator("nxdn48"))):
        ct = params.load_cc(kind, dev)
        mtv, m_leads, m_blocks = tdma_blocks(ct.test_vector(), sps, B,
                                             modulate)
        mon[kind] = (ct, mtv, m_leads, m_blocks, B // sps - 2)
        lap(f"{kind} CC")
    # the event pipelines: the bursty streams of data/event_tables.npz,
    # 3 s blocks, own lead of 0-96 dibits of dead air and own noise per
    # channel
    from dsdneo_tpu_torch.protocol.dstar import encode as dstar_encode
    from dsdneo_tpu_torch.protocol.m17 import encode as m17_encode
    ev = {}
    for kind, modulate in (("dstar", dstar_encode.fm_iq),
                           ("m17", m17_encode.fm_iq)):
        et = params.load_event(kind, dev)
        etv, e_leads, e_blocks = tdma_blocks(et.test_vector(), 10, B,
                                             modulate)
        ev[kind] = (et, etv, e_leads, e_blocks, B // 10 - 2)
        lap(kind)
    # the paths of data/burst_tables.npz: YSF and dPMR (bursty voice, a
    # lead of dead air) and the continuous EDACS control channel (the
    # lead is a frame's tail); every fourth channel (c % 4 == 3) of dPMR
    # and EDACS with the FM negated
    from dsdneo_tpu_torch.protocol.dpmr import encode as dpmr_encode
    from dsdneo_tpu_torch.protocol.edacs import encode as edacs_encode
    from dsdneo_tpu_torch.protocol.ysf import encode as ysf_encode
    burst = {}
    inv_rows = np.arange(3, C, 4)
    for kind, mod, sps in (("ysf", ysf_encode, 10), ("dpmr", dpmr_encode, 20),
                           ("edacs", edacs_encode, 5)):
        bt = params.load_burst(kind, dev)
        btv, b_leads, b_blocks = tdma_blocks(bt.test_vector(), sps, B,
                                             mod.fm_iq)
        if kind != "ysf":
            for xb in b_blocks:
                xb[inv_rows, :, 1] *= -1.0
        burst[kind] = (bt, btv, b_leads, b_blocks, B // sps - 2)
        lap(kind)
    # phase 12's inputs: the first blocks of four of the paths above
    mesh_in = {"voice": blocks[0], "want_ldus": want_ldus,
               "dmr_voice": d_blocks[0], "d_want": d_want,
               "p2_voice": p_blocks[0], "p25_cc": mon["p25"][3][0],
               "cc": (mon["p25"][0], mon["p25"][1], mon["p25"][2],
                      mon["p25"][4]), "tables": tables}
    log(f"set-up {time.perf_counter() - t0:.1f} s: C={C}; P25 B={B} "
        f"({BLOCK_S} s) n_sym={n_sym}, LDUs per channel "
        f"{want_ldus.min()}..{want_ldus.max()} (CQPSK "
        f"{q_want_ldus.min()}..{q_want_ldus.max()}, carrier offsets "
        f"{cfo.min():.1f}..{cfo.max():.1f} Hz); DMR B={d_B} "
        f"({d_block_s:.4f} s) n_sym={d_n_sym}, superframes per channel "
        f"{min(len(w[0]) for w in d_want)}..{max(len(w[0]) for w in d_want)}"
        f"; X2 B={x_B}, P2 B={p_B}, NXDN48 B={n_B}, ADP "
        f"B={a_B}; control channels B={B}: P25 "
        f"{len(mon['p25'][1]['starts'])} TSDUs, DMR "
        f"{len(mon['dmr'][1]['starts'])} CSBKs, NXDN48 "
        f"{len(mon['nxdn48'][1]['starts'])} CAC frames in the vectors; "
        f"event streams B={B}: D-STAR {len(ev['dstar'][1]['hd_starts'])} "
        f"headers and {len(ev['dstar'][1]['sf_starts'])} superframes, M17 "
        f"{len(ev['m17'][1]['fr_starts'])} stream frames in "
        f"{len(ev['m17'][1]['lsf'])} transmissions; burst streams B={B}: "
        f"YSF {len(burst['ysf'][1]['starts'])} frames "
        f"({int(burst['ysf'][1]['voice'].sum())} voice), dPMR "
        f"{len(burst['dpmr'][1]['starts'])} parts, EDACS "
        f"{len(burst['edacs'][1]['starts'])} frames")
    log("set-up parts (s; each family's two blocks built over "
        f"{os.cpu_count()} threads): "
        + ", ".join(f"{k} {v:.1f}" for k, v in setup_s.items())
        + f"; the first P25 block serially "
        f"{setup_s['the P25 block again, serially']:.1f} s against "
        f"{setup_s['P25'] / 2:.1f} s a block over the pool, bit for bit "
        f"the same")

    # -- 2. kernels against their plain versions ---------------------------
    mark("2")
    report = {}
    clk = sm_clock_mhz()

    def show(name, err, k_ms, plain_ms, b_ms, b_by, extra="", shape=None,
             form=None):
        log(f"  {name}: kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / k_ms:.1f}% of "
            f"the bound{extra}")
        row = {"max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by}
        if form is not None:
            row["form"] = form
        if shape is None:
            report[name] = row
        else:                   # a further shape of a kernel already shown
            report[name].setdefault("other_shapes", []).append(
                {"shape": shape, **row})

    def check_k1(x, taps, shape=None):
        """K1 on the two stride-2 views of the block ``x``, as the paths
        give it, against its plain version (cuDNN in full float32)."""
        Cx, Bx = x.shape[:2]
        xr, xi = x[..., 0], x[..., 1]
        ntaps = taps.shape[0]
        got = k1mod.fir_discriminate(xr, xi, taps)
        planes = k1mod.fir_discriminate(xr.contiguous(), xi.contiguous(),
                                        taps)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            want = k1mod.fir_discriminate_plain(xr, xi, taps)
            plain_ms = cuda_ms(lambda: k1mod.fir_discriminate_plain(
                xr, xi, taps), 5)
        err = float((got - want).abs().max())
        k_ms = cuda_ms(lambda: k1mod.fir_discriminate(xr, xi, taps), 20)
        log(f"K1 fir_disc [{Cx},{Bx}], {ntaps} taps: max_abs_err {err:.3e} "
            f"(tol 2e-4); views equal contiguous planes: "
            f"{bool(torch.equal(got, planes))}")
        if not err <= 2e-4 or not torch.equal(got, planes):
            raise RuntimeError(f"K1 disagrees with its plain version: {err}")
        # FIR: 2 planes x ntaps multiply-adds; the conjugate product 6 FLOP
        b_ms, b_by = bound(nbytes(x, got, taps), Cx * Bx * (4 * ntaps + 6))
        show("fir_disc", err, k_ms, plain_ms, b_ms, b_by, shape=shape)

    check_k1(blocks[0], tables.taps)
    check_k1(d_blocks[0], dtab.taps, shape=[C, d_B])

    Tn = 162                               # 16 LDUs · 9 frames, padded to 27s
    g = torch.Generator(device="cpu").manual_seed(SEED)
    L = torch.randint(9, 57, (C, Tn), generator=g, dtype=torch.int32)
    args = (torch.rand((C, Tn, 56), generator=g) * 10.0 - 2.0,
            0.08 + 0.2 * torch.rand((C, Tn), generator=g), L,
            torch.clamp((L + 2) // 3, max=12),
            (torch.rand((C, Tn, 12), generator=g) > 0.3).float(),
            (torch.rand((C, Tn), generator=g) > 0.1).float(),
            torch.rand((C, 56), generator=g) * 6.0,
            torch.randint(0, 57, (C,), generator=g, dtype=torch.int32))
    args = tuple(a.contiguous().to(dev) for a in args)
    consts = (tables.pred_decay, tables.imbe_amp_scale)
    got = vdev.prediction_scan(*args, *consts)
    want = vdev.prediction_scan_plain(*args, *consts)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    k_ms = cuda_ms(lambda: vdev.prediction_scan(*args, *consts), 20)
    plain_ms = cuda_ms(lambda: vdev.prediction_scan_plain(*args, *consts), 2)
    log(f"K2 imbe_pred [{C},{Tn}]: max_abs_err {err:.3e} "
        f"(tol rtol 1e-5, atol 1e-5)")
    b_ms, b_by = bound(nbytes(*args, *got), C * Tn * 56 * K2_FLOP_PER_HARMONIC)
    floor_ms = Tn * K2_CHAIN_CYCLES / (clk * 1e3)
    show("imbe_pred", err, k_ms, plain_ms, b_ms, b_by,
         f"; recurrence floor ~{floor_ms:.4f} ms ({Tn} steps x "
         f"{K2_CHAIN_CYCLES} cycles at {clk:.0f} MHz), "
         f"{100 * floor_ms / k_ms:.1f}% of it")
    k2_rand = args
    del got, want

    def three_tones(S, T):
        tt = torch.arange(T, dtype=torch.float32) / 8000.0
        f = 200.0 + 1500.0 * torch.rand((S, 3, 1), generator=g)
        a = 0.3 * torch.rand((S, 3, 1), generator=g)
        x = torch.clamp((a * torch.sin(2 * np.pi * f * tt)).sum(1)
                        + 0.01 * torch.randn((S, T), generator=g), -1.0, 1.0)
        return x.contiguous().to(dev)

    def check_k3(pcm, shape=None, rows=None):
        """K3 on ``pcm`` against its plain version (on the first ``rows``
        rows where given, and timed there): bit-identical."""
        S, T = pcm.shape
        got = audio_wire.adpcm_compress(pcm, tables.adpcm_step,
                                        tables.adpcm_index)
        n = S if rows is None else rows
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = audio_wire.adpcm_compress_plain(pcm[:n], tables.adpcm_step,
                                               tables.adpcm_index)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        n_diff = int((got[:n] != want).sum())
        err = float((got[:n].int() - want.int()).abs().max())
        k_ms = cuda_ms(lambda: audio_wire.adpcm_compress(
            pcm, tables.adpcm_step, tables.adpcm_index), 20)
        log(f"K3 adpcm_enc [{S},{T}] three-tone sinusoids: {n_diff} bytes "
            f"differ on {n} rows (tol 0: bit-identical)"
            + ("" if n == S else f"; the plain version's time is on "
                                   f"those {n} rows"))
        if n_diff:
            raise RuntimeError("K3 is not bit-identical to its plain "
                               "version")
        b_ms, b_by = bound(nbytes(pcm, got), 0)
        k3_floor_ms = T * K3_CHAIN_CYCLES / (clk * 1e3)
        show("adpcm_enc", err, k_ms, plain_ms, b_ms, b_by,
             f"; recurrence floor ~{k3_floor_ms:.4f} ms ({T} samples x "
             f"{K3_CHAIN_CYCLES} cycles at {clk:.0f} MHz), "
             f"{100 * k3_floor_ms / k_ms:.1f}% of it", shape=shape)
        if n != S:
            report["adpcm_enc"]["other_shapes"][-1]["plain_rows"] = n

    S, T = C, Tn * 160
    sines = three_tones(S, T)
    check_k3(sines)
    # the DMR path: 16 superframes x 18 frames = 288 steps (a multiple of
    # the 36-step bucket) of 160 samples
    d_T = 16 * 18 * 160
    check_k3(three_tones(C, d_T), shape=[C, d_T])
    # P2: 640 slot streams of 8 superframes x 18 frames = 144 steps (the
    # 36-step bucket); NXDN48: 36 frames x 4 = 144 steps (16-step bucket)
    check_k3(three_tones(2 * C, 144 * 160), shape=[2 * C, 144 * 160],
             rows=K3_CHECK_ROWS)
    check_k3(three_tones(C, 144 * 160), shape=[C, 144 * 160],
             rows=K3_CHECK_ROWS)
    check_k1(x_blocks[0], xtab.taps, shape=[C, x_B])
    check_k1(p_blocks[0], ptab.taps, shape=[C, p_B])
    check_k1(n_blocks[0], ntab.taps, shape=[C, n_B])

    # the CQPSK path's matched filter on the card against the CPU, with
    # the process's cuDNN TF32 switch on: fir_complex must not need it off
    rrc = torch.as_tensor(firdes.rrc(10.0, 81, 0.2), device=dev)
    xq = torch.view_as_complex(q_blocks[0])
    torch.backends.cudnn.allow_tf32 = True
    try:
        y = fir_complex(xq, rrc)
        rrc_ms = cuda_ms(lambda: fir_complex(xq, rrc), 5)
        left_on = torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    y_cpu = fir_complex(xq[:2].cpu(), rrc.cpu())
    err = float((y[:2].cpu() - y_cpu).abs().max())
    log(f"fir_complex [{C},{B}] complex, 81 RRC taps, on the card with "
        f"cuDNN's TF32 switch on: max_abs_err {err:.3e} against the CPU on "
        f"channels 0-1 (tol 1e-5, peak {float(y_cpu.abs().max()):.3f}), "
        f"{rrc_ms:.3f} ms; switch left on: {left_on}")
    if not err <= 1e-5 or not left_on:
        raise RuntimeError("fir_complex is not full float32 on the card")
    del y, xq

    # K8: behind the four audio filters, bit for bit against its plain
    # version on audio with silent stretches (the state decays into the
    # subnormal range, which both flush to zero)
    k8_filters = (
        ("deemphasis(tau 750 us)", af.deemphasis,
         af.deemphasis_pole(8000.0, 750.0), False),
        ("audio_lpf(3400 Hz)", af.audio_lpf,
         af.lowpass_pole(8000.0, 3400.0), False),
        ("dc_block", af.dc_block, af.lowpass_pole(8000.0, 30.0), True),
        ("audio_hpf", af.audio_hpf, af.lowpass_pole(8000.0, 300.0), True))

    def k8_audio(R, T):
        x = three_tones(R, T) * 3.0
        x[:, T // 3:T // 3 + 1500] = 0.0
        return x.contiguous()

    k8_de = af.deemphasis_pole(8000.0, 750.0)
    k8_lp = af.lowpass_pole(8000.0, 3400.0)

    def show_k8(x, cascade, want, plain_ms, extra, shape=None):
        """K8 at ``x`` (the de-emphasis, or its cascade with the 3400 Hz
        low-pass) held bit for bit to ``want``, the plain version's result
        on ``x`` (``plain_ms`` its time), and timed beside its bound, its
        chain floor, the second design's recorded time and this PR's
        prediction."""
        R, T = x.shape
        form = "cascade" if cascade else "one filter"

        def fn():
            return af._one_pole_card(x, 2 if cascade else 0, k8_de, k8_lp)
        got = fn()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise RuntimeError(f"K8's {form} at [{R},{T}] is not "
                               f"bit-identical to its plain version: {err}")
        k_ms = cuda_ms(fn, 20)
        b_ms, b_by = bound(nbytes(x, got), (6 if cascade else 3) * R * T)
        floor_ms = T * K8_CHAIN_CYCLES / (clk * 1e3)
        pred = K8_PREDICTED_MS.get((form, T))
        before = K8_BEFORE_MS.get(T)
        show("one_pole", err, k_ms, plain_ms, b_ms, b_by,
             f"; {form}; max_abs_err {err} (tol 0); chain floor "
             f"~{floor_ms:.4f} ms ({T} steps x {K8_CHAIN_CYCLES} cycles at "
             f"{clk:.0f} MHz), {100 * floor_ms / k_ms:.1f}% of it; "
             f"predicted "
             f"{'-'.join(map(str, pred)) if pred else 'no prediction'} ms"
             + ("" if before is None else
                f"; second design {before:.4f} ms a filter") + extra,
             shape=shape, form=form)
        (report["one_pole"] if shape is None else
         report["one_pole"]["other_shapes"][-1]).update(
            chain_floor_ms=floor_ms, predicted_ms=pred, before_ms=before)

    def k8_plain(x):
        """The plain de-emphasis of ``x`` and its cascade with the low-pass
        (``one_pole_plain`` twice), each with its time in ms."""
        y, outs, ms = x, [], 0.0
        for a in (k8_de, k8_lp):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            y = af.one_pole_plain(y, a)
            torch.cuda.synchronize()
            ms += (time.perf_counter() - t1) * 1e3
            outs += [y, ms]
        return tuple(outs)

    def check_k8(x, shape=None):
        """K8 behind each filter, and the cascade of the de-emphasis and
        the low-pass through ``condition_audio``, against their plain
        versions on ``x``, bit for bit; the de-emphasis and the cascade
        timed beside the plain versions' times."""
        R, T = x.shape
        y_de, ms_de, y_cas, ms_cas = k8_plain(x)
        for name, fn, a, diff in k8_filters:
            got = fn(x)
            want = (y_de if (a, diff) == (k8_de, False) else
                    af.one_pole_plain(x, a, diff))
            n_diff = int((got != want).sum())
            log(f"K8 one_pole [{R},{T}] {name}: {n_diff} samples differ "
                f"from the plain version (tol 0: bit-identical); "
                f"{int((want == 0).sum())} zeros")
            if n_diff:
                raise RuntimeError(f"K8 is not bit-identical to its plain "
                                   f"version behind {name}")
        got = af.condition_audio(x, deemph="nfm", audio_lpf_hz=3400)
        n_diff = int((got != y_cas).sum())
        log(f"K8 one_pole [{R},{T}] cascade (condition_audio nfm, 3400 Hz, "
            f"one launch): {n_diff} samples differ from two plain calls "
            "(tol 0: bit-identical)")
        if n_diff:
            raise RuntimeError("K8's cascade is not bit-identical to two "
                               "plain calls")
        show_k8(x, False, y_de, ms_de, "", shape=shape)
        show_k8(x, True, y_cas, ms_cas, "; the plain time is two calls'",
                shape=shape or [R, T])

    check_k8(k8_audio(C, K8_T))
    check_k8(k8_audio(C, K8_RAGGED_T), shape=[C, K8_RAGGED_T])

    def k8_design(name, x, mode):
        """K8's second design (one filter a launch: the cascade is two)
        or the present one built at 16 or 32 rows a block, on ``x``."""
        R, T = x.shape
        lib, src, out = alt[name], x, None
        if name == "one_pole_v2":
            for a in (k8_de,) if mode == 0 else (k8_de, k8_lp):
                out = torch.empty_like(x)
                kernels.check(lib.dsd_one_pole(
                    src.data_ptr(), out.data_ptr(), R, T, *af._coeffs(a), 0,
                    kernels.stream_handle(x)), name)
                src = out
        else:
            out = torch.empty_like(x)
            kernels.check(lib.dsd_one_pole(
                x.data_ptr(), out.data_ptr(), R, T, *af._coeffs(k8_de),
                *af._coeffs(k8_lp), mode, None, kernels.stream_handle(x)),
                name)
        return out

    # K8 beside its second design and at 16 and 32 rows a block (rows
    # 16-byte aligned, ragged, and a view 4 bytes off alignment), each
    # held bit for bit to the kernel; then the kernel's cycles a step,
    # from the slope of its time over T
    for label, R, T, off in (("", C, K8_T, 0), ("", C, K8_RAGGED_T, 0),
                             (", 4 bytes off alignment", C, K8_T, 1)):
        buf = torch.zeros(R * T + off, device=dev)
        buf[off:] = k8_audio(R, T).flatten()
        xd = buf[off:].view(R, T)
        parts = []
        for mode, form in ((0, "one filter"), (2, "cascade")):
            want = af._one_pole_card(xd, mode, k8_de, k8_lp)
            t = [cuda_ms(lambda: af._one_pole_card(xd, mode, k8_de, k8_lp),
                         20)]
            for name in ("one_pole_v2", "one_pole_rows16",
                         "one_pole_rows32"):
                if not torch.equal(k8_design(name, xd, mode), want):
                    raise RuntimeError(f"K8's design {name} differs from "
                                       f"the kernel at [{R},{T}]{label}")
                t.append(cuda_ms(lambda: k8_design(name, xd, mode), 20))
            parts.append(f"{form}: kernel (8 rows a block) {t[0]:.4f}, "
                         f"second design {t[1]:.4f}, 16 rows {t[2]:.4f}, "
                         f"32 rows {t[3]:.4f}")
        log(f"K8 designs at [{R},{T}]{label} (ms; each bit for bit equal "
            f"to the kernel): {'; '.join(parts)}")
    for label, T0, T1 in (("16-byte-aligned rows", 4000, 24000),
                          ("ragged rows", 4001, 24001)):
        x0, x1 = k8_audio(C, T0), k8_audio(C, T1)
        for mode, form in ((0, "one filter"), (2, "cascade")):
            t0, t1 = (cuda_ms(lambda xx=xx: af._one_pole_card(
                xx, mode, k8_de, k8_lp), 20) for xx in (x0, x1))
            slope = (t1 - t0) / (T1 - T0)
            log(f"K8 [{C}, T], {label}, {form}: {t0:.4f} ms at T = {T0}, "
                f"{t1:.4f} at {T1}: {slope * clk * 1e3:.2f} cycles a step "
                f"at {clk:.0f} MHz, {(t0 - slope * T0) * 1e3:.2f} us fixed")
    del xd, x0, x1, buf
    # the compiled loops of K8 and K6, and of their earlier designs
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    for so, stem in (("one_pole_v2.so", "one_pole_kernelILb1ELb0E"),
                     (info["path"], "one_pole_kernelILi0ELb1E"),
                     (info["path"], "one_pole_kernelILi2ELb1E"),
                     ("conv_k3_v1.so", "conv_k3_kernel"),
                     (info["path"], "conv_k3_kernelILb1E")):
        so = os.path.join(kernels.BUILD_DIR, so)
        for line in (sass_loops(cuobjdump, so, stem)
                     if os.path.isfile(cuobjdump) else ["no cuobjdump"]):
            log(f"SASS {os.path.basename(so)} {stem}: {line}")

    # -- 3. the paths at C=320 ----------------------------------------------
    mark("3")
    counted = (k1mod.fir_discriminate, vdev.prediction_scan,
               audio_wire.adpcm_compress, fdev.rs_syndromes_batch,
               fdev.p25_12_decode_batch, fdev.conv_k5_decode_batch,
               fdev.conv_k3_decode_batch, af.one_pole)
    k1fn, k2fn, k3fn, k7fn, k4fn, k5fn, k6fn, k8fn = counted
    cpu_tables = params.load("cpu")

    def run_p25_path(label, xblocks, cqpsk_on, want_n):
        """Both formats over two blocks with the carry kept; returns the
        PCM by (format, block), the launches, and what the timing by
        input reads."""
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outputs, keep = {}, {}
        for fmt in ("f16", "adpcm"):
            # no device given: the pipeline takes the card itself
            pipe = BatchedP25VoicePipeline(C, FS, cqpsk=cqpsk_on,
                                           pcm_fmt=fmt, tables=tables)
            for blk, xb in enumerate(xblocks):
                t1 = time.perf_counter()
                pcm = pipe.fetch_pcm(pipe.decode_block_async(xb))
                dt = time.perf_counter() - t1
                bits, errs, fch, forder = pipe.last_frames
                bits = bits.cpu().numpy()
                got_ldus = np.bincount(fch, minlength=C) // 9
                bad = np.flatnonzero(got_ldus != want_n)
                if bad.size:
                    raise RuntimeError(
                        f"{label} {fmt} block {blk}: channels "
                        f"{bad[:8].tolist()} accepted "
                        f"{got_ldus[bad[:8]].tolist()} LDUs, want "
                        f"{want_n[bad[:8]].tolist()}")
                for c in range(C):
                    sel = np.flatnonzero(fch == c)
                    fb = bits[sel[np.argsort(forder[sel])]]
                    if not np.array_equal(fb, tv["bits88"][:len(fb)]):
                        raise RuntimeError(
                            f"{label} {fmt} block {blk} channel {c}: IMBE "
                            "bits differ from the vector")
                rms = check_pcm(f"{label} {fmt} block {blk}", pcm)
                log(f"{label} {fmt} block {blk}: {C}/{C} channels accept "
                    f"{want_n.min()}..{want_n.max()} LDUs, "
                    f"{bits.shape[0]} frames' IMBE bits equal the vector "
                    f"(max ECC errors {int(errs.max())}), PCM {pcm.shape} "
                    f"finite, rms {rms.min():.4f}..{rms.max():.4f}, "
                    f"{dt * 1e3:.1f} ms")
                outputs[fmt, blk] = pcm
                if fmt == "f16" and blk == 0:
                    keep["carry01"] = [None if st is None else
                                       tuple(t[:2].cpu() for t in st)
                                       for st in pipe.voice_state()]
                    keep["k2_carry"] = pipe.voice_state()[0]
                if fmt == "f16" and blk == 1:
                    keep["k2_frames"] = pipe.last_frames
                    keep["k2_steps"] = pipe.last_steps
        launches = check_launches(
            label, counted, (k2fn, k3fn) if cqpsk_on else (k1fn, k2fn, k3fn),
            (k1fn, k7fn, k4fn, k5fn) if cqpsk_on else (k7fn, k4fn, k5fn))
        log(f"{label}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        no_reference_modules()

        # ADPCM against the f16 PCM it encodes (clip(pcm · 0.02)).  The
        # test voice is 27 equal-weight harmonics up to 3.6 kHz, hard for
        # a 4-bit IMA coder: the port's plain path measures ~8.4 dB on
        # it, a signal unrelated to the f16 PCM ≤ 0 dB; the check asks
        # for 6 dB
        for blk in range(2):
            ref = np.clip(outputs["f16", blk] * 0.02, -1.0, 1.0)
            d = outputs["adpcm", blk] - ref
            snr = 10 * np.log10(np.sum(ref ** 2, 1) / np.maximum(
                np.sum(d ** 2, 1), 1e-20))
            log(f"{label} adpcm vs f16 block {blk}: SNR {snr.min():.1f}.."
                f"{snr.max():.1f} dB (min 6)")
            if not (snr > 6.0).all():
                raise RuntimeError(f"{label}: ADPCM PCM does not follow "
                                   "the f16 PCM")

        # channels 0-1 against the port's plain path on the CPU (the path
        # the CPU tests hold to the JAX package): block 0 from a fresh
        # state, block 1 from the card's carry after block 0
        ref = BatchedP25VoicePipeline(2, FS, cqpsk=cqpsk_on, pcm_fmt="f16",
                                      device="cpu", tables=cpu_tables)
        for blk, xb in enumerate(xblocks):
            if blk == 1:
                ref.set_voice_state(*keep["carry01"])
            want = ref.decode_block(xb[:2].cpu())
            got = outputs["f16", blk][:2]
            peak = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            log(f"{label} card vs CPU plain path, channels 0-1 block "
                f"{blk}: max abs err {err:.3e}, peak {peak:.3f} (tol 2e-3 "
                f"* peak)")
            if not (got.shape == want.shape and err <= 2e-3 * peak):
                raise RuntimeError(f"{label}: card and CPU paths disagree")
        return outputs, launches, keep

    launches = {}
    outputs, launches["c4fm"], keep = run_p25_path("C4FM path", blocks,
                                                   False, want_ldus)

    # K3 on the C4FM path's own PCM: what the wire encoder of the f16 run
    # would have been given (clip(pcm * 0.02)), against the sinusoids
    speech = torch.as_tensor(np.clip(outputs["f16", 0] * 0.02, -1.0, 1.0),
                             device=dev).contiguous()
    if speech.shape != sines.shape:
        raise RuntimeError(f"pipeline PCM {tuple(speech.shape)} is not "
                           f"[{S}, {T}]")
    k3_in = {"sinusoids": sines, "pipeline PCM": speech}
    k3_ms = {}
    for label in ("sinusoids", "pipeline PCM", "sinusoids"):
        k3_ms.setdefault(label, []).append(cuda_ms(
            lambda p=k3_in[label]: audio_wire.adpcm_compress(
                p, tables.adpcm_step, tables.adpcm_index), 20))
    log(f"K3 by input [{S},{T}]: three-tone sinusoids "
        f"{' / '.join(f'{v:.4f}' for v in k3_ms['sinusoids'])} ms, the "
        f"pipeline's PCM {k3_ms['pipeline PCM'][0]:.4f} ms")

    # K2 on the C4FM path's own grids (f16 block 1: its decoded frames,
    # scattered as the decoder does, and the carry block 0 left) against
    # the random grids of phase 2
    bits, errs, fch, forder = keep["k2_frames"]
    k2_steps = keep["k2_steps"]
    grids = vdev.prediction_inputs(
        bits, errs, torch.as_tensor(fch, device=dev),
        torch.as_tensor(forder, device=dev), C, k2_steps, tables)
    k2_in = {"random": k2_rand, "pipeline": (*grids, *keep["k2_carry"])}
    got = vdev.prediction_scan(*k2_in["pipeline"], *consts)
    want = vdev.prediction_scan_plain(*k2_in["pipeline"], *consts)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want))
    k2_ms = {}
    for label in ("random", "pipeline", "random"):
        k2_ms.setdefault(label, []).append(cuda_ms(
            lambda x=k2_in[label]: vdev.prediction_scan(*x, *consts), 20))
    log(f"K2 by input [{C},{k2_steps}]: the pipeline's grids max_abs_err "
        f"{err:.3e} (tol rtol 1e-5, atol 1e-5; {float(grids[-1].mean()):.3f}"
        f" of steps active); random "
        f"{' / '.join(f'{v:.4f}' for v in k2_ms['random'])} ms, the "
        f"pipeline's {k2_ms['pipeline'][0]:.4f} ms")
    del k2_in, k2_rand, got, want, keep, outputs

    pick_ldus = lambda p, fe6: p.pick_ldus(*fe6[1:5], fe6[5],
                                           dibits_dev=fe6[0])
    time_path("C4FM path", ident,
              BatchedP25VoicePipeline(C, FS, pcm_fmt="adpcm", tables=tables),
              blocks, BLOCK_S, pick_ldus)

    # CQPSK: the carrier estimate of every channel, by the function the
    # pipeline's front end calls
    for blk, xb in enumerate(q_blocks):
        est = cqpsk.estimate_cfo_qpsk(torch.view_as_complex(xb), FS,
                                      tables.symbol_rate).cpu().numpy()
        worst = float(np.abs(est - cfo).max())
        log(f"CQPSK path block {blk}: carrier estimates within "
            f"{worst:.3f} Hz of the offsets applied (tol 1 Hz; bins lie "
            f"{FS / B / 4:.3f} Hz apart)")
        if not worst <= 1.0:
            raise RuntimeError("CQPSK carrier estimate off by more than "
                               "1 Hz")
    _q_out, launches["cqpsk"], _q_keep = run_p25_path(
        "CQPSK path", q_blocks, True, q_want_ldus)
    del _q_out, _q_keep
    time_path("CQPSK path", ident,
              BatchedP25VoicePipeline(C, FS, cqpsk=True, pcm_fmt="adpcm",
                                      tables=tables),
              q_blocks, BLOCK_S, pick_ldus)

    # DMR
    def dmr_frames(pipe, n_ch):
        """Per channel: {sync position: (bits [18, 49], first step, ECC
        error counts [18])} of the superframes the pipeline accepted."""
        bits, errs, fch, forder = pipe.last_frames
        ac, at, ai = pipe.last_superframes
        bits = bits.cpu().numpy().reshape(-1, 18, 49)
        errs = errs.cpu().numpy().reshape(-1, 18)
        out = [dict() for _ in range(n_ch)]
        for s, (c, t) in enumerate(zip(ac.tolist(), at.tolist())):
            out[c][t] = (bits[s], int(forder[18 * s]), errs[s])
        return out, ac, ai, int(errs.max())

    def exact_share(frames, want, chans):
        """Share of the expected frames of ``chans`` decoded exactly."""
        n = hit = 0
        for c in chans:
            pos, wb = want[c]
            for t, w in zip(pos.tolist(), wb):
                n += 18
                if t in frames[c]:
                    hit += int((frames[c][t][0] == w).all(-1).sum())
        return hit / max(n, 1)

    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    d_out, d_frames, d_carry01 = {}, {}, None
    for fmt in ("f16", "adpcm"):
        pipe = BatchedDmrVoicePipeline(C, FS, pcm_fmt=fmt, tables=dtab)
        for blk, xb in enumerate(d_blocks):
            t1 = time.perf_counter()
            pcm = pipe.fetch_pcm(pipe.decode_block_async(xb))
            dt = time.perf_counter() - t1
            frames, ac, ai, max_err = dmr_frames(pipe, C)
            n_sf = np.bincount(ac, minlength=C)
            if n_sf.min() < 14 or ai.any():
                raise RuntimeError(
                    f"DMR path {fmt} block {blk}: channels "
                    f"{np.flatnonzero(n_sf < 14)[:8].tolist()} accepted "
                    f"fewer than 14 superframes; {int(ai.sum())} inverted")
            limit = 1.0 if fmt == "f16" else 32768.0 / 32767.0
            rms = check_pcm(f"DMR path {fmt} block {blk}", pcm, limit)
            share = exact_share(frames, d_want, range(C))
            log(f"DMR path {fmt} block {blk}: {C}/{C} channels accept "
                f"{n_sf.min()}..{n_sf.max()} superframes, none inverted; "
                f"{100 * share:.2f}% of the expected frames' 49 bits "
                f"equal the vector (max ECC errors {max_err}); PCM "
                f"{pcm.shape} finite, |pcm| <= {np.abs(pcm).max():.5f}, "
                f"rms {rms.min():.4f}..{rms.max():.4f}, {dt * 1e3:.1f} ms")
            d_out[fmt, blk] = pcm
            if fmt == "f16":
                d_frames[blk] = frames
                if blk == 0:
                    d_carry01 = tuple(tuple(t[:2].cpu() for t in part)
                                      for part in pipe._vstate)
    launches["dmr"] = check_launches("DMR path", counted, (k1fn, k3fn),
                                     (k2fn, k7fn, k4fn, k5fn))
    log(f"DMR path: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    no_reference_modules()

    # channels 0-1 against the port's plain path on the CPU.  A frame
    # whose bits differ between the two (a soft symbol on a slicer
    # threshold) changes the phase of everything after it, so the PCM is
    # compared up to the first such frame and the rest is counted
    cpu_dtab = params.load_dmr("cpu")
    ref = BatchedDmrVoicePipeline(2, FS, pcm_fmt="f16", device="cpu",
                                  tables=cpu_dtab)
    for blk, xb in enumerate(d_blocks):
        if blk == 1:
            ref._vstate = d_carry01
        want = ref.decode_block(xb[:2].cpu())
        ref_frames = dmr_frames(ref, 2)[0]
        got = d_out["f16", blk][:2]
        cpu_share = exact_share(ref_frames, d_want, range(2))
        card_share = exact_share(d_frames[blk], d_want, range(2))
        peak = float(np.abs(want).max())
        worst, skipped = 0.0, 0
        for c in range(2):
            steps = 18 * len(ref_frames[c])
            first_bad = steps
            for t in sorted(ref_frames[c]):     # stream order = step order
                b, st, e = ref_frames[c][t]
                cb, cst, ce = d_frames[blk][c].get(t, (None, None, None))
                if cst != st:           # not accepted there on the card
                    first_bad = st
                    break
                agree = (cb == b).all(-1) & (ce == e)
                if not agree.all():
                    first_bad = st + int(np.argmin(agree))
                    break
            n = min(first_bad * 160, want.shape[1], got.shape[1])
            skipped += steps - first_bad
            if n:
                worst = max(worst, float(np.abs(got[c, :n]
                                                - want[c, :n]).max()))
        log(f"DMR path card vs CPU plain path, channels 0-1 block {blk}: "
            f"max abs err {worst:.3e}, peak {peak:.3f} (tol 2e-3 * peak) "
            f"over the frames up to the first whose bits differ, "
            f"{skipped} frames not compared; exact-frame share card "
            f"{100 * card_share:.2f}%, CPU {100 * cpu_share:.2f}%")
        if not worst <= 2e-3 * peak:
            raise RuntimeError("DMR path: card and CPU paths disagree")
        if card_share < cpu_share:
            raise RuntimeError("DMR path: the card decodes fewer frames "
                               "exactly than the CPU path")

    del d_out, d_frames
    # the second DMR check: the same dibits through the serial DMR stream's
    # pulse shape (serialvec.dmr_iq: C4FM levels at +-1944 Hz, half-symbol
    # averaged) instead of the Gaussian-edged FM: every frame exact
    from dsdneo_tpu_torch.engine.serialvec import DMR_DEV_HZ

    def dmr_pulse(d, sps):
        return encode.c4fm_clean(d, sps, FS, DMR_DEV_HZ)

    pipe = BatchedDmrVoicePipeline(C, FS, pcm_fmt="f16", tables=dtab)
    for blk in range(2):
        xb = torch.as_tensor(dmr_encode.vector_block(
            dtv, d_leads, d_seeds[blk::2], d_B, modulate=dmr_pulse)).to(dev)
        pipe.fetch_pcm(pipe.decode_block_async(xb))
        frames, ac, ai, max_err = dmr_frames(pipe, C)
        share = exact_share(frames, d_want, range(C))
        n_sf = sum(len(w[0]) for w in d_want)
        if share != 1.0 or max_err or ai.any() or len(ac) != n_sf:
            raise RuntimeError(
                f"DMR path, dmr_iq pulse shape, block {blk}: "
                f"{100 * share:.3f}% of the expected frames exact, "
                f"{len(ac)} superframes accepted of {n_sf}, max ECC errors "
                f"{max_err}, {int(ai.any())} inverted")
        log(f"DMR path, the same dibits with dmr_iq's pulse shape, block "
            f"{blk}: {C}/{C} channels accept every superframe ({len(ac)}), "
            f"100% of the frames' 49 bits equal the vector's, 0 ECC errors")
    del pipe, xb
    time_path("DMR path", ident,
              BatchedDmrVoicePipeline(C, FS, pcm_fmt="adpcm", tables=dtab),
              d_blocks, d_block_s,
              lambda p, fe6: p.pick_superframes(*fe6[1:]))
    del d_blocks

    # X2, P2, NXDN48: the AMBE families on the card --------------------------
    def by_row(bits, errs, rows, steps, n_rows):
        """Per output row: {step: (bits [49], ECC errors)}."""
        bits = bits.cpu().numpy()
        errs = errs.cpu().numpy()
        out = [dict() for _ in range(n_rows)]
        for i in np.flatnonzero(np.asarray(rows) < n_rows):
            out[int(rows[i])][int(steps[i])] = (bits[i], int(errs[i]))
        return out

    def card_vs_cpu(label, blk, got, want, card, cpu):
        """The card's PCM of the first rows against the CPU path's, up to
        each row's first frame whose bits or error count differ."""
        peak = float(np.abs(want).max())
        worst, skipped = 0.0, 0
        for r in range(want.shape[0]):
            first_bad = len(cpu[r])
            for st in sorted(cpu[r]):
                b, e = cpu[r][st]
                cb = card[r].get(st)
                if cb is None or cb[1] != e or not np.array_equal(cb[0], b):
                    first_bad = st
                    break
            n = min(first_bad * 160, want.shape[1], got.shape[1])
            skipped += len(cpu[r]) - first_bad
            if n:
                worst = max(worst, float(np.abs(got[r, :n]
                                                - want[r, :n]).max()))
        log(f"{label} card vs CPU plain path, channels 0-1 block {blk}: "
            f"max abs err {worst:.3e}, peak {peak:.3f} (tol 2e-3 * peak) "
            f"over the frames up to the first whose bits differ, "
            f"{skipped} frames not compared")
        if not (peak > 0 and worst <= 2e-3 * peak):
            raise RuntimeError(f"{label}: card and CPU paths disagree")

    def run_ambe_path(label, make, xblocks, n_rows, frames, judge, runs,
                      idle, cpu_pipe, post=None):
        """Both formats over two blocks with the carry kept and the
        launch counters reset before; ``frames(pipe, n_rows)`` gives
        (bits, errs, rows, steps) of the decoded frames, ``judge(pipe,
        fmt, blk)`` checks the block's frames and returns a line,
        ``post(pcm, fmt, blk)`` (where given) takes each block's PCM
        further; then rows 0..``n_rows//C*2`` against ``cpu_pipe`` on the
        CPU."""
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        f16, card, carry = {}, {}, None
        r2 = n_rows // C * 2                  # rows of channels 0-1
        for fmt in ("f16", "adpcm"):
            pipe = make(fmt)
            for blk, xb in enumerate(xblocks):
                t1 = time.perf_counter()
                pcm = pipe.fetch_pcm(pipe.decode_block_async(xb))
                dt = time.perf_counter() - t1
                limit = 1.0 if fmt == "f16" else 32768.0 / 32767.0
                rms = check_pcm(f"{label} {fmt} block {blk}", pcm, limit)
                if post is not None:
                    post(pcm, fmt, blk)
                line = judge(pipe, fmt, blk)
                log(f"{label} {fmt} block {blk}: {line}; PCM {pcm.shape} "
                    f"finite, |pcm| <= {np.abs(pcm).max():.5f}, rms "
                    f"{rms.min():.4f}..{rms.max():.4f}, {dt * 1e3:.1f} ms")
                if fmt == "f16":
                    f16[blk] = pcm[:r2]
                    card[blk] = by_row(*frames(pipe), r2)
                    if blk == 0:
                        carry = tuple(tuple(t[:r2].cpu() for t in part)
                                      for part in pipe._vstate)
        got = check_launches(label, counted, runs, idle)
        log(f"{label}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        no_reference_modules()
        for blk, xb in enumerate(xblocks):
            if blk == 1:
                cpu_pipe._vstate = carry
            want = cpu_pipe.decode_block(xb[:2].cpu())
            card_vs_cpu(label, blk, f16[blk], want, card[blk],
                        by_row(*frames(cpu_pipe), r2))
            judge(cpu_pipe, "cpu", blk)
        return got

    # X2: every superframe each block holds whole, exact frames
    x_share = {}

    def x2_frames(pipe):
        bits, errs, fch, forder = pipe.last_frames
        return bits, errs, fch, forder

    def x2_judge(pipe, fmt, blk):
        frames, ac, ai, max_err = dmr_frames(pipe, pipe.C)
        if fmt == "cpu":
            x_share["cpu", blk] = exact_share(frames, x_want, range(2))
            if x_share["card", blk] < x_share["cpu", blk]:
                raise RuntimeError("X2 path: the card decodes fewer frames "
                                   "exactly than the CPU path")
            log(f"X2 path block {blk}: exact-frame share channels 0-1 card "
                f"{100 * x_share['card', blk]:.2f}%, CPU "
                f"{100 * x_share['cpu', blk]:.2f}%")
            return ""
        n_sf = np.bincount(ac, minlength=C)
        want_n = np.array([len(w[0]) for w in x_want])
        bad = np.flatnonzero(n_sf != want_n)
        if bad.size or ai.any():
            raise RuntimeError(
                f"X2 path {fmt} block {blk}: channels {bad[:8].tolist()} "
                f"accepted {n_sf[bad[:8]].tolist()} superframes, want "
                f"{want_n[bad[:8]].tolist()}; {int(ai.sum())} inverted")
        if fmt == "f16":
            x_share["card", blk] = exact_share(frames, x_want, range(2))
        share = exact_share(frames, x_want, range(C))
        return (f"{C}/{C} channels accept their {want_n.min()}.."
                f"{want_n.max()} superframes, none inverted; "
                f"{100 * share:.2f}% of the frames' 49 bits equal the "
                f"vector (max ECC errors {max_err})")

    launches["x2"] = run_ambe_path(
        "X2 path", lambda fmt: BatchedX2VoicePipeline(C, FS, pcm_fmt=fmt,
                                                      tables=xtab),
        x_blocks, C, x2_frames, x2_judge, (k1fn, k3fn),
        (k2fn, k7fn, k4fn, k5fn),
        BatchedX2VoicePipeline(2, FS, device="cpu",
                               tables=params.load_tdma("x2tdma", "cpu")))
    time_path("X2 path", ident,
              BatchedX2VoicePipeline(C, FS, pcm_fmt="adpcm", tables=xtab),
              x_blocks, x_B / FS,
              lambda p, fe6: p.pick_superframes(*fe6[1:]))
    del x_blocks

    # P2: every (channel, slot) stream, the vector's bits on every frame
    def p2_frames(pipe):
        bits, errs, arrs, _jobs = pipe.last_frames
        return bits, errs, arrs[4], arrs[5]

    def p2_exact(pipe, vec_bits, min_frames, skip=0):
        """Per output row: frames decoded and whether every frame from
        ``skip`` on equals the vector's bits."""
        bits, _errs, rows, steps = p2_frames(pipe)
        bits = bits.cpu().numpy()
        counts, exact = [], []
        for r in range(2 * pipe.C):
            sel = np.flatnonzero(rows == r)
            sel = sel[np.argsort(steps[sel])]
            got = bits[sel]
            counts.append(len(sel))
            exact.append(len(sel) >= min_frames and np.array_equal(
                got[skip:], vec_bits[r % 2][skip:len(sel)]))
        return np.array(counts), np.array(exact)

    def p2_judge(pipe, fmt, blk):
        counts, exact = p2_exact(pipe, ptv["bits49"], 7 * 18)
        if not exact.all():
            bad = np.flatnonzero(~exact)
            raise RuntimeError(
                f"P2 path {fmt} block {blk}: streams {bad[:8].tolist()} "
                f"decoded {counts[bad[:8]].tolist()} frames (want >= "
                f"{7 * 18}, all equal to the vector's)")
        return (f"{len(counts)}/{len(counts)} slot streams decode "
                f"{counts.min()}..{counts.max()} frames, every one equal "
                f"to the vector's 49 bits")

    launches["p2"] = run_ambe_path(
        "P2 path", lambda fmt: BatchedP2VoicePipeline(C, FS, pcm_fmt=fmt,
                                                      tables=ptab),
        p_blocks, 2 * C, p2_frames, p2_judge, (k1fn, k3fn),
        (k2fn, k7fn, k4fn, k5fn),
        BatchedP2VoicePipeline(2, FS, device="cpu",
                               tables=params.load_tdma("p25p2", "cpu")))
    time_path("P2 path", ident,
              BatchedP2VoicePipeline(C, FS, pcm_fmt="adpcm", tables=ptab),
              p_blocks, p_B / FS, lambda p, fe6: p.walk_frames(*fe6[1:]))
    del p_blocks

    # NXDN48: at least 35 of 36 frames per channel, exact frames
    n_share = {}

    def nx_frames(pipe):
        bits, errs, fch, forder, _acc = pipe.last_frames
        return bits, errs, fch, forder

    def nx_exact(pipe, chans):
        """(frames accepted per channel, exact share over the 36 frames
        of ``chans``): a frame counts as exact when it sits at its
        vector position and its 4 AMBE frames equal the vector's."""
        bits, _errs, fch, forder, (ac, at, ai) = pipe.last_frames
        bits = bits.cpu().numpy().reshape(-1, 4, 49)
        want = ntv["bits49"].reshape(-1, 4, 49)
        hit = 0
        for f, (c, t) in enumerate(zip(ac.tolist(), at.tolist())):
            k, rem = divmod(t - int(n_leads[c]), 192)
            if c in chans and rem == 0 and 0 <= k < len(want) \
                    and not ai[f]:
                hit += int(np.array_equal(bits[f], want[k]))
        return np.bincount(ac, minlength=pipe.C), hit / (36 * len(chans))

    def nx_judge(pipe, fmt, blk):
        n_fr, share01 = nx_exact(pipe, (0, 1))
        if fmt == "cpu":
            n_share["cpu", blk] = share01
            log(f"NXDN48 path block {blk}: exact-frame share channels 0-1 "
                f"card {100 * n_share['card', blk]:.2f}%, CPU "
                f"{100 * share01:.2f}%")
            if n_share["card", blk] < share01:
                raise RuntimeError("NXDN48 path: the card decodes fewer "
                                   "frames exactly than the CPU path")
            return ""
        if n_fr.min() < 35:
            raise RuntimeError(
                f"NXDN48 path {fmt} block {blk}: channels "
                f"{np.flatnonzero(n_fr < 35)[:8].tolist()} accepted fewer "
                "than 35 of 36 frames")
        if fmt == "f16":
            n_share["card", blk] = share01
        _n, share = nx_exact(pipe, range(C))
        return (f"{C}/{C} channels accept {n_fr.min()}..{n_fr.max()} of 36 "
                f"frames; {100 * share:.2f}% of the frames equal the "
                f"vector's bits")

    launches["nxdn48"] = run_ambe_path(
        "NXDN48 path", lambda fmt: BatchedNxdnVoicePipeline(
            C, FS, pcm_fmt=fmt, mode="nxdn48", tables=ntab),
        n_blocks, C, nx_frames, nx_judge, (k1fn, k3fn),
        (k2fn, k7fn, k4fn, k5fn),
        BatchedNxdnVoicePipeline(2, FS, mode="nxdn48", device="cpu",
                                 tables=params.load_tdma("nxdn48", "cpu")))
    time_path("NXDN48 path", ident,
              BatchedNxdnVoicePipeline(C, FS, pcm_fmt="adpcm",
                                       mode="nxdn48", tables=ntab),
              n_blocks, BLOCK_S, lambda p, fe6: p.pick_frames(*fe6[1:]))
    del n_blocks

    # -- 4. ADP: the encrypted P2 stream with its key, at C channels ------
    mark("4")
    n_sf, _seed, _alg, kid, key, _mi = (int(v) for v in adp["params"])
    keys = KeyRing()
    keys.scalar[kid] = key
    a_words = []

    def adp_judge(pipe, fmt, blk):
        """Every slot stream exact from the second superframe on; the
        first block's first superframe still cipher."""
        counts, exact = p2_exact(pipe, adp["bits49"], (n_sf - 1) * 18,
                                 skip=18)
        if not exact.all():
            bad = np.flatnonzero(~exact)
            raise RuntimeError(
                f"ADP phase {fmt} block {blk}: slot streams "
                f"{bad[:8].tolist()} decoded {counts[bad[:8]].tolist()} "
                f"frames (want >= {(n_sf - 1) * 18}, every one from the "
                "second superframe on equal to the plaintext bits)")
        bits, _e, arrs, _jobs = pipe.last_frames
        bits = bits.cpu().numpy()
        if blk == 0:
            for r in range(2 * pipe.C):
                sel = np.flatnonzero(arrs[4] == r)
                sel = sel[np.argsort(arrs[5][sel])][:18]
                if not (bits[sel] != adp["bits49"][r % 2][:18]).any():
                    raise RuntimeError(
                        f"ADP phase {fmt} block 0: slot stream {r} "
                        "decrypted its first superframe, whose ESS comes "
                        "after it")
        ess = pipe.last_ess
        if fmt != "cpu":
            a_words.append(ess["rs_words"])
        return (f"{len(counts)}/{len(counts)} slot streams decode "
                f"{counts.min()}..{counts.max()} frames, every frame from "
                f"the second superframe on equal to the plaintext bits"
                + ("; the first superframe still cipher" if blk == 0
                   else "")
                + f"; ESS: {ess['jobs']} jobs, {ess['rs_words']} RS words "
                f"screened by K7, {ess['host_rs_decodes']} host RS(63,35) "
                f"decodes, {ess['rc4_keystreams']} RC4 keystreams")

    launches["adp"] = run_ambe_path(
        "ADP phase", lambda fmt: BatchedP2VoicePipeline(
            C, FS, keyring=keys, pcm_fmt=fmt, tables=ptab),
        a_blocks, 2 * C, p2_frames, adp_judge, (k1fn, k3fn, k7fn),
        (k2fn, k4fn, k5fn),
        BatchedP2VoicePipeline(2, FS, keyring=keys, device="cpu",
                               tables=params.load_tdma("p25p2", "cpu")))
    if launches["adp"]["rs_syndromes_batch"] != len(a_words):
        raise RuntimeError(
            f"ADP phase: K7 launched {launches['adp']['rs_syndromes_batch']}"
            f" times in {len(a_words)} blocks, want one a block")

    def ess_part(pipe):
        """The decode's ESS path, as the pipeline timed and counted it."""
        e = pipe.last_ess
        return e["seconds"], (
            f"{e['jobs']} ESS jobs, {e['rs_words']} RS words screened by "
            f"K7, {e['host_rs_decodes']} host RS(63,35) decodes, "
            f"{e['rc4_keystreams']} RC4 keystreams")

    time_path("ADP phase", ident,
              BatchedP2VoicePipeline(C, FS, keyring=keys, pcm_fmt="adpcm",
                                     tables=ptab),
              a_blocks, a_B / FS, lambda p, fe6: p.walk_frames(*fe6[1:]),
              part=("ESS path (host + K7)", ess_part))
    del a_blocks
    no_reference_modules()

    # -- K7 at the ADP path's word count and at 5,120 and 20,480 words ------
    # syndromes of words half of which are clean RS(63,35) codewords (data
    # combined over GF(64) from the code's 35 unit codewords), the other
    # half with 1-14 symbols changed
    code = rs_63_35()
    gexp, glog = gf64_tables()
    basis = np.stack([code.encode(np.eye(35, dtype=np.int64)[i])
                      for i in range(35)])

    def rs_words(n):
        data = rng.integers(0, 64, size=(n, 35))
        w = np.zeros((n, 63), np.int64)
        for i in range(35):
            m = (data[:, i:i + 1] != 0) & (basis[i] != 0)
            w ^= np.where(m, gexp[(glog[data[:, i:i + 1]]
                                   + glog[basis[i]]) % 63], 0)
        bad = np.arange(n) >= n // 2
        for r in np.flatnonzero(bad):
            pos = rng.choice(63, int(rng.integers(1, 15)), replace=False)
            w[r, pos] ^= rng.integers(1, 64, size=pos.size)
        return torch.as_tensor(w.astype(np.int32), device=dev), bad

    # the library yardstick (never called by the port): syndromes are
    # GF(2)-linear in a word's 6n bits, so they are the 6 * nroots bits of
    # bits @ H mod 2, H [6n, 6 nroots] with row 6j + b, column 6i + o bit o
    # of 2^b * beta_i^(n-1-j); one f32 matmul, exact (sums <= 378), TF32
    # off (set in phase 1)
    six = torch.arange(6, device=dev)
    jj, bb, ii, oo = np.ix_(np.arange(63), np.arange(6), np.arange(28),
                            np.arange(6))
    h_mat = torch.as_tensor(((gexp[(glog[1 << bb] + (1 + ii) * (62 - jj))
                                   % 63] >> oo) & 1).reshape(378, 168)
                            .astype(np.float32), device=dev)

    def bit_planes(words):
        return ((words[..., None] >> six) & 1).reshape(
            words.shape[0], -1).float()

    def k7_library(bits):
        s = torch.matmul(bits, h_mat).remainder_(2).to(torch.int32)
        return (s.view(-1, 28, 6) << six).sum(-1, dtype=torch.int32)

    exp_d, log_d = (torch.as_tensor(t, device=dev) for t in gf64_tables())

    mma_tab = torch.as_tensor(k7_mma_table(63, 28, 1), device=dev)

    def k7_v1(words, out):
        kernels.check(alt["rs_syndromes_v1"].dsd_rs_syndromes(
            words.data_ptr(), exp_d.data_ptr(), log_d.data_ptr(),
            out.data_ptr(), words.shape[0], 63, 28, 1,
            kernels.stream_handle(words)), "rs_syndromes_v1")

    def k7_v2(words, out):
        kernels.check(alt["rs_syndromes_v2"].dsd_rs_syndromes(
            words.data_ptr(), exp_d.data_ptr(), out.data_ptr(),
            words.shape[0], 63, 28, 1, kernels.stream_handle(words)),
            "rs_syndromes_v2")

    def k7_mma(words, out):
        kernels.check(alt["rs_syndromes_mma"].dsd_rs_syndromes_mma(
            words.data_ptr(), mma_tab.data_ptr(), out.data_ptr(),
            words.shape[0], 63, 28, kernels.stream_handle(words)),
            "rs_syndromes_mma")

    def wall_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3 / reps

    def check_k7(n, shape=None, key=None):
        words, bad = rs_words(n)
        host = words.cpu().numpy()
        got = fdev.rs_syndromes_batch(words, 28, 1)
        want = fdev.rs_syndromes_plain(words, 28, 1)
        v1_out, v2_out, mma_out = (torch.empty_like(want) for _ in range(3))
        k7_v1(words, v1_out)
        k7_v2(words, v2_out)
        k7_mma(words, mma_out)
        lib = k7_library(bit_planes(words))
        from_host = fdev.rs_syndromes_batch(host, 28, 1, device=dev)
        diffs = {k: int((v != want).sum()) for k, v in (
            ("kernel", got), ("first design", v1_out),
            ("bit-sliced design", v2_out), ("int8 mma design", mma_out),
            ("library", lib), ("host words", from_host))}
        nz = (got != 0).any(1).cpu().numpy()
        bits = bit_planes(words)
        t = {"ms": cuda_ms(lambda: fdev.rs_syndromes_launch(words, 28, 1),
                           50),
             "v1_ms": cuda_ms(lambda: k7_v1(words, v1_out), 50),
             "v2_ms": cuda_ms(lambda: k7_v2(words, v2_out), 50),
             "mma_ms": cuda_ms(lambda: k7_mma(words, mma_out), 50),
             "empty_launch_ms": cuda_ms(lambda: torch.cuda._sleep(0), 50),
             "library_ms": cuda_ms(lambda: torch.matmul(bits, h_mat), 50),
             "library_with_expansion_ms": cuda_ms(
                 lambda: k7_library(bit_planes(words)), 20),
             # the ESS path's call, the syndromes copied back, on the host
             # clock: host words (the card is not read before the launch)
             # and the earlier form, the words uploaded first and their
             # range read on the card
             "entry_host_words_wall_ms": wall_ms(
                 lambda: fdev.rs_syndromes_batch(
                     host, 28, 1, device=dev).cpu(), 20),
             "entry_cuda_tensor_wall_ms": wall_ms(
                 lambda: fdev.rs_syndromes_batch(torch.as_tensor(
                     host, device=dev), 28, 1).cpu(), 20)}
        plain_ms = cuda_ms(lambda: fdev.rs_syndromes_plain(words, 28, 1), 5)
        target = K7_TARGET[key or n]
        log(f"K7 rs_syndromes [{n},63] -> [{n},28]: syndromes that differ "
            f"from the plain version (tol 0: bit-identical): {diffs}; clean "
            f"words screened clean {int((~nz[~bad]).sum())}/"
            f"{int((~bad).sum())}, changed words flagged "
            f"{int(nz[bad].sum())}/{int(bad.sum())}")
        if any(diffs.values()) or nz[~bad].any() or not nz[bad].all():
            raise RuntimeError("K7, one of its other designs or the "
                               "yardstick disagrees with the plain version "
                               "or the code")
        b_ms, b_by = bound(nbytes(words, got), 0)
        log(f"  K7 [{n},63]: kernel {t['ms']:.4f} ms, first design {t['v1_ms']:.4f} (recorded "
            f"{K7_BEFORE_MS.get(n, '-')}), bit-sliced design "
            f"{t['v2_ms']:.4f}, int8 mma design {t['mma_ms']:.4f}, empty "
            f"launch "
            f"{t['empty_launch_ms']:.4f} (kernel - empty "
            f"{(t['ms'] - t['empty_launch_ms']) * 1e3:.2f} us), library "
            f"matmul {t['library_ms']:.4f} (with the bit expansion and "
            f"repack {t['library_with_expansion_ms']:.4f}), entry point "
            f"{t['entry_host_words_wall_ms']:.4f} host words / "
            f"{t['entry_cuda_tensor_wall_ms']:.4f} uploaded first (wall, "
            f"the syndromes copied back); "
            f"faster than the first design: {t['ms'] < t['v1_ms']}, the "
            f"bit-sliced: {t['ms'] < t['v2_ms']}, the int8 mma: "
            f"{t['ms'] < t['mma_ms']}; not slower than the matmul: "
            f"{t['ms'] <= t['library_ms']}")
        k_ms = t.pop("ms")
        over = k_ms - (t["empty_launch_ms"] if target[0] == "above_empty"
                       else 0.0)
        log(f"  K7 [{n},63] target: at most {target[1]} ms "
            f"{'above an empty launch' if target[0] == 'above_empty' else 'in all'}"
            f", measured {over:.4f}: met {over <= target[1]}")
        show("rs_syndromes", 0.0, k_ms, plain_ms, b_ms, b_by, shape=shape)
        row = (report["rs_syndromes"] if shape is None
               else report["rs_syndromes"]["other_shapes"][-1])
        row.update(t, words=n, target={target[0]: target[1]},
                   target_met=bool(over <= target[1]))

    check_k7(a_words[0], key="path")
    for n in K7_SHAPES_N:
        check_k7(n, shape=[n, 63])
    for so, stem in ((info["path"], "rs_syndromes_kernel"),
                     *((os.path.join(kernels.BUILD_DIR, f"{name}.so"), stem)
                       for name, stem in (
                           ("rs_syndromes_v1", "rs_syndromes_kernel"),
                           ("rs_syndromes_v2", "rs_syndromes_kernel"),
                           ("rs_syndromes_mma", "rs_syndromes_mma_kernel")))):
        for line in (sass_loops(cuobjdump, so, stem, whole=True)
                     if os.path.isfile(cuobjdump) else ["no cuobjdump"]):
            log(f"SASS {os.path.basename(so)} {stem}: {line}")

    # -- 5. the control-channel monitors at C=320 ------------------------
    mark("5")
    from dsdneo_tpu_torch.engine import ccbatch
    from dsdneo_tpu_torch.fec import conv, trellis

    def mon_last(pipe):
        return (pipe.last_tsdus if isinstance(
            pipe, ccbatch.BatchedP25ControlPipeline) else pipe.last_csbks
            if isinstance(pipe, ccbatch.BatchedDmrControlPipeline)
            else pipe.last_cacs)

    def blob_rows(kind, last, c):
        """(position, payload bytes, ok flag) of channel c's accepted
        blocks in a monitor's last blob, per vector block."""
        ac, at, blob = last
        rows = []
        for h in np.flatnonzero(ac == c):
            if kind == "p25":
                for b in range(3):
                    rows.append((int(at[h]), b, blob[h, b, :12],
                                 int(blob[h, b, 12])))
            else:
                k = 12 if kind == "dmr" else 22
                rows.append((int(at[h]), 0, blob[h, :k], int(blob[h, k])))
        return rows

    def judge_monitor(label, kind, pipe, blk, n0s):
        """Every block of the vector that channel c's block holds whole is
        accepted and parsed, its payload bytes equal the vector's, and its
        event lines equal the lines the JAX catalog gave the vector;
        nothing else is accepted.  DMR only: a burst may fail its BPTC +
        CRC screen (``dmr_fm_iq`` swings ~3x DMR's deviation, and the
        12.5 kHz channel filter turns ~1.4% of the outer symbols inner
        with no noise at all); it then emits the burst head or a CRC
        error line and nothing else, and at most ``DMR_MAX_FAIL`` of the
        bursts may fail.  Returns (blocks checked, blocks failed)."""
        ct, mtv, m_leads, _blocks, n_sym = mon[kind]
        want = [[] for _ in range(len(mtv["payloads"]))]
        for line, k in zip(mtv["lines"], mtv["line_block"]):
            want[int(k)].append(str(line))
        last = mon_last(pipe)
        n_checked = n_failed = 0
        for c in range(pipe.C):
            exp = cc_expected(kind, ct, mtv, int(m_leads[c]), n_sym)
            got = cc_groups(kind, pipe.ctxs[c].events[n0s[c]:])
            rows = blob_rows(kind, last, c)
            acc = sorted({r[0] for r in rows})
            if acc != sorted(exp):
                raise RuntimeError(
                    f"{label} block {blk} channel {c}: accepted "
                    f"{sorted(set(acc) ^ set(exp))[:6]} differently from "
                    "the vector's blocks held whole")
            failed = set()
            for t, b, pay, ok in rows:
                idx, _all = exp[t]
                k = idx[0] + b if kind == "p25" else idx[0]
                if kind == "dmr" and not ok:
                    failed.add(t)
                elif k in idx and not (ok and np.array_equal(
                        pay, mtv["payloads"][k])):
                    raise RuntimeError(
                        f"{label} block {blk} channel {c}: block {k} at "
                        f"{t} decoded to other payload bytes (ok {ok})")
            for t, (idx, all_whole) in exp.items():
                lines = [ln for k in idx for ln in want[k]]
                g = got.get(t, [])
                n_checked += len(idx)
                if t in failed:
                    n_failed += 1
                    if len(g) > 1 or (g and " | CSBK" not in g[0]):
                        raise RuntimeError(
                            f"{label} block {blk} channel {c}: a failed "
                            f"burst at {t} emitted {g}")
                    continue
                if (g != lines) if all_whole else (g[:len(lines)] != lines):
                    raise RuntimeError(
                        f"{label} block {blk} channel {c}: the events at "
                        f"{t} differ from the JAX catalog's lines for "
                        f"blocks {idx}: {g[:2]} / {lines[:2]}")
        return n_checked, n_failed

    def time_monitor(label, pipe, xblocks, pipelined, stage,
                     unit="blocks parsed", block_s=BLOCK_S):
        """The JAX bench's loop (``pipelined``: dispatch block N+1's front
        end before finishing block N, ``bench.py:334``; else the plain
        per-block loop, ``bench.py:375-389``) over ``N_TIMED`` blocks of
        ``block_s`` seconds, the stage split of one block and a profile
        of two.  ``stage(pipe, fe)`` runs the pick and the device decode
        + blob fetch alone, returning their seconds, or a dict of the
        seconds of named stages that the parse does not include."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        pipe.decode_block_events(xblocks[0])                   # warm
        torch.cuda.synchronize()
        n_tot = 0
        t1 = time.perf_counter()
        if pipelined:
            fe = pipe.frontend_dispatch(xblocks[0])
            for i in range(N_TIMED):
                fe_next = pipe.frontend_dispatch(xblocks[(i + 1) % 2])
                for ctx in pipe.ctxs:
                    ctx.events.clear()
                n_tot += pipe.events_from_frontend(pipe.frontend_finish(fe))
                fe = fe_next
        else:
            for i in range(N_TIMED):
                for ctx in pipe.ctxs:
                    ctx.events.clear()
                n_tot += pipe.decode_block_events(xblocks[i % 2])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / N_TIMED
        per_block = n_tot / N_TIMED
        log(f"{label} {'pipelined' if pipelined else 'per-block'} step "
            f"({ident}): {step_s * 1e3:.1f} ms per {block_s:.4g} s block of "
            f"{C} channels = {C * block_s / step_s:.1f}x realtime; "
            f"{per_block:.0f} {unit} per step = "
            f"{per_block / step_s:.0f} per second")
        stages = {}
        for ctx in pipe.ctxs:
            ctx.events.clear()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fe = pipe.frontend_dispatch(xblocks[1])
        torch.cuda.synchronize()
        stages["front end + sync"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        feh = pipe.frontend_finish(fe)
        stages["candidates to host"] = time.perf_counter() - t1
        split = stage(pipe, feh)
        if not isinstance(split, dict):
            split = {"pick (host)": split[0],
                     "device decode + blob": split[1]}
        stages.update(split)
        t1 = time.perf_counter()
        pipe.events_from_frontend(feh)
        whole = time.perf_counter() - t1
        stages["host parse"] = whole - sum(split.values())
        log(f"{label} stages (ms): " + ", ".join(
            f"{k} {v * 1e3:.1f}" for k, v in stages.items())
            + f" (host parse: the pick, decode and parse together less "
              f"{', '.join(split)} alone)")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(2):
                for ctx in pipe.ctxs:
                    ctx.events.clear()
                pipe.decode_block_events(xblocks[i])
            torch.cuda.synchronize()
        dev_us, dev_n = {}, {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and \
                    e.self_device_time_total > 0:
                key = next((k for k in OURS if f"{k}_kernel" in e.key),
                           e.key)
                dev_us[key] = dev_us.get(key, 0.0) + e.self_device_time_total
                dev_n[key] = dev_n.get(key, 0) + e.count
        busy_ms = sum(dev_us.values()) / 2e3
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
        log(f"{label} profile, 2 blocks: device busy {busy_ms:.2f} ms per "
            f"block = {100 * busy_ms / (step_s * 1e3):.1f}% of the "
            f"unprofiled step; per block: " + ", ".join(
                f"{k[:40]} {v / 2e3:.3f} ms" for k, v in top)
            + "; the port's kernels: " + ", ".join(
                f"{k} {dev_n[k]} launches, {dev_us[k] / dev_n[k] / 1e3:.4f} "
                "ms per launch" for k in OURS if dev_n.get(k)))
        return step_s

    def run_monitor(label, kind, make, runs, cpu_pipe):
        """Two blocks with the contexts kept, launch counters reset
        before; each block judged on every channel; channels 0-1 against
        ``cpu_pipe`` on the CPU (blobs and events)."""
        _ct, _mtv, _leads, xblocks, _n = mon[kind]
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pipe = make()
        blobs = []
        for blk, xb in enumerate(xblocks):
            n0s = [len(ctx.events) for ctx in pipe.ctxs]
            t1 = time.perf_counter()
            n = pipe.decode_block_events(xb)
            dt = time.perf_counter() - t1
            n_checked, n_failed = judge_monitor(label, kind, pipe, blk, n0s)
            blobs.append(mon_last(pipe))
            log(f"{label} block {blk}: {n} blocks parsed over {C} channels; "
                f"of the {n_checked} the block holds whole, "
                f"{n_checked - n_failed} parsed with the vector's payload "
                f"bytes and the JAX catalog's lines, {n_failed} failed the "
                f"screen (max {DMR_MAX_FAIL:.1%} on DMR, 0 elsewhere); "
                f"{dt * 1e3:.1f} ms")
            if n_failed > (DMR_MAX_FAIL * n_checked if kind == "dmr" else 0):
                raise RuntimeError(f"{label} block {blk}: {n_failed} of "
                                   f"{n_checked} blocks failed the screen")
        got = check_launches(label, counted, runs,
                             tuple(f for f in counted if f not in runs))
        log(f"{label}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        no_reference_modules()
        for blk, xb in enumerate(xblocks):
            cpu_pipe.decode_block_events(xb[:2].cpu())
            (ac, at, blob), (cac, cat, cblob) = blobs[blk], mon_last(cpu_pipe)
            sel = ac < 2
            if not (np.array_equal(ac[sel], cac) and np.array_equal(
                    at[sel], cat) and np.array_equal(blob[sel], cblob)):
                raise RuntimeError(f"{label} block {blk}: the card's blobs "
                                   "of channels 0-1 differ from the CPU "
                                   "path's")
        for c in range(2):
            a = [(e.line, e.pos) for e in pipe.ctxs[c].events]
            b = [(e.line, e.pos) for e in cpu_pipe.ctxs[c].events]
            if a != b:
                raise RuntimeError(f"{label}: channel {c}'s events differ "
                                   "from the CPU path's")
        log(f"{label} card vs CPU plain path, channels 0-1, both blocks: "
            f"blobs byte for byte and events ({len(a)} on channel 1) equal")
        return pipe, got

    def p25_stage(pipe, feh):
        t1 = time.perf_counter()
        ac, at, _am = pipe.pick_tsdus(*feh[1:5], feh[5], dibits_dev=feh[0])
        t_pick = time.perf_counter() - t1
        t1 = time.perf_counter()
        Hp = -(-len(ac) // 64) * 64
        ccbatch.p25_tsdu_decode_device(
            feh[0], ccbatch._padded(ac, Hp, C, dev),
            ccbatch._padded(at, Hp, 0, dev), pipe.cc).cpu()
        return t_pick, time.perf_counter() - t1

    def dmr_stage(pipe, feh):
        t1 = time.perf_counter()
        ac, at, ai, _cc = pipe.pick_csbks(*feh[1:])
        t_pick = time.perf_counter() - t1
        t1 = time.perf_counter()
        Hp = -(-len(ac) // 64) * 64
        ccbatch.dmr_csbk_decode_device(
            feh[0], ccbatch._padded(ac, Hp, C, dev),
            ccbatch._padded(at, Hp, 0, dev),
            ccbatch._padded(ai, Hp, 0, dev), pipe.cc).cpu()
        return t_pick, time.perf_counter() - t1

    def nxdn_stage(pipe, feh):
        t1 = time.perf_counter()
        ac, at, _al = pipe.pick_cacs(*feh[1:])
        t_pick = time.perf_counter() - t1
        t1 = time.perf_counter()
        Hp = -(-len(ac) // 32) * 32
        ccbatch.nxdn_cac_decode_device(
            feh[0], ccbatch._padded(ac, Hp, C, dev),
            ccbatch._padded(at, Hp, 0, dev), pipe.cc).cpu()
        return t_pick, time.perf_counter() - t1

    def k4_words(n):
        """``n`` encoded TSBK trellis words of random data (the encoder
        of fec/trellis.py, vectorized), ~0-8 bits flipped each, and int32
        LLRs of random magnitude 1-127 on them; and the data."""
        data = rng.integers(0, 2, (n, 96)).astype(np.uint8)
        st = np.concatenate([(data[:, 0::2] << 1) | data[:, 1::2],
                             np.zeros((n, 1), np.uint8)], axis=1)
        prev = np.concatenate([np.zeros((n, 1), np.uint8), st[:, :-1]], 1)
        nib = trellis.P25_DTM[(prev.astype(np.int64) << 2) | st]
        dei = np.stack([(nib >> 2) & 3, nib & 3], -1).reshape(n, 98)
        tx = dei[:, trellis.interleave_98()]
        bits = np.stack([(tx >> 1) & 1, tx & 1], -1).reshape(n, 196)
        bits = bits.astype(np.uint8)
        for i in range(4):
            if not np.array_equal(bits[i], trellis.p25_12_encode(data[i])):
                raise RuntimeError("the vectorized trellis encoder differs")
        rate = rng.integers(0, 9, (n, 1)) / 196.0
        bits ^= (rng.random((n, 196)) < rate).astype(np.uint8)
        llr = ((1 - 2 * bits.astype(np.int32))
               * rng.integers(1, 128, (n, 196))).astype(np.int32)
        return data, bits, llr

    def before(table, n, k_ms):
        """The first design's recorded time at this word count, if any."""
        if n not in table:
            return ""
        return (f"; the first design (one thread per word reading in "
                f"place) recorded {table[n]:.4f} ms here, now "
                f"{table[n] / k_ms:.2f}x faster")

    def time_k4_lanes(bt, lv, x):
        """K4's four-lanes design on the kernel's own input form, held to
        the kernel bit for bit, then timed."""
        want = fdev.p25_12_decode_batch(bt, lv)
        bits, cost = torch.empty_like(want[0]), torch.empty_like(want[1])

        def run():
            kernels.check(lanes.dsd_p25_trellis_lanes(
                x.data_ptr(), int(lv is None), bits.data_ptr(),
                cost.data_ptr(), x.shape[0], kernels.stream_handle(x)),
                "p25_trellis_lanes")
        run()
        if not (torch.equal(bits, want[0]) and torch.equal(cost, want[1])):
            raise RuntimeError("K4's four-lanes design disagrees with K4")
        return cuda_ms(run, 20)

    def time_k5_lanes(st_, w, stride, want):
        """K5's 16- and 4-lanes designs on the kernel's input form (``w``
        one row at ``stride`` 0, else [N, 2n]), each held to the kernel's
        bits ``want`` bit for bit, then timed: {lanes: ms}."""
        out = torch.empty_like(want)
        times = {}
        for L in (16, 4):
            def run():
                kernels.check(lanes.dsd_conv_k5_lanes(
                    L, st_.data_ptr(), w.data_ptr(), stride, out.data_ptr(),
                    st_.shape[0], st_.shape[1] // 2,
                    kernels.stream_handle(st_)), "conv_k5_lanes")
            run()
            if not torch.equal(out, want):
                raise RuntimeError(f"K5's {L}-lanes design disagrees with "
                                   f"K5")
            times[L] = cuda_ms(run, 20)
        return times

    def k45_row(name, main):
        return report[name] if main else report[name]["other_shapes"][-1]

    def check_k4(n, launches_path, main):
        """K4 against its plain version on hard bits and on LLRs, timed
        in both forms: bits (the P25 monitor's, the kernel forming the
        ±64 LLRs) and int32 LLRs (the first design's timed form)."""
        data, bits, llr = k4_words(n)
        bt = torch.as_tensor(bits, device=dev)
        lt = torch.as_tensor(llr, device=dev)
        n_exact = 0
        for lv in (None, lt):
            gb, gc = fdev.p25_12_decode_batch(bt, lv)
            wb, wc = fdev.p25_12_decode_plain(bt, lv)
            if not (torch.equal(gb, wb) and torch.equal(gc, wc)):
                raise RuntimeError("K4 disagrees with its plain version")
            n_exact = int((gb.cpu().numpy() == data).all(1).sum())
        floor_ms = 49 * K4_CHAIN_CYCLES / (clk * 1e3)
        log(f"K4 p25_trellis [{n},196] -> [{n},96] + [{n}]: bits and costs "
            f"equal the plain version's on hard bits and on LLRs (tol 0); "
            f"{n_exact}/{n} words with 0-8 flipped bits decode to their data")
        for form, lv, x in (("uint8 bits", None, bt), ("int32 LLRs", lt, lt)):
            lanes_ms = time_k4_lanes(bt, lv, x)
            k_ms = cuda_ms(lambda: fdev.p25_12_decode_batch(bt, lv), 20)
            plain_ms = cuda_ms(lambda: fdev.p25_12_decode_plain(bt, lv), 2)
            b_ms, b_by = bound(nbytes(x, gb, gc), 0)
            first = main and form == "uint8 bits"
            show("p25_trellis", 0.0, k_ms, plain_ms, b_ms, b_by,
                 f"; [{n},196] {form}; chain floor ~{floor_ms:.5f} ms (49 "
                 f"steps x {K4_CHAIN_CYCLES} cycles at {clk:.0f} MHz), "
                 f"{100 * floor_ms / k_ms:.2f}% of it; launches per path "
                 f"run {launches_path}"
                 + (before(K4_BEFORE_MS, n, k_ms) if lv is not None else ""),
                 shape=None if first else [n, 196], form=form)
            row = k45_row("p25_trellis", first)
            row["chain_floor_ms"] = floor_ms
            row["lanes4_ms"] = lanes_ms
            log(f"    four lanes a word (csrc/alt/viterbi_lanes.cu, not "
                f"shipped) {lanes_ms:.4f} ms: the kernel is "
                f"{lanes_ms / k_ms:.2f}x faster")

    def k5_words(n, soft=False):
        """``n`` CAC-like K5 inputs: random 171 bits with the 4 flush bits
        encoded (fec/conv.py's tables, vectorized over the words), ~0-6
        symbols flipped, the CAC's puncture weights; ``soft``: symbols
        with noise in [0, 1] and random weights."""
        bits = np.concatenate([rng.integers(0, 2, (n, 171)),
                               np.zeros((n, 4), np.int64)], axis=1)
        sym = conv.encode_rows(bits)
        rate = rng.integers(0, 7, (n, 1)) / 350.0
        flip = rng.random((n, 350)) < rate
        sym[flip] = 1.0 - sym[flip]
        wt = np.broadcast_to(mon["nxdn48"][0].np["cac_wt"], (n, 350))
        wt = wt.astype(np.float32).copy()
        if soft:
            sym = np.clip(sym + rng.normal(0, 0.3, sym.shape), 0, 1)
            wt = wt * rng.random(wt.shape)
        return (bits[:, :171].astype(np.uint8), sym.astype(np.float32),
                wt.astype(np.float32))

    def time_k5(n, steps, st_, row, launches_path, main, label):
        """K5 timed in both weight forms: one row as a stride-0 view (the
        paths' form; the kernel stages it once a block) and written out
        row by row (the first design's timed form)."""
        floor_ms = steps * K5_CHAIN_CYCLES / (clk * 1e3)
        view = row.expand(n, -1)
        full = view.contiguous()
        got = fdev.conv_k5_decode_batch(st_, view)
        for form, wt_, w_in in (("broadcast weight row", view, row),
                                ("materialised weights", full, full)):
            lanes_ms = time_k5_lanes(st_, w_in, 0 if wt_ is view
                                     else 2 * steps, got)
            k_ms = cuda_ms(lambda: fdev.conv_k5_decode_batch(st_, wt_), 20)
            plain_ms = cuda_ms(lambda: fdev.conv_k5_decode_plain(st_, wt_),
                               1)
            b_ms, b_by = bound(nbytes(st_, w_in, got), 0)
            first = main and wt_ is view
            show("conv_k5", 0.0, k_ms, plain_ms, b_ms, b_by,
                 f"; {label} [{n},{2 * steps}] {form}; chain floor "
                 f"~{floor_ms:.5f} ms ({steps} steps x {K5_CHAIN_CYCLES} "
                 f"cycles at {clk:.0f} MHz), {100 * floor_ms / k_ms:.2f}% "
                 f"of it; launches per path run {launches_path}"
                 + (before(K5_BEFORE_MS, n, k_ms) if wt_ is full else ""),
                 shape=None if first else [n, 2 * steps], form=form)
            r = k45_row("conv_k5", first)
            r["chain_floor_ms"] = floor_ms
            r["lanes16_ms"], r["lanes4_ms"] = lanes_ms[16], lanes_ms[4]
            log(f"    lanes per word (csrc/alt/viterbi_lanes.cu, not "
                f"shipped): 16 lanes {lanes_ms[16]:.4f} ms, 4 lanes "
                f"{lanes_ms[4]:.4f} ms: the kernel is "
                f"{min(lanes_ms.values()) / k_ms:.2f}x faster than the "
                f"better")

    def check_k5(n, launches_path, main):
        """K5 against its plain version on CAC-punctured hard symbols
        (the CAC's weight row, broadcast and written out) and on soft
        symbols with soft weights, then timed."""
        data, sym, wt = k5_words(n)
        st_ = torch.as_tensor(sym, device=dev)
        wt_ = torch.as_tensor(wt, device=dev)
        row = wt_[0].clone()
        got = fdev.conv_k5_decode_batch(st_, wt_)
        want = fdev.conv_k5_decode_plain(st_, wt_)
        bcast = fdev.conv_k5_decode_batch(st_, row.expand(n, -1))
        _d, ssym, swt = k5_words(min(n, 4096), soft=True)
        ss, sw = (torch.as_tensor(ssym, device=dev),
                  torch.as_tensor(swt, device=dev))
        soft_eq = torch.equal(fdev.conv_k5_decode_batch(ss, sw),
                              fdev.conv_k5_decode_plain(ss, sw))
        if not (torch.equal(got, want) and torch.equal(bcast, want)
                and soft_eq):
            raise RuntimeError("K5 disagrees with its plain version")
        n_exact = int((got[:, :171].cpu().numpy() == data).all(1).sum())
        log(f"K5 conv_k5 [{n},350] -> [{n},175]: bits equal the plain "
            f"version's on CAC-punctured hard symbols (the weight row "
            f"broadcast and written out) and on soft symbols with soft "
            f"weights (tol 0); {n_exact}/{n} words with 0-6 flipped symbols "
            f"decode to their data")
        time_k5(n, 175, st_, row, launches_path, main, "NXDN CAC")
        if not main:
            sweep_k5(st_, row)

    def sweep_k5(st_, row):
        """K5 and its lanes designs over word counts with the weight row
        broadcast: one warp, then 1, 4, 8 and 15 warps of 32 words an SM
        (the thread-per-word kernel's blocks are one warp each)."""
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        sweep = []
        for k in (0, 1, 4, 8, 15):
            m = min(max(k * 32 * sms, 32), st_.shape[0])
            s_ = st_[:m]
            got = fdev.conv_k5_decode_batch(s_, row.expand(m, -1))
            lanes_ms = time_k5_lanes(s_, row, 0, got)
            k_ms = cuda_ms(
                lambda: fdev.conv_k5_decode_batch(s_, row.expand(m, -1)), 20)
            sweep.append({"words": m, "ms": k_ms,
                          "lanes16_ms": lanes_ms[16],
                          "lanes4_ms": lanes_ms[4]})
            log(f"  conv_k5 sweep [{m},350] broadcast row "
                f"({m / (32 * sms):.3g} warps of the kernel an SM): kernel "
                f"{k_ms:.4f} ms, 16 lanes {lanes_ms[16]:.4f}, 4 lanes "
                f"{lanes_ms[4]:.4f}")
        report["conv_k5"]["sweep"] = sweep

    pipe, launches["p25cc"] = run_monitor(
        "P25 CC path", "p25",
        lambda: ccbatch.BatchedP25ControlPipeline(C, FS,
                                                  tables=mon["p25"][0]),
        (k1fn, k4fn),
        ccbatch.BatchedP25ControlPipeline(
            2, FS, device="cpu", tables=params.load_cc("p25", "cpu")))
    n4 = 3 * (-(-len(pipe.last_tsdus[0]) // 64) * 64)
    log(f"P25 CC path: {pipe.crc_fallbacks} list-decode recoveries, "
        f"{pipe.crc_errors} blocks failed (the TSDUs a block end cuts); "
        f"K4 words per launch {n4}")
    check_k4(n4, launches["p25cc"]["p25_12_decode_batch"], True)
    check_k4(K4_SYNTH_N, launches["p25cc"]["p25_12_decode_batch"], False)
    time_monitor("P25 CC path", pipe, mon["p25"][3], False, p25_stage)
    del pipe

    pipe, launches["dmrcc"] = run_monitor(
        "DMR CC path", "dmr",
        lambda: ccbatch.BatchedDmrControlPipeline(C, FS,
                                                  tables=mon["dmr"][0]),
        (k1fn,),
        ccbatch.BatchedDmrControlPipeline(
            2, FS, device="cpu", tables=params.load_cc("dmr", "cpu")))
    time_monitor("DMR CC path", pipe, mon["dmr"][3], True, dmr_stage)
    del pipe

    pipe, launches["nxdncc"] = run_monitor(
        "NXDN CC path", "nxdn48",
        lambda: ccbatch.BatchedNxdnControlPipeline(
            C, FS, tables=mon["nxdn48"][0]),
        (k1fn, k5fn),
        ccbatch.BatchedNxdnControlPipeline(
            2, FS, device="cpu", tables=params.load_cc("nxdn48", "cpu")))
    n5 = -(-len(pipe.last_cacs[0]) // 32) * 32
    check_k5(n5, launches["nxdncc"]["conv_k5_decode_batch"], True)
    check_k5(K5_SYNTH_N, launches["nxdncc"]["conv_k5_decode_batch"], False)
    time_monitor("NXDN CC path", pipe, mon["nxdn48"][3], True, nxdn_stage)
    del pipe, mon

    # -- 5b. the P25 Phase 2 TDMA control channel at C=320 -----------------
    mark("5b")
    # the JAX bench's stream (bench.py:604): 6 superframes of scrambled
    # SACCH MAC PDUs (IDEN_UP TDMA, the TG 101 grant, NET_STS), 2.1767 s;
    # own lead of 0-96 dibits of filler and own noise per channel, from a
    # generator of their own so the other phases' inputs stay as they were
    p2rng = np.random.default_rng(SEED + 2)

    def p2cc_msgs(_sf, g):
        if g % 4 == 1:
            return [encode.p2_mac_iden_up_tdma(1, P2CC_CENTER_HZ, 6250.0)]
        if g % 4 == 2:
            return [encode.p2_mac_group_grant(P2CC_GRANT_CH, P2CC_TG, 5555)]
        return [encode.p2_mac_net_sts(*P2CC_KEY[:2])]

    t0 = time.perf_counter()
    pc_dib = encode.p2_cc_superframes(P2CC_SUPERFRAMES, *P2CC_KEY, p2cc_msgs)
    pc_B = len(pc_dib) * 8
    pc_block_s = pc_B / FS
    pc_n_sym = pc_B // 8 - 2
    pc_leads = p2rng.integers(0, TDMA_MAX_LEAD + 1, size=C)
    pc_seeds = p2rng.permutation(1 << 20)[:2 * C]
    pc_blocks = [torch.as_tensor(encode.p2_cc_block(
        pc_dib, pc_leads, pc_seeds[i::2], pc_B)).to(dev) for i in range(2)]
    # the frames a channel's block holds whole (the pick accepts a frame
    # at t when t + 720 < n_sym), and their xCCH timeslots' positions
    pc_frames = [[int(l) + 40 + 720 * k for k in range(3 * P2CC_SUPERFRAMES)
                  if int(l) + 40 + 720 * k + 720 < pc_n_sym]
                 for l in pc_leads]
    pc_slots = [sorted(t + 20 + 180 * ts for t in fr for ts in range(4))
                for fr in pc_frames]
    log(f"P2 CC set-up {time.perf_counter() - t0:.1f} s: B={pc_B} "
        f"({pc_block_s:.4f} s) n_sym={pc_n_sym}, leads "
        f"{pc_leads.min()}..{pc_leads.max()}, whole frames per channel "
        f"{min(map(len, pc_frames))}..{max(map(len, pc_frames))}")
    check_k1(pc_blocks[0], ptab.taps, shape=[C, pc_B])

    def p2cc_judge(label, pipe, blk, n0s, chans):
        """Every xCCH timeslot of every whole frame parsed (a SACCH line at
        its position, no other), the grant (TG 101 on its channel) and
        the 2-slot TDMA iden entry on every channel."""
        for c in chans:
            evs = pipe.ctxs[c].events[n0s[c]:]
            got = sorted(e.pos for e in evs
                         if e.line.startswith("       P25p2 SACCH"))
            if got != pc_slots[c]:
                raise RuntimeError(
                    f"{label} block {blk} channel {c}: SACCH lines at "
                    f"{sorted(set(got) ^ set(pc_slots[c]))[:6]} differ from "
                    "the timeslots of the whole frames")
            if any("ERR" in e.line for e in evs):
                raise RuntimeError(f"{label} block {blk} channel {c}: an "
                                   "error line")
            grants = [e.fields for e in pipe.ctxs[c].events
                      if e.fields.get("grant")]
            st = pipe.ctxs[c].state
            if not grants or any((g["tg"], g["channel"]) != (
                    P2CC_TG, P2CC_GRANT_CH) for g in grants):
                raise RuntimeError(f"{label} channel {c}: grants {grants[:2]}")
            if st.iden_table.entries.get(1, (0, 0, 0, 0))[3] != 2:
                raise RuntimeError(f"{label} channel {c}: no 2-slot TDMA "
                                   "iden entry")

    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the peak counts what other phases left allocated (their input blocks)
    pc_mem0 = torch.cuda.memory_allocated()
    pipe = ccbatch.BatchedP2ControlPipeline(
        C, FS, *P2CC_KEY, tables=ptab)
    cpu_pipe = ccbatch.BatchedP2ControlPipeline(
        2, FS, *P2CC_KEY, device="cpu",
        tables=params.load_tdma("p25p2", "cpu"))
    xcch = []
    for blk, xb in enumerate(pc_blocks):
        n0s = [len(ctx.events) for ctx in pipe.ctxs]
        t1 = time.perf_counter()
        n = pipe.decode_block_events(xb)
        dt = time.perf_counter() - t1
        p2cc_judge("P2 CC path", pipe, blk, n0s, range(C))
        want = sum(map(len, pc_slots))
        if n != want or pipe.rs_fallbacks or pipe.crc_errors:
            raise RuntimeError(f"P2 CC path block {blk}: {n} MAC PDUs "
                               f"parsed of {want}, {pipe.rs_fallbacks} RS "
                               f"fallbacks, {pipe.crc_errors} errors")
        xcch.append(pipe.last_xcch)
        log(f"P2 CC path block {blk}: {n} MAC PDUs parsed over {C} channels"
            f", every xCCH timeslot of every whole frame ({want}), all "
            f"through the screen (0 RS fallbacks, 0 CRC errors); the grant "
            f"and the 2-slot iden on every channel; {dt * 1e3:.1f} ms")
    launches["p2cc"] = check_launches(
        "P2 CC path", counted, (k1fn,), tuple(f for f in counted
                                              if f is not k1fn))
    if k1fn.launches != len(pc_blocks):
        raise RuntimeError(f"P2 CC path: K1 launched {k1fn.launches}x for "
                           f"{len(pc_blocks)} blocks")
    log(f"P2 CC path: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, of which "
        f"{pc_mem0 / 1e9:.2f} GB allocated before the phase")
    no_reference_modules()
    for blk, xb in enumerate(pc_blocks):
        cpu_pipe.decode_block_events(xb[:2].cpu())
        sel = xcch[blk][0] < 2
        if not all(np.array_equal(a[sel], b) for a, b in
                   zip(xcch[blk], cpu_pipe.last_xcch)):
            raise RuntimeError(f"P2 CC path block {blk}: the card's bursts "
                               "of channels 0-1 differ from the CPU path's")
    for c in range(2):
        a = [(e.line, e.pos, e.fields) for e in pipe.ctxs[c].events]
        b = [(e.line, e.pos, e.fields) for e in cpu_pipe.ctxs[c].events]
        if a != b:
            raise RuntimeError(f"P2 CC path: channel {c}'s events differ "
                               "from the CPU path's")
    log(f"P2 CC card vs CPU plain path, channels 0-1, both blocks: packed "
        f"bursts byte for byte and events ({len(a)} on channel 1, lines and "
        "fields) equal")
    vq = pipe.frontend_sync_device(pc_blocks[0])[2]
    n_pass = (vq.astype(np.float32) / 127.0 >= pipe.threshold).sum(1)
    log(f"P2 CC path: sync matches at or above the {pipe.threshold} "
        f"threshold per channel {int(n_pass.min())}..{int(n_pass.max())}, "
        f"in the port's top {vq.shape[1]} (the JAX package keeps 64)")

    # the blind recovery: 4 channels with no parameters
    blind = ccbatch.BatchedP2ControlPipeline(4, FS, tables=ptab)
    n_b = [blind.decode_block_events(pc_blocks[0][:4])]
    for c in range(4):
        st = blind.ctxs[c].state
        rec = [e for e in blind.ctxs[c].events if "recovered from RS parity"
               in e.line]
        if (st.p2_wacn, st.p2_sysid, st.p2_cc) != P2CC_KEY or len(rec) != 1:
            raise RuntimeError(f"P2 CC blind channel {c}: parameters "
                               f"{(st.p2_wacn, st.p2_sysid, st.p2_cc)}, "
                               f"{len(rec)} recovery lines")
    n0s = [len(ctx.events) for ctx in blind.ctxs]
    fb0 = blind.rs_fallbacks
    n_b.append(blind.decode_block_events(pc_blocks[1][:4]))
    p2cc_judge("P2 CC blind", blind, 1, n0s, range(4))
    want = sum(map(len, pc_slots[:4]))
    if n_b[1] != want or blind.rs_fallbacks != fb0 or blind.crc_errors:
        raise RuntimeError(f"P2 CC blind block 1: {n_b[1]} of {want} parsed, "
                           f"{blind.rs_fallbacks - fb0} RS fallbacks")
    log(f"P2 CC blind recovery, 4 channels without WACN/SYS/NAC: block 0 "
        f"{n_b[0]} MAC PDUs parsed, the parameters recovered from RS parity "
        f"on every channel (one 'recovered' line each); block 1 {n_b[1]} "
        f"of {want} through the screen, 0 RS fallbacks")
    del blind

    def p2cc_stage(pipe, feh):
        dibits_dev, idx, vq, duid, isch, n_sym = feh
        t1 = time.perf_counter()
        ch, tpos, sfp, duidv, _slot = pipe.pick_xcch(idx, vq, duid, isch,
                                                     n_sym)
        t_pick = time.perf_counter() - t1
        t1 = time.perf_counter()
        packed = pipe.gather_xcch(dibits_dev, ch, tpos)
        t_gather = time.perf_counter() - t1
        t1 = time.perf_counter()
        pipe.screen_xcch(packed, ch, sfp, duidv)
        return {"pick (ISCH resolution + pick_xcch)": t_pick,
                "device gather + blob": t_gather,
                "host screen (unpack, descramble, two products)":
                    time.perf_counter() - t1}

    torch.cuda.reset_peak_memory_stats()
    time_monitor("P2 CC path", pipe, pc_blocks, True, p2cc_stage,
                 "MAC PDUs parsed", block_s=pc_block_s)
    log(f"P2 CC path timed: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, of which "
        f"{pc_mem0 / 1e9:.2f} GB allocated before the phase")
    del pipe, cpu_pipe, pc_blocks

    # -- 6. the event pipelines at C=320 -----------------------------------
    mark("6")
    from dsdneo_tpu_torch.engine import demod
    from dsdneo_tpu_torch.engine.dstarbatch import BatchedDstarPipeline
    from dsdneo_tpu_torch.engine.m17batch import (GOLAY_ERR_MAX,
                                                  BatchedM17VoicePipeline,
                                                  _m17_tables)
    from dsdneo_tpu_torch.protocol.dstar.decoder import voicing_activity
    from dsdneo_tpu_torch.vocoder import codec2

    def topk_fill(pipe, fe, label):
        """How full the top-K candidate list was: channels whose K-th
        candidate still passes the score threshold (the list may then
        have dropped a candidate that passes)."""
        vq = fe[-2]
        last = vq[:, -1].astype(np.float32) / 127.0
        n_pass = (vq.astype(np.float32) / 127.0 >= pipe.threshold).sum(1)
        log(f"{label}: top-{vq.shape[1]} candidates per channel, "
            f"{int(n_pass.min())}..{int(n_pass.max())} (mean "
            f"{n_pass.mean():.1f}) at or above the {pipe.threshold} "
            f"threshold; channels whose K-th candidate passes it: "
            f"{int((last >= pipe.threshold).sum())}")

    def check_gated(label, kind, four_level):
        """The gated front end of channels 0-1 on the card against the
        port's CPU path: soft symbols within GATED_SOFT_TOL, dibits equal
        off the slicer thresholds by that margin."""
        _et, _etv, _leads, xblocks, n_sym = ev[kind]
        taps = torch.as_tensor(firdes.channel_lpf(FS, "6k25" if kind ==
                                                  "dstar" else "12k5"))
        gd, gs = demod.gated_frontend_step(xblocks[0][:2], taps.to(dev),
                                           10.0, n_sym, four_level)
        wd, ws = demod.gated_frontend_step(xblocks[0][:2].cpu(), taps,
                                           10.0, n_sym, four_level)
        gs, ws, gd, wd = gs.cpu().numpy(), ws.numpy(), gd.cpu().numpy(), \
            wd.numpy()
        err = float(np.abs(gs - ws).max())
        thr = np.array([0.0, 2.0, -2.0] if four_level else [0.0],
                       np.float32)
        off = np.abs(ws[..., None] - thr).min(axis=-1) > GATED_SOFT_TOL
        n_diff = int((gd[off] != wd[off]).sum())
        log(f"{label}: gated front end, card vs CPU path, channels 0-1: "
            f"soft max_abs_err {err:.3e} (tol {GATED_SOFT_TOL}), "
            f"{100 * float(np.mean(np.abs(gs - ws) <= 2e-4)):.2f}% within "
            f"2e-4; dibits off the thresholds ({int(off.sum())} of "
            f"{off.size}) differing: {n_diff}")
        if not err <= GATED_SOFT_TOL or n_diff:
            raise RuntimeError(f"{label}: the gated front end on the card "
                               "differs from its CPU path")

    def states_of(pipe):
        """``channel_state`` of channels 0-1, where the pipeline has one."""
        if not hasattr(pipe, "channel_state"):
            return []
        return [pipe.channel_state(c) for c in range(2)]

    def run_event(label, kind, make, runs, cpu_pipe, judge_block):
        """Two blocks with the contexts kept, launch counters reset
        before; every channel of each block judged against the vector
        by ``judge_block(pipe, blk, n0s)``; channels 0-1 against
        ``cpu_pipe`` on the CPU (frames, records, events, channel
        state)."""
        _et, _etv, _leads, xblocks, _n = ev[kind]
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pipe = make()
        frames = []
        for blk, xb in enumerate(xblocks):
            n0s = [len(ctx.events) for ctx in pipe.ctxs]
            t1 = time.perf_counter()
            n = pipe.decode_block_events(xb)
            dt = time.perf_counter() - t1
            msg = judge_block(pipe, blk, n0s)
            frames.append((pipe.last_frames, states_of(pipe)))
            log(f"{label} block {blk}: {n} frames accepted over {C} "
                f"channels; {msg}; {dt * 1e3:.1f} ms")
        got = check_launches(label, counted, runs,
                             tuple(f for f in counted if f not in runs))
        log(f"{label}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        no_reference_modules()
        for blk, xb in enumerate(xblocks):
            cpu_pipe.decode_block_events(xb[:2].cpu())
            (card, states), cpu = frames[blk], cpu_pipe.last_frames
            sel = card[0] < 2
            same = all(np.array_equal(a[sel], b) for a, b in
                       zip(card[:-1], cpu[:-1])) and (
                states == states_of(cpu_pipe))
            rows = ([r for r, k in zip(card[-1], sel) if k]
                    if isinstance(card[-1], list) else card[-1][sel])
            same = same and len(rows) == len(cpu[-1]) and all(
                np.array_equal(a, b) for a, b in zip(rows, cpu[-1]))
            if not same:
                raise RuntimeError(f"{label} block {blk}: the card's frames "
                                   "of channels 0-1 differ from the CPU "
                                   "path's")
        for c in range(2):
            a = [(e.line, e.pos) for e in pipe.ctxs[c].events]
            b = [(e.line, e.pos) for e in cpu_pipe.ctxs[c].events]
            if a != b:
                raise RuntimeError(f"{label}: channel {c}'s events differ "
                                   "from the CPU path's")
        log(f"{label} card vs CPU plain path, channels 0-1, both blocks: "
            f"accepted frames, records, channel states and events ({len(a)} "
            "on channel 1) equal")
        return pipe, got

    def judge_dstar(pipe, blk, n0s):
        _et, etv, leads, _x, n_sym = ev["dstar"]
        ac, at, ak, asc, recs = pipe.last_frames
        n_checked = n_junk = 0
        for c in range(pipe.C):
            mine = [(int(t), int(k), float(sc), r) for cc, t, k, sc, r
                    in zip(ac, at, ak, asc, recs) if cc == c]
            n = dstar_encode.judge(etv, int(leads[c]), n_sym, mine)
            n_checked += n
            n_junk += len(mine) - n
            voice = any(k == 0 and not r[396:].any() and any(
                voicing_activity(b) for b in np.unpackbits(
                    r[249:396]).reshape(21, 56)[:, :49])
                for _t, k, _s, r in mine)
            if pipe.channel_state(c) != ("voice" if voice else "idle"):
                raise RuntimeError(f"D-STAR block {blk} channel {c}: "
                                   f"state {pipe.channel_state(c)}")
        hd = sum(int(k) for k in ak)
        return (f"every header the block holds is accepted ({hd} header "
                f"picks), CRC-valid"
                f" with the vector's 41 octets and every partnered "
                f"superframe has the vector's slow data, raw AMBE bits and "
                f"49-bit parameters with 0 ECC errors ({n_checked} frames); "
                f"{n_junk} other picks, all headers failing the CRC under "
                f"the {dstar_encode.HD_SOLO_SCORE} score floor (no event); "
                f"channel states right")

    m17_seen = [set() for _ in range(C)]

    def judge_m17(pipe, blk, n0s):
        _et, etv, leads, _x, n_sym = ev["m17"]
        ac, at, blob = pipe.last_frames
        n_pass = n_junk = n_lsf = 0
        for c in range(pipe.C):
            rows = [(int(t), blob[h]) for h, t in enumerate(at) if ac[h] == c]
            lines = [e.line for e in pipe.ctxs[c].events[n0s[c]:]]
            now = m17_encode.judge(etv, int(leads[c]), n_sym, rows, lines,
                                   GOLAY_ERR_MAX, m17_seen[c])
            m17_seen[c] = now
            n_pass += len(now)
            n_junk += len(rows) - len(now)
            n_lsf += sum("SRC:" in ln for ln in lines)
            if pipe.channel_state(c) != ("voice" if now else "idle"):
                raise RuntimeError(f"M17 block {blk} channel {c}: state "
                                   f"{pipe.channel_state(c)}")
        return (f"{n_pass} stream frames pass the LICH gate, every one the "
                f"vector's with its FN and payload bytes, none missing; "
                f"{n_junk} other picks, all failing the gate; {n_lsf} LSFs "
                f"assembled CRC-valid with the vector's callsigns and CAN; "
                f"channel states right")

    def k3_words(n):
        """``n`` header codewords of random info bits (two flush bits)
        through the K=3 code (s1 = b ^ b' ^ b'', s0 = b ^ b'', vectorized;
        checked against the lattice of fec/device.K3_TRANS), 0-3 flipped
        bits each, the last two words all-zero and all-one."""
        info = np.concatenate([rng.integers(0, 2, (n, 328)),
                               np.zeros((n, 2), np.int64)], 1)
        b1 = np.pad(info, ((0, 0), (1, 0)))[:, :-1]
        b2 = np.pad(info, ((0, 0), (2, 0)))[:, :-2]
        w = np.stack([info ^ b1 ^ b2, info ^ b2], -1).reshape(n, 660)
        for i in range(4):
            st, ref = 0, []
            for b in info[i].tolist():
                ns = ((st << 1) | b) & 3
                pa, a1, a0, _pb, c1, c0 = fdev.K3_TRANS[ns]
                ref += [a1, a0] if st == pa else [c1, c0]
                st = ns
            if not np.array_equal(w[i], ref):
                raise RuntimeError("the vectorized K=3 encoder differs")
        w = w.astype(np.uint8)
        k = rng.integers(0, 4, n)
        for j in range(3):
            pos = rng.integers(0, 660, n)
            w[np.arange(n)[k > j], pos[k > j]] ^= 1
        w[-2], w[-1] = 0, 1
        return info[:, :330].astype(np.uint8), w

    def check_k6(n, launches_path, shape=None):
        info, words = k3_words(n)
        wt = torch.as_tensor(words, device=dev)
        got = fdev.conv_k3_decode_batch(wt)
        want = fdev.conv_k3_decode_plain(wt)
        if not torch.equal(got, want):
            raise RuntimeError("K6 disagrees with its plain version")
        n_exact = int((got.cpu().numpy()[:-2] == info[:-2]).all(1).sum())
        k_ms = cuda_ms(lambda: fdev.conv_k3_decode_batch(wt), 20)
        plain_ms = cuda_ms(lambda: fdev.conv_k3_decode_plain(wt), 1)
        # the first design (csrc/alt/conv_k3_v1.cu), held to the kernel
        v1_out = torch.empty_like(got)

        def v1():
            kernels.check(alt["conv_k3_v1"].dsd_conv_k3(
                wt.data_ptr(), v1_out.data_ptr(), n, 330,
                kernels.stream_handle(wt)), "conv_k3_v1")
        v1()
        if not torch.equal(v1_out, got):
            raise RuntimeError("K6's first design disagrees with K6")
        v1_ms = cuda_ms(v1, 20)
        b_ms, b_by = bound(nbytes(wt, got), 0)
        floor_ms = 330 * K6_CHAIN_CYCLES / (clk * 1e3)
        log(f"K6 conv_k3 [{n},660] -> [{n},330]: bits equal the plain "
            f"version's (tol 0) on codewords with 0-3 flipped bits and on "
            f"the all-zero and all-one words; {n_exact}/{n - 2} codewords "
            f"decode to their data")
        pred = K6_PREDICTED_MS.get(n)
        before = K6_BEFORE_MS.get(n)
        show("conv_k3", 0.0, k_ms, plain_ms, b_ms, b_by,
             f"; chain floor ~{floor_ms:.5f} ms (330 steps x "
             f"{K6_CHAIN_CYCLES} cycles at {clk:.0f} MHz), "
             f"{100 * floor_ms / k_ms:.2f}% of it; predicted "
             f"{'-'.join(map(str, pred)) if pred else 'no prediction'} ms; "
             f"first design {v1_ms:.4f} ms in this run (recorded "
             f"{before} ms); launches per path run {launches_path}",
             shape=shape)
        (report["conv_k3"] if shape is None else
         report["conv_k3"]["other_shapes"][-1]).update(
            chain_floor_ms=floor_ms, predicted_ms=pred, before_ms=before)

    def check_k5_m17(n, launches_path):
        """K5 at M17's word count on M17-like inputs: random 144-bit
        payloads (FN and voice) and 4 flush bits through the K=5 code,
        the P2 puncture (weight 0 on 24 of the 296 symbols), 0-6 flipped
        kept symbols, as ``m17_stream_decode_device`` hands them over."""
        bits = np.concatenate([rng.integers(0, 2, (n, 144)),
                               np.zeros((n, 4), np.int64)], axis=1)
        sym = conv.encode_rows(bits)
        keep = _m17_tables()[2]
        wt = np.zeros((n, 296), np.float32)
        wt[:, keep] = 1.0
        flip = (rng.random((n, 296)) < rng.integers(0, 7, (n, 1)) / 272.0) \
            & (wt > 0)
        sym[flip] = 1.0 - sym[flip]
        sym[wt == 0] = 0.0
        st_, wt_ = (torch.as_tensor(a, device=dev) for a in (sym, wt))
        row = wt_[0].clone()
        got = fdev.conv_k5_decode_batch(st_, wt_)
        if not (torch.equal(got, fdev.conv_k5_decode_plain(st_, wt_))
                and torch.equal(got, fdev.conv_k5_decode_batch(
                    st_, row.expand(n, -1)))):
            raise RuntimeError("K5 disagrees with its plain version on "
                               "M17's inputs")
        n_exact = int((got[:, :144].cpu().numpy() == bits[:, :144]).all(
            1).sum())
        log(f"K5 conv_k5 at M17's shape [{n},296] -> [{n},148]: bits equal "
            f"the plain version's (tol 0) on P2-depunctured 0/1 symbols "
            f"with 0/1 weights, broadcast and written out; {n_exact}/{n} "
            f"frames with 0-6 flipped symbols decode to their data")
        time_k5(n, 148, st_, row, launches_path, False, "M17")

    def dstar_stage(pipe, feh):
        t1 = time.perf_counter()
        ac, at, ak, _s = pipe.pick_frames(*feh[1:])
        t_pick = time.perf_counter() - t1
        t1 = time.perf_counter()
        pipe.decode_records(feh[0], ac, at, ak)
        return t_pick, time.perf_counter() - t1

    def m17_stage(pipe, feh):
        t1 = time.perf_counter()
        ac, at = pipe.pick_frames(*feh[1:])
        t_pick = time.perf_counter() - t1
        t1 = time.perf_counter()
        pipe.decode_frames(feh[0], ac, at)
        return t_pick, time.perf_counter() - t1

    log(f"libcodec2 {'found' if codec2.available() else 'not found'} on "
        "this machine (M17 synthesizes only for monitored channels, none "
        "in the timed loop, as the JAX bench runs it)")
    pipe, launches["dstar"] = run_event(
        "D-STAR path", "dstar",
        lambda: BatchedDstarPipeline(C, FS, tables=ev["dstar"][0]),
        (k6fn,),
        BatchedDstarPipeline(2, FS, device="cpu",
                             tables=params.load_event("dstar", "cpu")),
        judge_dstar)
    check_gated("D-STAR path", "dstar", False)
    topk_fill(pipe, pipe.frontend_sync_device(ev["dstar"][3][0]),
              "D-STAR path")
    n6 = -(-int((pipe.last_frames[2] == 1).sum()) // 8) * 8
    check_k6(n6, launches["dstar"]["conv_k3_decode_batch"])
    check_k6(K6_SYNTH_N, launches["dstar"]["conv_k3_decode_batch"],
             shape=[K6_SYNTH_N, 660])
    time_monitor("D-STAR path", pipe, ev["dstar"][3], True, dstar_stage,
                 "frames accepted")
    del pipe

    pipe, launches["m17"] = run_event(
        "M17 path", "m17",
        lambda: BatchedM17VoicePipeline(C, FS, monitor=set(),
                                        tables=ev["m17"][0]),
        (k5fn,),
        BatchedM17VoicePipeline(2, FS, monitor=set(), device="cpu",
                                tables=params.load_event("m17", "cpu")),
        judge_m17)
    check_gated("M17 path", "m17", True)
    topk_fill(pipe, pipe.frontend_sync_device(ev["m17"][3][0]), "M17 path")
    n5m = -(-len(pipe.last_frames[0]) // 64) * 64
    check_k5_m17(n5m, launches["m17"]["conv_k5_decode_batch"])
    time_monitor("M17 path", pipe, ev["m17"][3], True, m17_stage,
                 "frames accepted")
    del pipe, ev

    # -- 7. YSF, dPMR and the EDACS monitor at C=320 -----------------------
    mark("7")
    from dsdneo_tpu_torch.engine.ccbatch import BatchedEdacsControlPipeline
    from dsdneo_tpu_torch.engine.dpmrbatch import BatchedDpmrVoicePipeline
    from dsdneo_tpu_torch.engine.ysfbatch import (VOTE_ERR_MAX,
                                                  BatchedYsfVoicePipeline)
    k8_pcm = {}

    def conditioned(label):
        """``post`` of the voice paths: the CLI's conditioning of each
        block's decoded PCM on the card (de-emphasis "nfm" then the 3400
        Hz low-pass: one K8 cascade launch), held bit for bit to two
        plain calls on f16 block 0, whose PCM K8 is timed at after the
        path's run."""
        def post(pcm, fmt, blk):
            x = torch.as_tensor(pcm, device=dev)
            y = af.condition_audio(x, deemph="nfm", audio_lpf_hz=3400)
            if fmt == "f16" and blk == 0:
                plain = k8_plain(x)
                n_diff = int((y != plain[2]).sum())
                log(f"{label}: condition_audio(nfm, 3400 Hz) on the decoded "
                    f"{list(x.shape)} PCM on the card: {n_diff} samples "
                    "differ from the plain version (tol 0)")
                if n_diff or not torch.isfinite(y).all():
                    raise RuntimeError(f"{label}: K8 on the decoded PCM "
                                       "disagrees with its plain version")
                k8_pcm[label] = x, plain
        return post

    def burst_frames(pipe):
        bits, errs, fch, forder, _acc = pipe.last_frames
        return bits, errs, fch, forder

    def ysf_judge(pipe, fmt, blk):
        _bt, btv, leads, _x, n_sym = burst["ysf"]
        bits, verr, _f, _o, (ac, at) = pipe.last_frames
        b5 = bits.cpu().numpy().reshape(-1, 5, 49)
        e5 = verr.cpu().numpy().reshape(-1, 5)
        n_voice = sum(ysf_encode.judge(
            btv, int(leads[c]), n_sym, [(int(at[h]), b5[h], e5[h])
                                        for h in np.flatnonzero(ac == c)])
            for c in range(pipe.C))
        n_gated = int((e5 > VOTE_ERR_MAX).all(1).sum())
        return (f"every frame the block holds accepted ({len(ac)} frames): "
                f"{n_voice} voice frames with the vector's 5 x 49 bits and "
                f"unanimous votes, {n_gated} others failing the vote gate "
                f"on all five AMBE frames (the data frames)")

    def dpmr_judge(pipe, fmt, blk):
        _bt, btv, leads, _x, n_sym = burst["dpmr"]
        bits, errs, _f, _o, (ac, at, ai) = pipe.last_frames
        b8 = bits.cpu().numpy().reshape(-1, 8, 49)
        e8 = errs.cpu().numpy().reshape(-1, 8)
        n = sum(dpmr_encode.judge(
            btv, int(leads[c]), n_sym,
            [(int(at[h]), int(ai[h]), b8[h], e8[h])
             for h in np.flatnonzero(ac == c)], inverted=c % 4 == 3)
            for c in range(pipe.C))
        return (f"every part the block holds accepted ({n} parts, "
                f"{int(ai.sum())} of them inverted), each with the vector's "
                f"8 x 49 bits and no ECC error; nothing else accepted")

    idle8 = (k1fn, k2fn, k7fn, k4fn, k5fn, k6fn)
    for label, kind, cls, judge, pick in (
            ("YSF path", "ysf", BatchedYsfVoicePipeline, ysf_judge,
             lambda p, fe: p.pick_frames(*fe[1:])),
            ("dPMR path", "dpmr", BatchedDpmrVoicePipeline, dpmr_judge,
             lambda p, fe: p.pick_parts(*fe[1:]))):
        bt, _btv, _leads, xblocks, _n = burst[kind]
        launches[kind] = run_ambe_path(
            label, lambda fmt, cls=cls, bt=bt: cls(C, FS, pcm_fmt=fmt,
                                                   tables=bt),
            xblocks, C, burst_frames, judge, (k3fn, k8fn), idle8,
            cls(2, FS, device="cpu", tables=params.load_burst(kind, "cpu")),
            post=conditioned(label))
        # two formats x two blocks, one cascade launch each
        if launches[kind]["one_pole"] != 4:
            raise RuntimeError(f"{label}: K8 launched "
                               f"{launches[kind]['one_pole']}x on the path, "
                               "expected 4 (one cascade a block)")
        pcm, (y_de, ms_de, y_cas, ms_cas) = k8_pcm[label]
        for cascade, want, ms in ((False, y_de, ms_de),
                                  (True, y_cas, ms_cas)):
            show_k8(pcm, cascade, want, ms,
                    f"; at the {label}'s decoded PCM; launches per path "
                    f"run {launches[kind]['one_pole']}",
                    shape=list(pcm.shape))
        del pcm, y_de, y_cas
        if kind == "ysf":
            pipe = cls(C, FS, pcm_fmt="adpcm", tables=bt)
            topk_fill(pipe, pipe.frontend_sync_device(xblocks[0]), label)
        time_path(label, ident, cls(C, FS, pcm_fmt="adpcm", tables=bt),
                  xblocks, BLOCK_S, pick)
    k8_pcm.clear()

    def make_edacs(where, n_ch, topk=None):
        pipe = BatchedEdacsControlPipeline(n_ch, FS, device=where)
        if topk is not None:
            pipe.SYNC_TOPK = topk
        esk = int(burst["edacs"][1]["esk"])
        for c, ctx in enumerate(pipe.ctxs):
            mode = EDACS_MODES[c % 4]
            ctx.state.edacs_ea = mode == "ea"
            ctx.state.edacs_esk = esk if mode == "esk" else 0
        return pipe

    def judge_edacs(pipe, blk, n0s):
        _bt, btv, leads, _x, n_sym = burst["edacs"]
        ac, at, blob = pipe.last_frames
        n = n_lines = 0
        for c in range(pipe.C):
            lines = [e.line for e in pipe.ctxs[c].events[n0s[c]:]]
            n += edacs_encode.judge(
                btv, int(leads[c]), n_sym,
                [(int(at[h]), blob[h]) for h in np.flatnonzero(ac == c)],
                lines, EDACS_MODES[c % 4], c % 4 == 3)
            n_lines += len(lines)
        return (f"every frame the block holds accepted with the vector's two "
                f"messages ({n} frames; inverted channels read as -EDACS), "
                f"{n_lines} event lines equal to the JAX catalog's "
                f"(standard, EA and ESK readings); "
                f"{len(ac) - n} other picks, all failing the BCH screen")

    def edacs_stage(pipe, feh):
        t1 = time.perf_counter()
        ac, at = pipe.pick_frames(*feh[1:])
        t_pick = time.perf_counter() - t1
        t1 = time.perf_counter()
        pipe.decode_frames(feh[0], ac, at)
        return t_pick, time.perf_counter() - t1

    ev = {"edacs": burst["edacs"]}
    pipe, launches["edacs"] = run_event(
        "EDACS monitor", "edacs",
        lambda: make_edacs(dev, C), (), make_edacs("cpu", 2), judge_edacs)
    x0 = burst["edacs"][3][0]
    topk_fill(pipe, pipe.frontend_sync_device(x0), "EDACS monitor")
    n128 = pipe.decode_block_events(x0)
    n96 = make_edacs(dev, C, 96).decode_block_events(x0)
    log(f"EDACS monitor, block 0: {n128} frames parsed with the port's top "
        f"{pipe.SYNC_TOPK}, {n96} with the JAX package's top 96 (the frames "
        f"a continuous 3 s block holds: ~{C * 100})")
    time_monitor("EDACS monitor", pipe, burst["edacs"][3], True, edacs_stage,
                 "frames parsed")
    del pipe, ev, burst

    # -- 8. the serial decode path (decode_samples) -------------------------
    mark("8")
    launches["serial"] = serial_phase(ident, dev, blocks[0], counted)
    c4fm = blocks[0]                      # kept for phase 11
    del blocks

    # -- 9. the wideband band and the closed-loop trunked fleet -------------
    mark("9")
    torch.cuda.empty_cache()
    launches.update(fleet_phase(ident, dev, counted, show, check_k1,
                                check_k3, three_tones, tables))

    # -- 10. the CLI and the live one-tuner path ------------------------------
    mark("10")
    torch.cuda.empty_cache()
    launches.update(cli_phase(ident, dev, counted))
    no_reference_modules()

    # -- 11. the CLI's frontends and extras, the batched host leftovers ----
    mark("11")
    torch.cuda.empty_cache()
    launches.update(extras_phase(ident, dev, counted, show, check_k1, c4fm,
                                 tables))
    del c4fm
    no_reference_modules()

    # -- 12. the multi-GPU slice: parallel.mesh, parallel.trunkfleet -------
    mark("12")
    torch.cuda.empty_cache()
    launches.update(mesh_phase(ident, dev, counted, show, check_k1, mesh_in))
    del mesh_in
    no_reference_modules()
    mark()

    log(f"whole run {time.perf_counter() - t_start:.1f} s, the build and "
        "the set-up included")

    rows = [("fir_disc", "dsdneo_tpu_torch/csrc/fir_disc.cu",
             "dsdneo_tpu/ops/pallas_frontend.py:123", "fir_discriminate"),
            ("imbe_pred", "dsdneo_tpu_torch/csrc/imbe_pred.cu",
             "dsdneo_tpu/vocoder/device.py:101", "prediction_scan"),
            ("adpcm_enc", "dsdneo_tpu_torch/csrc/adpcm_enc.cu",
             "dsdneo_tpu/ops/audio_wire.py:47", "adpcm_compress"),
            ("rs_syndromes", "dsdneo_tpu_torch/csrc/rs_syndromes.cu",
             "dsdneo_tpu/fec/device.py:271", "rs_syndromes_batch"),
            ("p25_trellis", "dsdneo_tpu_torch/csrc/p25_trellis.cu",
             "dsdneo_tpu/fec/device.py:106", "p25_12_decode_batch"),
            ("conv_k5", "dsdneo_tpu_torch/csrc/conv_k5.cu",
             "dsdneo_tpu/fec/device.py:176", "conv_k5_decode_batch"),
            ("conv_k3", "dsdneo_tpu_torch/csrc/conv_k3.cu",
             "dsdneo_tpu/fec/device.py:229", "conv_k3_decode_batch"),
            ("one_pole", "dsdneo_tpu_torch/csrc/one_pole.cu",
             "dsdneo_tpu/dsp/audio_filters.py:19", "one_pole")]
    # one PyTorch call computes K7's function (rs_syndromes's library_ms:
    # the yardstick's f32 matmul); none computes any of the other seven.
    # "launches" sums the paths' runs; "launches_by_path" splits it
    log(ident)
    log(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(by[fn] for by in launches.values()),
         "launches_by_path": {p: by[fn] for p, by in launches.items()},
         "library_ms": None, **report[n]}
        for n, src, rep, fn in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
