"""Command-line interface of the port: ``python -m dsdneo_tpu_torch``.

The port's own copy of ``dsdneo_tpu/cli.py``: the same flag set
(``build_parser`` whole, flag-compatible with the reference decoder's
test harness, ``--frontend none -f1 --iq-replay f.iq.json -o null``;
tests/iq_decode_check.cmake:17-22, src/runtime/cli/args.c), the same
branches and the same printed lines.  Decoded payload lines go to
stderr, as the reference does.

One flag differs: ``--platform`` is ``cuda`` (the default; ``default``
means the same) or ``cpu``.  Every decode runs on that device: the card
unless ``--platform cpu`` is given, and without a card the CLI exits 1
naming it, never decoding on the CPU instead.  ``tpu`` is refused.
The frontends (``--frontend http``, ``--frontend terminal``/``-N``) only
watch: the decode under them runs on that device all the same.  M17
transmit (``-fZ``/``-fP``/``-fB``) is host code and needs no device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from dsdneo_tpu_torch.engine.modes import FLAG_TO_MODE

# what -N / --frontend terminal says when curses finds no terminal
NO_TERMINAL = "--frontend terminal: curses found no terminal to draw on"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dsd-neo-tpu", add_help=True,
                                description="digital speech decoder (PyTorch and "
                                            "CUDA)")
    p.add_argument("--iq-replay", metavar="FILE",
                   help="replay an I/Q capture (.iq or .iq.json sidecar)")
    p.add_argument("--http-port", type=int, default=8173,
                   help="port for --frontend http (reference Qt/QML "
                        "remote frontend equivalent; loopback bind)")
    p.add_argument("--frontend", default="none",
                   choices=["none", "terminal", "http"],
                   help="UI frontend")
    p.add_argument("-o", dest="audio_out", default="null",
                   help="audio output (null | wav:PATH | pcm:PATH | "
                        "udp:HOST:PORT | play | pulse | alsa — live "
                        "sinks play 48 kHz stereo; play8/pulse8/alsa8 "
                        "keep 8 kHz mono)")
    p.add_argument("-v", dest="verbose", action="count", default=0)
    p.add_argument("--sync-threshold", type=float, default=0.62)
    p.add_argument("-X", dest="p2_params", default=None,
                   metavar="WACNSYSNAC",
                   help="manually set P25p2 WACN/SYSID/NAC as 11 hex "
                        "digits, e.g. BEE00ABC123 (reference -X)")
    p.add_argument("--cqpsk", action="store_true",
                   help="use the CQPSK/LSM carrier+timing chain instead of "
                        "the FM discriminator path")
    p.add_argument("--platform", default="cuda",
                   choices=["cuda", "cpu", "default", "tpu"],
                   help="device of the decode: cuda (the card, the "
                        "default; 'default' means the same) or cpu; "
                        "without a card the CLI exits naming it")
    # decode mode flags (reference-compatible: -f1 -fs -fi ...)
    for flag, mode in FLAG_TO_MODE.items():
        p.add_argument(flag, dest="mode", action="store_const", const=mode,
                       help=f"decode mode: {mode}")
    p.set_defaults(mode="auto")
    # EDACS mode variants (reference args.c:2125-2266): -fh standard,
    # -fH standard + ESK 0xA0, -fe EA, -fE EA + ESK 0xA0; a 3-digit
    # suffix (-fh344 / -fH434) sets the AFS bit split (rewritten to
    # --edacs-afs by the argv prescan in main()).
    p.add_argument("-fH", dest="edacs_variant", action="store_const",
                   const="std_esk",
                   help="EDACS standard mode with ESK 0xA0 (reference -fH)")
    p.add_argument("-fe", dest="edacs_variant", action="store_const",
                   const="ea",
                   help="EDACS EA/ProVoice mode (reference -fe)")
    p.add_argument("-fE", dest="edacs_variant", action="store_const",
                   const="ea_esk",
                   help="EDACS EA mode with ESK 0xA0 (reference -fE)")
    p.add_argument("--edacs-afs", default="", metavar="AFS",
                   help="EDACS AFS bit split: three digits summing to 11 "
                        "(e.g. 344; reference -fh344/-fH434 suffixes)")
    p.add_argument("--esk", default="", metavar="HEX",
                   help="EDACS ESK scramble mask (8-bit hex; reference "
                        "esk_mask; -fH/-fE imply A0)")
    p.add_argument("-fr", dest="dmr_mono_mode", action="store_true",
                   help="DMR single-slot mono decoder (reference -fr)")
    p.add_argument("-ft", dest="trunk_helper", action="store_true",
                   help="trunking helper profile: P25p1 CC + P25p1/p2/DMR "
                        "voice with trunk-follow enabled (reference -ft)")
    p.add_argument("-fA", dest="analog_monitor", action="store_true",
                   help="passive analog monitor: no frame-sync hunt, raw "
                        "source audio only (reference -fA)")
    p.add_argument("-fU", dest="m17_udp_mode", action="store_true",
                   help="M17 UDP/IP frame input mode (with -i m17udp; "
                        "reference -fU)")
    p.set_defaults(edacs_variant=None, edacs_ea=False)
    # M17 encoders (reference src/runtime/cli/args.c:2289-2313 -fZ/-fB/-fP)
    p.add_argument("-fZ", dest="tx_mode", action="store_const", const="str",
                   help="M17 stream encoder")
    p.add_argument("-fP", dest="tx_mode", action="store_const", const="pkt",
                   help="M17 packet encoder")
    p.add_argument("-fB", dest="tx_mode", action="store_const", const="brt",
                   help="M17 BERT encoder")
    p.add_argument("-M", dest="m17dat", default="",
                   metavar="M17:CAN:SRC:DST",
                   help="M17 encoder user data (reference -M)")
    p.add_argument("--m17-sms", default="", metavar="TEXT",
                   help="SMS text for the M17 packet encoder")
    p.add_argument("--tx-frames", type=int, default=25,
                   help="stream/BERT frames to transmit")
    p.add_argument("--wideband", type=int, default=-1, metavar="N_CH",
                   nargs="?", const=0,
                   help="channelize a wideband capture into N_CH 48 kHz "
                        "channels (0/omitted value = infer from the capture "
                        "rate) and decode every active channel; the "
                        "whole-band answer to the reference's tuner "
                        "time-sharing (src/engine/trunk_scan.c)")
    p.add_argument("--stream", type=float, default=0.0, metavar="SECONDS",
                   help="decode in streamed blocks of this many seconds "
                        "(the live-pipeline path) instead of one shot")
    p.add_argument("--calls-dir", default="", metavar="DIR",
                   help="export per-call WAV+JSON records to DIR "
                        "(reference per-call WAV / rdio export)")
    p.add_argument("--keys-dec", default="", metavar="CSV",
                   help="import decimal key CSV (reference -k multi_key.csv)")
    p.add_argument("--keys-hex", default="", metavar="CSV",
                   help="import hex key CSV (reference -K multi_key_hex.csv)")
    p.add_argument("--keys-aes", default="", metavar="CSV",
                   help="import AES segment key CSV")
    p.add_argument("--frame-log", default=None, metavar="PATH",
                   help="write a structured per-frame log (reference "
                        "--frame-log; DSD_NEO_PDU_JSON upgrades entries "
                        "to JSON objects with decoded fields)")
    p.add_argument("--perf-csv", default=None, metavar="PATH",
                   help="write per-step pipeline timing CSV (reference "
                        "DSD_NEO_RTL_PERF_CSV, rtl_perf.cpp)")
    p.add_argument("--mbe-out", default="", metavar="PATH",
                   help="save decoded MBE voice frames to an .imb/.amb "
                        "data file (reference -d)")
    p.add_argument("--mbe-in", default="", metavar="PATH",
                   help="synthesize audio from an .imb/.amb MBE data "
                        "file instead of decoding RF (reference -r)")
    p.add_argument("-b", dest="bp_key_id", type=int, default=0,
                   metavar="ID", help="DMR Basic Privacy key ID 1-255 "
                                      "(reference -b)")
    p.add_argument("-G", dest="group_csv", default="", metavar="CSV",
                   help="talkgroup allow/block list CSV (reference -G "
                        "group.csv); blocked TGs are muted")
    p.add_argument("-C", dest="chan_csv", default="", metavar="CSV",
                   help="channel number -> frequency map CSV "
                        "(reference -C)")
    p.add_argument("--key-csi72", default="", metavar="HEX18",
                   help="Connect Systems EE72 72-bit key (18 hex chars)")
    p.add_argument("--key-tyt16", default="", metavar="HEX4",
                   help="TYT 16-bit Basic Privacy key")
    p.add_argument("--key-tyt-ep", default="", metavar="HEX32",
                   help="TYT Enhanced Privacy (AES) 128-bit key")
    p.add_argument("--key-retevis", default="", metavar="HEX",
                   help="Retevis AP (RC2) key, 32 or 64 hex chars")
    p.add_argument("--key-tyt-ap", default="", metavar="HEX",
                   help="TYT AP (PC4) key, 32 or 64 hex chars")
    p.add_argument("--key-baofeng", default="", metavar="HEX",
                   help="Baofeng AP (PC5) key, 32 or 64 hex chars")
    p.add_argument("--calc-lcn", dest="calc_lcn", default="", metavar="CSV",
                   help="one-shot DMR Tier III LCN calculator: map the "
                        "frequencies in CSV to LCNs and print lcn,freq "
                        "rows (reference oneshot_dmr_t3.c)")
    p.add_argument("--calc-step", dest="calc_step", type=int, default=0,
                   metavar="HZ", help="channel step in Hz for --calc-lcn "
                        "(default: inferred on the 125 Hz grid)")
    p.add_argument("--calc-cc-freq", dest="calc_cc_freq", type=float,
                   default=0.0, metavar="MHZ",
                   help="control-channel anchor frequency for --calc-lcn "
                        "(MHz if < 1e5, else Hz)")
    p.add_argument("--calc-cc-lcn", dest="calc_cc_lcn", type=int, default=0,
                   metavar="N", help="LCN of the anchor control channel")
    p.add_argument("--calc-start-lcn", dest="calc_start_lcn", type=int,
                   default=0, metavar="N",
                   help="LCN assigned to the lowest frequency (default 1)")
    p.add_argument("--wizard", action="store_true",
                   help="interactive setup wizard (reference bootstrap "
                        "interactive mode)")
    p.add_argument("--config", default="", metavar="INI",
                   help="load an INI user config (reference config_user; "
                        "DSD_NEO_CONFIG_AUTOSAVE=1 saves it back on exit)")
    p.add_argument("--m17-udp", default="", metavar="HOST:PORT",
                   help="blast decoded/encoded M17 frames as M17 UDP/IP "
                        "datagrams (reference M17 UDP mode)")
    p.add_argument("-R", dest="m17_scrambler", default="", metavar="HEX",
                   help="M17 scrambler seed (8/16/24-bit, reference -R)")
    p.add_argument("-T", "--trunk", dest="trunk", action="store_true",
                   help="enable trunk following on live inputs: grants "
                        "decoded off the control channel retune the tuner "
                        "to the voice channel and return on release/"
                        "hangtime (reference -T + p25_trunk_sm/dmr_trunk_sm)")
    p.add_argument("-t", "--hangtime", type=float, default=1.0, metavar="S",
                   help="voice-channel hangtime before returning to the "
                        "control channel (reference trunk_hangtime)")
    p.add_argument("--sm-log", default="", metavar="PATH",
                   help="append trunking state-machine decisions to PATH "
                        "(reference --p25-sm-log)")
    p.add_argument("-i", dest="input", default="", metavar="SPEC",
                   help="live input (reference -i): rtltcp:host:port[:freqHz]"
                        " (CU8 I/Q from an rtl_tcp server), tcp:host:port or"
                        " udp:port (48 kHz PCM16LE discriminator tap)")
    p.add_argument("--duration", type=float, default=10.0,
                   help="live-input run length in seconds (0 = until ^C)")
    p.add_argument("--m17-signature-public-key", default="", metavar="HEX",
                   help="64-byte secp256r1 public key (raw X||Y hex) for "
                        "M17 signed voice-stream verification (reference "
                        "--m17-signature-public-key)")
    p.add_argument("--m17-aes", default="", metavar="HEX",
                   help="M17 AES-CTR key (32/48/64 hex chars)")
    # trunking tune policy + encryption lockout (reference -E/-p/-e,
    # --enc-lockout/--enc-follow; consumed by engine.trunk.TrunkFollower)
    p.add_argument("-E", dest="no_group_calls", action="store_true",
                   help="disable tuning group voice grants (reference -E)")
    p.add_argument("-p", dest="no_private_calls", action="store_true",
                   help="disable tuning private voice grants (reference -p)")
    p.add_argument("-e", dest="data_calls", action="store_true",
                   help="enable tuning data channel grants (reference -e)")
    p.add_argument("--enc-lockout", action="store_true",
                   help="lock out talkgroups whose grants carry the "
                        "encryption service bit (session ledger; "
                        "reference --enc-lockout)")
    p.add_argument("--enc-follow", action="store_true",
                   help="follow encrypted grants without lockout "
                        "(default; reference --enc-follow)")
    p.add_argument("-I", dest="tg_hold", type=int, default=0, metavar="TG",
                   help="hold this talkgroup: all others are muted "
                        "(reference -I)")
    p.add_argument("-W", dest="whitelist", action="store_true",
                   help="treat the -G group list as an allow/whitelist "
                        "(reference -W)")
    p.add_argument("-F", dest="relax_crc", action="store_true",
                   help="relax CRC checks (P25p2 SACCH/FACCH MAC parse "
                        "proceeds on CRC12 failure; reference -F)")
    # external tuner + scanning
    p.add_argument("-U", dest="rigctl_port", type=int, default=0,
                   metavar="PORT",
                   help="retune through a rigctl TCP server on this port "
                        "(SDR++ default 4532; reference -U)")
    p.add_argument("--rigctl-host", default="127.0.0.1",
                   help="rigctl server host for -U")
    p.add_argument("--trunk-scan", default="", metavar="CSV",
                   help="single-tuner trunk scan target CSV "
                        "(reference --trunk-scan, docs/trunk-scan.md)")
    p.add_argument("--trunk-scan-dwell-ms", type=int, default=3000,
                   help="idle dwell per scan target (reference default "
                        "3000)")
    p.add_argument("--trunk-scan-activity-hold-ms", type=int, default=1200,
                   help="activity hold before rotating (reference 1200)")
    # capture / replay shaping
    p.add_argument("--iq-capture", default="", metavar="PATH",
                   help="journal the live input to an .iq capture with "
                        "sidecar metadata (reference --iq-capture)")
    p.add_argument("--iq-loop", type=int, default=1, metavar="N",
                   help="replay the capture N times (reference --iq-loop)")
    p.add_argument("--iq-replay-rate", type=float, default=0.0,
                   metavar="X", help="pace streamed replay at X times "
                        "realtime (0 = as fast as possible; reference "
                        "--iq-replay-rate)")
    p.add_argument("--auto-ppm", action="store_true",
                   help="automatic tuner PPM correction from the measured "
                        "CFO (reference --auto-ppm)")
    p.add_argument("--auto-ppm-snr", type=float, default=9.0, metavar="DB",
                   help="minimum SNR before auto-PPM acts (reference "
                        "--auto-ppm-snr)")
    p.add_argument("--input-volume", type=float, default=1.0, metavar="X",
                   help="input sample multiplier (reference "
                        "--input-volume)")
    p.add_argument("--input-level-warn-db", type=float, default=-200.0,
                   metavar="DB", help="warn when the input RMS falls "
                        "below this level (reference "
                        "--input-level-warn-db)")
    # rdio-scanner call upload (io.rdio.RdioUploader behind CallRecorder)
    p.add_argument("--rdio-api-url", default="", metavar="URL",
                   help="rdio-scanner API endpoint for per-call upload")
    p.add_argument("--rdio-api-key", default="", metavar="KEY")
    p.add_argument("--rdio-system-id", default="", metavar="ID")
    p.add_argument("--show-keys", action="store_true",
                   help="print key material unredacted (reference "
                        "--show-keys)")
    # trunking SM timing (reference --p25-vc-grace/--p25-cc-grace)
    p.add_argument("--p25-vc-grace", type=float, default=1.5, metavar="S",
                   help="grace period on the voice channel before "
                        "hangtime logic engages")
    p.add_argument("--p25-cc-grace", type=float, default=5.0, metavar="S",
                   help="control-channel silence timeout before hunting")
    # P25 follower fine-tuning (reference args.c:632-700 CLI knobs; all
    # override the DSD_NEO_* env values and land on TrunkSM params)
    p.add_argument("--p25-min-follow-dwell", type=float, default=None,
                   metavar="S", help="minimum dwell on a followed VC "
                   "before release is allowed")
    p.add_argument("--p25-grant-voice-timeout", type=float, default=None,
                   metavar="S", help="grant-to-voice timeout before "
                   "returning to the CC")
    p.add_argument("--p25-mac-hold", type=float, default=None, metavar="S",
                   help="P25p2 MAC-activity hold extension")
    p.add_argument("--p25-ring-hold", type=float, default=None, metavar="S",
                   help="ring/page hold extension")
    p.add_argument("--p25-force-release-extra", type=float, default=None,
                   metavar="S", help="extra budget past hangtime before "
                   "force release")
    p.add_argument("--p25-force-release-margin", type=float, default=None,
                   metavar="S", help="margin before the force-release "
                   "deadline")
    p.add_argument("--p25-p1-err-hold-pct", type=float, default=None,
                   metavar="PCT", help="IMBE error-rate threshold that "
                   "extends hangtime")
    p.add_argument("--p25-p1-err-hold-sec", type=float, default=None,
                   metavar="S", help="hangtime extension on high error "
                   "rate")
    p.add_argument("--fleet", default="", metavar="SPEC",
                   help="fleet monitoring over the replay: comma list "
                        "of mode:kind:count groups (kind voice|cc), "
                        "e.g. 'p25p1:voice:8,p25p1:cc:2' — every "
                        "channel carries the replayed capture; events "
                        "and PCM stats print per group (the "
                        "many-channel serving path)")
    p.add_argument("--trunk-wideband", default="", metavar="SPEC",
                   help="closed-loop trunking over a wideband replay: "
                        "'CCOFF_HZ[,CCOFF...]:N_VOICE[:MODE[:N_P2]]' — "
                        "control-channel offsets from band center + "
                        "voice-row count; MODE p25p1 (default), dmr, "
                        "nxdn48, nxdn96, or edacs (analog NBFM working "
                        "channels); N_P2 adds TDMA Phase-2 rows to a "
                        "p25p1 CC (mixed-phase system). Grants rewrite "
                        "voice-row NCOs between device steps (-C CSV "
                        "feeds LPCN/channel resolution)")
    p.add_argument("--probe", action="store_true",
                   help="probe the input: print detected mode + SNR and "
                        "exit (reference --probe)")
    p.add_argument("--print-config", action="store_true",
                   help="print the effective runtime config and exit")
    # -- reference short-flag surface (src/runtime/cli/args.c short
    # getopt loop; long aliases kept as the canonical dests) ----------
    p.add_argument("-w", dest="static_wav", default="", metavar="FILE",
                   help="static decoded-audio WAV output (alias of "
                        "-o wav:FILE; reference -w)")
    p.add_argument("-6", dest="raw_wav", default="", metavar="FILE",
                   help="raw 48 kHz demodulated source-audio WAV "
                        "(reference -6)")
    p.add_argument("-P", dest="percall_wav", action="store_true",
                   help="per-call WAV saving into the -7 directory "
                        "(default ./WAV; reference -P)")
    p.add_argument("-7", dest="percall_dir", default="", metavar="DIR",
                   help="per-call WAV directory for -P (reference -7)")
    p.add_argument("-d", dest="mbe_dir", default="", metavar="DIR",
                   help="save MBE frames to an auto-named .amb/.imb "
                        "file in DIR (reference -d)")
    p.add_argument("-r", dest="mbe_play", nargs="+", default=[],
                   metavar="FILE",
                   help="play saved .amb/.imb MBE files (reference -r)")
    p.add_argument("-J", dest="event_log", default="", metavar="FILE",
                   help="append decode event lines to FILE (reference -J)")
    p.add_argument("-L", dest="lrrp_log", default="", metavar="FILE",
                   help="append LRRP/GPS location lines to FILE "
                        "(reference -L)")
    p.add_argument("-Q", dest="dsp_out", default="", metavar="FILE",
                   help="save the float soft-symbol stream to ./DSP/FILE "
                        "(reference -Q)")
    p.add_argument("-c", dest="symbol_out", default="", metavar="FILE",
                   help="save the dibit symbol capture to FILE "
                        "(reference -c)")
    p.add_argument("--symbol-capture-format", default="dibit",
                   choices=["dibit", "float"],
                   help="symbol capture payload format (raw dibit bytes "
                        "or soft records; reference --symbol-capture-format)")
    p.add_argument("-N", dest="frontend_terminal", action="store_true",
                   help="alias of --frontend terminal (reference -N)")
    p.add_argument("-Z", dest="payload_log", action="store_true",
                   help="log MBE payloads to the console (reference -Z)")
    p.add_argument("-O", dest="list_devices", action="store_true",
                   help="list audio devices and exit (reference -O)")
    p.add_argument("-a", dest="call_alert", action="store_true",
                   help="call-alert bell on voice grants (reference -a)")
    p.add_argument("-8", dest="monitor_input", action="store_true",
                   help="monitor raw analog source audio when no "
                        "digital decode lands (reference -8)")
    p.add_argument("-g", dest="digital_gain", type=float, default=0.0,
                   metavar="X",
                   help="digital output gain: 0 = auto, 1..50 fixed "
                        "(25 = unity; reference -g)")
    p.add_argument("-n", dest="analog_gain", default="", metavar="X|m",
                   help="analog output gain 0..100; '-nm' enables the "
                        "DMR single-slot mono output (reference -n/-nm)")
    p.add_argument("-V", dest="slot_mask", type=int, default=3,
                   metavar="0..3",
                   help="TDMA slot synthesis mask: 1=slot1, 2=slot2, "
                        "3=both (reference -V)")
    p.add_argument("-z", dest="slot_pref", type=int, default=2,
                   metavar="0|1|2",
                   help="TDMA slot preference for mono output "
                        "(0=slot1, 1=slot2, 2=auto; reference -z)")
    p.add_argument("-y", dest="float_audio", action="store_true",
                   help="32-bit float audio output (reference -y)")
    p.add_argument("-s", dest="sample_rate", type=int, default=0,
                   metavar="HZ",
                   help="input sample rate for WAV/TCP/UDP PCM sources "
                        "(reference -s)")
    p.add_argument("-l", dest="no_cosine_filter", action="store_true",
                   help="disable the input channel low-pass filter "
                        "(reference -l)")
    p.add_argument("-q", dest="reverse_mute", action="store_true",
                   help="reverse mute: mute clear audio, unmute "
                        "encrypted (reference -q)")
    p.add_argument("-x", dest="inversion", action="append", default=[],
                   choices=["x", "r", "d", "z"],
                   help="polarity expectations: -xx non-inverted "
                        "X2-TDMA, -xr inverted DMR, -xd inverted dPMR, "
                        "-xz inverted M17 (reference -x)")
    p.add_argument("-~", dest="debug_mode", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("-m", dest="modulation", default="",
                   choices=["a", "c", "g", "q", "2", "3", "p", "h"],
                   help="modulation optimization lock: a=auto, c=C4FM, "
                        "g=GFSK, q=QPSK, 2=P25p2 QPSK 6000 sps "
                        "(reference -ma/-mc/-mg/-mq/-m2)")
    p.add_argument("-j", dest="lcw_retune", action="store_true",
                   help="P25: force-enable LCW explicit retune "
                        "(already the default policy; reference -j)")
    p.add_argument("-^", dest="prefer_cc_candidates", action="store_true",
                   help="P25: prefer learned CC candidates during "
                        "control-channel hunt (reference -^)")
    p.add_argument("-Y", dest="scanner_mode", action="store_true",
                   help="conventional scanner rotation over the -C "
                        "channel map (reference -Y)")
    p.add_argument("-B", dest="setmod_bw", type=int, default=0,
                   metavar="HZ",
                   help="rigctl setmod bandwidth pushed after each "
                        "retune (reference -B)")
    p.add_argument("-D", dest="dmrla_n", type=int, default=-1,
                   metavar="N",
                   help="DMR TIII Location Area n-bit length 0..10 "
                        "(reference -D)")
    p.add_argument("-_", dest="nxdn_seed", type=int, default=0,
                   metavar="SEED",
                   help="NXDN PN95 scrambler seed 1..511 (0 = default "
                        "228; reference -_)")
    # key material (reference short key flags; crypto/ consumers)
    p.add_argument("-1", dest="rc4_key", default="", metavar="HEX",
                   help="RC4/DES key (1..16 hex chars), applied when "
                        "the signalled KID has no CSV entry "
                        "(reference -1)")
    p.add_argument("-H", dest="hytera_key", default="", metavar="HEX",
                   help="Hytera Basic Privacy key: 10 (40-bit), 32 "
                        "(128-bit) or 64 (256-bit) hex chars "
                        "(reference -H)")
    p.add_argument("-2", dest="tyt16_key", default="", metavar="HEX4",
                   help="TYT 16-bit Basic Privacy key (alias of "
                        "--key-tyt16; reference -2)")
    p.add_argument("-!", dest="tyt_ap_key", default="", metavar="HEX",
                   help="TYT AP (PC4) key (alias of --key-tyt-ap; "
                        "reference -!)")
    p.add_argument("-@", dest="retevis_key", default="", metavar="HEX",
                   help="Retevis AP (RC2) key (alias of --key-retevis; "
                        "reference -@)")
    p.add_argument("-5", dest="tyt_ep_key", default="", metavar="HEX32",
                   help="TYT EP (AES) key (alias of --key-tyt-ep; "
                        "reference -5)")
    p.add_argument("-9", dest="ken_key", default="", metavar="HEX",
                   help="Kenwood DMR 15-bit scrambler key "
                        "(reference -9)")
    p.add_argument("-A", dest="anytone_key", default="", metavar="HEX4",
                   help="Anytone Basic Privacy 16-bit key (reference -A)")
    p.add_argument("-S", dest="static_ks", default="",
                   metavar="HEX[:MOD[:OFF:STEP]]",
                   help="straight mod-XOR static keystream spec "
                        "(reference -S)")
    p.add_argument("-k", dest="keys_dec_s", default="", metavar="CSV",
                   help="decimal key CSV (alias of --keys-dec; "
                        "reference -k)")
    p.add_argument("-K", dest="keys_hex_s", default="", metavar="CSV",
                   help="hex key CSV (alias of --keys-hex; "
                        "reference -K)")
    p.add_argument("-4", dest="key_priority", action="store_true",
                   help="force privacy key over encryption identifiers "
                        "(the rebuild applies loaded vendor/BP keys "
                        "with priority by default; reference -4)")
    p.add_argument("-0", dest="force_rc4", action="store_true",
                   help="force RC4 key over missing PI header / "
                        "late-entry identifiers (reference -0)")
    p.add_argument("-3", dest="disable_le", action="store_true",
                   help="disable DMR late-entry encryption "
                        "identifiers (reference -3)")
    # long-flag parity
    p.add_argument("--p25-sm-log", dest="sm_log_alias", default="",
                   metavar="PATH",
                   help="alias of --sm-log (reference --p25-sm-log)")
    p.add_argument("--interactive-setup", dest="wizard",
                   action="store_true",
                   help="alias of --wizard (reference "
                        "--interactive-setup)")
    p.add_argument("--profile", default="", metavar="NAME",
                   help="config profile section to apply (reference "
                        "--profile; equivalent to --config file@NAME)")
    p.add_argument("--iq-info", default="", metavar="PATH",
                   help="print I/Q capture sidecar metadata and exit "
                        "(reference --iq-info)")
    return p


def _write_frame_log(path: str, events, as_json: bool) -> None:
    """--frame-log sink: one line per decoded frame event; with
    DSD_NEO_PDU_JSON set, entries are JSON objects carrying the decoded
    fields (reference DSD_NEO_PDU_JSON, docs/cli.md:610)."""
    import json as _json

    import numpy as np

    def clean(v):
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        if isinstance(v, np.ndarray):
            return None          # bulk payloads stay out of the log
        return v

    with open(path, "a") as f:
        for ev in events:
            if as_json:
                fields = {k: clean(v) for k, v in ev.fields.items()}
                fields = {k: v for k, v in fields.items() if v is not None}
                f.write(_json.dumps({
                    "protocol": ev.protocol, "pos": ev.pos,
                    "line": ev.line, **({"fields": fields} if fields else {}),
                }) + "\n")
            else:
                f.write(f"{ev.pos}\t{ev.protocol}\t{ev.line}\n")


def _state_attrs(args, tg_policy, chan_map) -> dict:
    """Decoder-state knobs derived from CLI flags (BP/vendor keys,
    talkgroup policy, channel map)."""
    attrs = {}
    if args.bp_key_id:
        attrs["dmr_bp_key_id"] = args.bp_key_id
    if tg_policy is not None:
        attrs["tg_policy"] = tg_policy
    if getattr(args, "relax_crc", False):
        attrs["relax_crc"] = True
    if getattr(args, "show_keys", False):
        attrs["show_keys"] = True
    if chan_map is not None:
        attrs["chan_map"] = chan_map
    if args.key_csi72:
        attrs["dmr_csi72_key"] = bytes.fromhex(args.key_csi72)
    if args.key_tyt16:
        attrs["dmr_tyt16_key"] = int(args.key_tyt16, 16)
    if args.key_tyt_ep:
        attrs["dmr_tyt_ep_key"] = int(args.key_tyt_ep, 16)
    if args.key_retevis:
        from dsdneo_tpu_torch.crypto.retevis_rc2 import RetevisRC2
        attrs["dmr_retevis_rc2"] = RetevisRC2.from_hex(args.key_retevis)
    if args.key_tyt_ap:
        from dsdneo_tpu_torch.crypto.pc4 import PC4
        attrs["dmr_tyt_ap"] = PC4.from_hex(args.key_tyt_ap)
    if args.key_baofeng:
        from dsdneo_tpu_torch.crypto.pc5 import PC5
        attrs["dmr_baofeng_pc5"] = PC5.from_hex(args.key_baofeng)
    if args.m17_scrambler:
        attrs["m17_scrambler_key"] = int(args.m17_scrambler, 16)
    if args.m17_aes:
        attrs["m17_aes_key"] = bytes.fromhex(args.m17_aes)
    if args.m17_signature_public_key:
        attrs["m17_pubkey"] = bytes.fromhex(args.m17_signature_public_key)
    if args.edacs_ea:
        attrs["edacs_ea"] = True
    if args.esk:
        attrs["edacs_esk"] = int(args.esk, 16)
    if getattr(args, "edacs_afs", ""):
        from dsdneo_tpu_torch.protocol.edacs.afs import AfsSplit
        sp = AfsSplit.parse(args.edacs_afs)
        attrs["edacs_afs_bits"] = (sp.a_bits, sp.f_bits, sp.s_bits)
    # reference short-flag key/behavior surface (args.c getopt loop)
    if args.hytera_key:
        h = args.hytera_key.replace(" ", "")
        if len(h) <= 10:
            attrs["dmr_hytera_bp"] = (int(h, 16), 0, 0, 0)
        else:
            segs = [int(h[i:i + 16].ljust(16, "0"), 16)
                    for i in range(0, len(h), 16)]
            segs += [0] * (4 - len(segs))
            attrs["dmr_hytera_bp"] = tuple(segs[:4])
    if args.ken_key:
        attrs["dmr_kenwood_key"] = int(args.ken_key, 16) & 0x7FFF
    if args.anytone_key:
        attrs["dmr_anytone_key"] = int(args.anytone_key, 16) & 0xFFFF
    if args.static_ks:
        from dsdneo_tpu_torch.crypto.vendor import StaticKeystream
        attrs["dmr_static_ks"] = StaticKeystream.parse(args.static_ks)
    if args.force_rc4:
        attrs["dmr_force_rc4"] = True
    if args.disable_le:
        attrs["dmr_le_disable"] = True
    if args.slot_mask != 3:
        attrs["slot_mask"] = max(0, min(args.slot_mask, 3))
    if args.payload_log:
        attrs["payload_log"] = True
    if args.reverse_mute:
        attrs["reverse_mute"] = True
    if args.nxdn_seed:
        attrs["nxdn_pn95_seed"] = max(1, min(args.nxdn_seed, 0x1FF))
    if args.dmrla_n >= 0:
        attrs["dmr_dmrla_n"] = min(args.dmrla_n, 10)
    if args.modulation:
        attrs["mod_lock"] = args.modulation
    if args.inversion:
        # -x expectations → forced sync polarity per protocol family
        pol = {}
        for c in args.inversion:
            proto, want = {"x": ("x2tdma", False), "r": ("dmr", True),
                           "d": ("dpmr", True), "z": ("m17", True)}[c]
            pol[proto] = want
        attrs["force_polarity"] = pol
    return attrs


def _call_alert_wants(e) -> bool:
    """-a: does this decode event's milestone fall inside the
    DSD_NEO_CALL_ALERT_EVENTS mask (start/end/data; empty = all)?
    Reference: -a beep gated by the call-alert event chooser
    (runtime/call_alert.h + ui/terminal/menu_actions.c:720-726)."""
    from dsdneo_tpu_torch.core.events import AlertEvent, alert_events_from_str
    from dsdneo_tpu_torch.runtime import config as rtcfg
    mask = alert_events_from_str(rtcfg.get().call_alert_events)
    f = e.fields
    if f.get("release") or "Call End" in e.line:
        return bool(mask & AlertEvent.VOICE_END)
    if f.get("grant") or f.get("tg"):
        return bool(mask & AlertEvent.VOICE_START)
    if "PDU" in e.line or "Data" in e.line:
        return bool(mask & AlertEvent.DATA)
    return False


def _run_live(args, keyring, tg_policy, chan_map, recorder,
              cfg=None, device=None) -> int:
    """Live-source decode (reference -i input specs):
    ``rtltcp:host:port[:freqHz]`` pumps CU8 I/Q from an rtl_tcp server
    through the native ingest ring into the LiveEngine;
    ``tcp:host:port`` / ``udp[:bind]:port`` feed 48 kHz PCM16LE
    discriminator audio straight into the symbolizer
    (src/io/audio_backends/udp_input.c / tcp_input.c).  Every decode
    runs on ``device``."""
    import time as _time

    spec = args.input
    duration = args.duration
    httpf = [None]                # live HTTP frontend, set by _drive_live
    from collections import deque
    live_events = deque(maxlen=400)   # tail for the live terminal UI

    def on_event(e):
        live_events.append(e.line)
        print(e.line)
        if httpf[0] is not None:
            # structured push: feeds the event line ring AND the
            # /calls call-history segmentation
            httpf[0].push_decode_event(e)
        if args.event_log:
            with open(args.event_log, "a") as f:
                f.write(e.line.rstrip("\n") + "\n")
        if args.lrrp_log and ("GPS" in e.line or "LRRP" in e.line):
            with open(args.lrrp_log, "a") as f:
                f.write(f"{e.pos}\t{e.line.strip()}\n")
        if args.call_alert and _call_alert_wants(e):
            print("\a", end="", file=sys.stderr, flush=True)

    def _drive_live(make_dev):
        """Shared live-engine harness for the SDR device backends:
        engine setup, device construction at a tuner-valid rate with
        CU8 decimation into the 48 kHz ring, trunk wiring, run loop."""
        from dsdneo_tpu_torch.engine.live import LiveEngine
        from dsdneo_tpu_torch.io.sdr_device import SdrUnavailable
        perf_live = None
        pc = (args.perf_csv if args.perf_csv is not None
              else (cfg.perf_csv if cfg else None))
        if pc:
            # --perf-csv on the live path: per-block decode time +
            # ring-drop counters (reference DSD_NEO_RTL_PERF_CSV)
            from dsdneo_tpu_torch.runtime.log import PerfProbe
            perf_live = PerfProbe(
                pc, interval_s=(cfg.perf_interval_ms / 1e3 if cfg
                                else 1.0))
        eng = LiveEngine(
            args.mode, fs=48000.0, block_s=0.25, on_event=on_event,
            retune_mute_s=(cfg.retune_mute_ms / 1e3 if cfg else 0.075),
            hop_s=(cfg.squelch_hop_s if cfg else 0.5), perf=perf_live,
            device=device)
        eng.level_warn_db = args.input_level_warn_db
        eng.input_volume = args.input_volume
        if args.frontend == "http":
            # remote frontend: snapshots + commands over HTTP (the
            # reference's Qt/QML view-model polling, app_control/http)
            from dsdneo_tpu_torch.app_control.http import HttpFrontend
            httpf[0] = HttpFrontend(eng.metrics, eng.commands,
                                    port=args.http_port).start()
            httpf[0].fs_sym = float(eng.decoder.mode.symbol_rate)
            print(f"http frontend: http://127.0.0.1:{httpf[0].port}/",
                  file=sys.stderr)
        if cfg is not None:
            eng.snr_squelch_db = cfg.snr_sql_db
            eng.dc_block = cfg.iq_dc_block
            eng.dc_shift = cfg.iq_dc_shift
            eng.retune_drain_s = cfg.retune_drain_ms / 1e3
            eng.output_clear_on_retune = cfg.output_clear_on_retune
            eng.combine_rot = cfg.combine_rot
            eng.fs4_shift = not cfg.disable_fs4_shift
        if args.iq_capture:
            from dsdneo_tpu_torch.io.iq import IqCaptureWriter, IqMetadata
            eng.capture = IqCaptureWriter(
                args.iq_capture, IqMetadata(sample_format="cf32",
                                            sample_rate_hz=48000))
        st = eng.decoder.ctx.state
        st.keyring = keyring
        for k, v in _state_attrs(args, tg_policy, chan_map).items():
            setattr(st, k, v)
        eng.decoder.ctx.call_recorder = recorder
        try:
            dev, freq = make_dev(eng)
        except (OSError, SdrUnavailable) as e:
            print(f"dsd-neo-tpu: live source unavailable: {e}",
                  file=sys.stderr)
            if httpf[0] is not None:
                httpf[0].stop()
            return 1
        if (cfg is not None and cfg.tuner_autogain
                and hasattr(dev, "set_gain")):
            # DSD_NEO_TUNER_AUTOGAIN*: closed-loop tuner gain
            from dsdneo_tpu_torch.io.auto_gain import TunerAutogain
            eng.auto_gain = TunerAutogain(
                dev.set_gain,
                probe_ms=cfg.tuner_autogain_probe_ms,
                seed_db=cfg.tuner_autogain_seed_db,
                spec_snr_db=cfg.tuner_autogain_spec_snr_db,
                inband_ratio=cfg.tuner_autogain_inband_ratio,
                up_step_db=cfg.tuner_autogain_up_step_db,
                up_persist=cfg.tuner_autogain_up_persist)
        rig = None
        if args.rigctl_port:
            # external tuner control through a rigctl TCP server
            # (reference -U; SDR++ default 4532)
            from dsdneo_tpu_torch.io.net import RigctlClient
            try:
                # DSD_NEO_RIGCTL_RCVTIMEO: socket receive timeout
                rig = RigctlClient(args.rigctl_host, args.rigctl_port,
                                   timeout=(cfg.rigctl_rcvtimeo_ms / 1e3
                                            if cfg else 2.0))
            except OSError as e:
                print(f"dsd-neo-tpu: rigctl unavailable: {e}",
                      file=sys.stderr)

        def _retune_hw(f_hz: float) -> None:
            if rig is not None:
                rig.set_freq(f_hz)
                if args.setmod_bw > 0:
                    # -B: push setmod bandwidth after each retune
                    rig.set_mode("FM", args.setmod_bw)
            else:
                # keep the +fs/4 capture-shift relationship on retunes
                dev.set_freq(int(f_hz + eng.fs4_offset_hz))

        if args.trunk or args.trunk_scan:
            from dsdneo_tpu_torch.engine.trunk import TrunkFollower, TrunkSM

            def _tune(f_hz, kind):
                _retune_hw(f_hz)
                eng.tune(f_hz)
                return True

            # per-protocol hangtime knobs override -t when set
            # (DSD_NEO_P25_HANGTIME / DSD_NEO_DMR_HANGTIME)
            hang = args.hangtime
            if cfg is not None:
                if args.mode.startswith("p25") and cfg.p25_hangtime_s > 0:
                    hang = cfg.p25_hangtime_s
                elif args.mode == "dmr" and cfg.dmr_hangtime_s > 0:
                    hang = cfg.dmr_hangtime_s
            sm = TrunkSM(_tune, hangtime_s=hang,
                         vc_grace_s=args.p25_vc_grace,
                         cc_timeout_s=args.p25_cc_grace,
                         policy=(tg_policy.allows if tg_policy else None),
                         **(TrunkSM.kwargs_from_config(cfg, args.mode)
                            if cfg is not None else {}))
            sm.log_path = args.sm_log
            sm.prefer_candidates = args.prefer_cc_candidates
            if chan_map is not None:
                sm.hunt_all = sorted(set(chan_map.entries.values()))
            fol = TrunkFollower(sm, eng.decoder.ctx,
                                chan_map=chan_map,
                                current_freq=lambda: eng.freq_hz
                                or float(freq))
            fol.tune_group = not args.no_group_calls
            fol.tune_private = not args.no_private_calls
            fol.tune_data = args.data_calls
            fol.enc_lockout = args.enc_lockout and not args.enc_follow
            if cfg is not None:
                fol.preempt_min_dwell_s = cfg.tg_preempt_min_dwell_ms / 1e3
                fol.preempt_cooldown_s = cfg.tg_preempt_cooldown_ms / 1e3
                fol.grant_voice_to_s = cfg.p25_grant_voice_to_s
            eng.trunk = fol
        if args.trunk_scan or (args.scanner_mode and chan_map is not None):
            from dsdneo_tpu_torch.engine.trunk import (ScanTarget, TrunkScanner,
                                                 load_scan_targets)

            def _scan_tune(f_hz, mode):
                _retune_hw(f_hz)
                eng.tune(f_hz)
                return True

            sc = TrunkScanner(_scan_tune,
                              dwell_s=args.trunk_scan_dwell_ms / 1e3,
                              hold_s=args.trunk_scan_activity_hold_ms / 1e3)
            if args.trunk_scan:
                n = load_scan_targets(sc, args.trunk_scan)
                print(f"trunk-scan: {n} targets from {args.trunk_scan}",
                      file=sys.stderr)
            else:
                # -Y: conventional scanner rotation over the -C map
                n = 0
                for ch, f_hz in sorted(chan_map.entries.items()):
                    if sc.add_target(ScanTarget(freq_hz=f_hz,
                                                mode=args.mode,
                                                label=f"ch{ch}")):
                        n += 1
                print(f"scanner: {n} channels from the -C map",
                      file=sys.stderr)
            eng.scanner = sc
        if args.auto_ppm:
            from dsdneo_tpu_torch.io.auto_ppm import AutoPpm
            eng.auto_ppm = AutoPpm(
                dev.set_ppm, float(freq), snr_gate_db=args.auto_ppm_snr,
                freeze=bool(cfg is not None and cfg.auto_ppm_freeze),
                pwr_gate_db=(cfg.auto_ppm_pwr_db if cfg else -80.0),
                deadband_ppm=(cfg.auto_ppm_zerolock_ppm if cfg else 0.55),
                zerolock_hz=(cfg.auto_ppm_zerolock_hz if cfg else 0.0))
        if cfg is not None:
            eng.afc_status_gate = cfg.p25_afc_status_gate
        eng.on_ppm = dev.set_ppm
        eng.freq_hz = float(freq)
        # graceful SIGTERM stop, unless the embedder owns shutdown
        # (DSD_NEO_NO_SIGNAL_HANDLERS, docs/cli.md:594-596)
        if cfg is None or not cfg.no_signal_handlers:
            import signal as _signal

            def _on_term(signum, frame):
                eng._stop = True
            try:
                _signal.signal(_signal.SIGTERM, _on_term)
            except ValueError:
                pass        # not the main thread: skip
        dev.start()
        eng.start()
        try:
            drawn = False
            t0 = _time.time()
            if args.frontend == "terminal":
                # live curses frontend: app_control snapshot polling +
                # menu commands into the engine queue (ui_async.c)
                from dsdneo_tpu_torch.ui.terminal import run_live
                drawn = run_live(eng, duration=duration, events=live_events)
                if not drawn:
                    print(f"dsd-neo-tpu: {NO_TERMINAL}; decoding without "
                          "it", file=sys.stderr)
            if not drawn:
                while duration <= 0 or _time.time() - t0 < duration:
                    _time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        eng.stop()
        dev.close()
        if httpf[0] is not None:
            # the JAX CLI leaves its server running until the process
            # ends; here it stops with the engine
            httpf[0].stop()
        if eng.capture is not None:
            # the JAX CLI leaves the writer open: its sidecar (rates,
            # retune journal) is never written
            eng.capture.close()
        if perf_live is not None:
            perf_live.flush_now()
            perf_live.close()
        return 0

    if spec.startswith("rtltcp:"):
        from dsdneo_tpu_torch.io.rtl_tcp import RtlTcpClient
        from dsdneo_tpu_torch.io.sdr_device import (_DecimatingRing,
                                              pick_device_rate)
        parts = spec.split(":")
        host, port = parts[1], int(parts[2])
        freq = int(parts[3]) if len(parts) > 3 else 851_000_000
        # DSDNEO_RTLTCP_RATE=48000 keeps the legacy direct-48k mode for
        # servers (and the test fake) that accept arbitrary rates
        rate = int(os.environ.get("DSDNEO_RTLTCP_RATE", 0) or 0)

        def make_rtltcp(eng):
            if rate:
                dev_rate, factor = rate, rate // 48000
            else:
                dev_rate, factor = pick_device_rate(48000)
            ring = (eng.ring if factor <= 1
                    else _DecimatingRing(eng.ring, factor))
            dev = RtlTcpClient(host, port, ring, sample_rate=dev_rate,
                               freq_hz=freq + int(eng.fs4_offset_hz))
            return dev, freq

        return _drive_live(make_rtltcp)

    if spec.startswith(("rtlusb", "soapy:")):
        from dsdneo_tpu_torch.io.sdr_device import (RtlUsbDevice, SoapyDevice,
                                              _DecimatingRing,
                                              pick_device_rate)

        def make_sdr(eng):
            dev_rate, factor = pick_device_rate(48000)
            ring = (eng.ring if factor <= 1
                    else _DecimatingRing(eng.ring, factor))
            parts = spec.split(":")
            if spec.startswith("rtlusb"):
                # rtlusb[:index][:freqHz]
                index = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                freq = int(parts[2]) if len(parts) > 2 else 851_000_000
                dev = RtlUsbDevice(ring, index=index, sample_rate=dev_rate,
                                   agc=bool(cfg is not None and cfg.rtl_agc),
                                   bandwidth_hz=(cfg.tuner_bw_hz
                                                 if cfg is not None else 0),
                                   freq_hz=freq + int(eng.fs4_offset_hz))
            else:
                # soapy:driver=...[:freqHz]
                freq = int(parts[2]) if len(parts) > 2 else 851_000_000
                dev = SoapyDevice(ring, driver_args=parts[1],
                                  sample_rate=dev_rate,
                                  freq_hz=freq + int(eng.fs4_offset_hz))
            return dev, freq

        return _drive_live(make_sdr)

    if spec.endswith(".wav") and os.path.isfile(spec):
        # -i file.wav: discriminator-tap PCM decode (reference WAV
        # input; -s overrides the rate for DSDPlus 96 kHz captures)
        from dsdneo_tpu_torch.engine.stream import StreamDecoder
        from dsdneo_tpu_torch.io.audio_files import read_wav
        pcm, rate = read_wav(spec)
        fs = float(args.sample_rate or rate or 48000)
        sd = StreamDecoder(args.mode, fs=fs,
                           sync_threshold=args.sync_threshold,
                           input_kind="disc", device=device)
        st = sd.ctx.state
        st.keyring = keyring
        for k, v in _state_attrs(args, tg_policy, chan_map).items():
            setattr(st, k, v)
        sd.ctx.call_recorder = recorder
        x = np.asarray(pcm)
        x = (x.astype(np.float32) / 32768.0 if x.dtype.kind == "i"
             else x.astype(np.float32))
        for e in sd.push(x * args.input_volume):
            on_event(e)
        for e in sd.flush():
            on_event(e)
        return 0

    if spec.startswith(("tcp:", "udp:", "udp")):
        from dsdneo_tpu_torch.engine.stream import StreamDecoder
        from dsdneo_tpu_torch.io.net import TcpPcmInput, UdpPcmInput
        fs_pcm = float(args.sample_rate or 48000)
        sd = StreamDecoder(args.mode, fs=fs_pcm,
                           sync_threshold=args.sync_threshold,
                           input_kind="disc", device=device)
        st = sd.ctx.state
        st.keyring = keyring
        for k, v in _state_attrs(args, tg_policy, chan_map).items():
            setattr(st, k, v)
        sd.ctx.call_recorder = recorder
        try:
            if spec.startswith("tcp:"):
                _, host, port = spec.split(":")
                src = TcpPcmInput(host, int(port),
                                  backoff_ms=(cfg.tcpin_backoff_ms
                                              if cfg else 0.0))
            else:
                parts = spec.split(":")
                bind = parts[1] if len(parts) > 2 else "127.0.0.1"
                port = int(parts[-1])
                src = UdpPcmInput(bind=bind, port=port)
        except OSError as e:
            print(f"dsd-neo-tpu: PCM input failed: {e}", file=sys.stderr)
            return 1
        chunk = int(fs_pcm / 4)             # 0.25 s blocks
        t0 = _time.time()
        try:
            while duration <= 0 or _time.time() - t0 < duration:
                pcm = src.read(chunk)
                if pcm is None:
                    break
                for e in sd.push(pcm.astype(np.float32) / 32768.0):
                    on_event(e)
        except KeyboardInterrupt:
            pass
        for e in sd.flush():
            on_event(e)
        src.close()
        return 0

    print(f"dsd-neo-tpu: unknown input spec {spec!r}", file=sys.stderr)
    return 2


def _fleet_http_serve(args, fleet, block, fs: float) -> int:
    """--fleet --frontend http: loop the replay block at realtime pace
    and serve the fleet console (channel grid, per-channel events,
    call history, command queue) over the HTTP frontend — the
    reference's Qt/QML view-model polling applied to fleet scale."""
    import time as _time

    from dsdneo_tpu_torch.app_control.commands import AppCommand, CommandQueue
    from dsdneo_tpu_torch.app_control.http import HttpFrontend
    from dsdneo_tpu_torch.app_control.snapshot import MetricsHub

    hub, q = MetricsHub(), CommandQueue()
    grid_cache: list[list] = [[]]
    httpf = HttpFrontend(hub, q, grid_provider=lambda: grid_cache[0],
                         port=args.http_port).start()
    print(f"http frontend: http://127.0.0.1:{httpf.port}/ "
          f"({fleet.total_channels} channels)", file=sys.stderr)
    block_s = block.shape[1] / fs
    t0 = _time.time()
    # publish the channel list immediately (all idle) so the console
    # renders during the first block
    grid_cache[0] = fleet.channel_dicts()
    try:
        while True:
            t_blk = _time.time()
            fleet.decode_block(block)
            # grid BEFORE clearing events (state derives from tails)
            grid_cache[0] = fleet.channel_dicts()
            for g in fleet.groups:
                p = g.pipeline
                if not hasattr(p, "events"):
                    continue
                rate = float(getattr(getattr(p, "mode", None),
                                     "symbol_rate", 4800.0))
                for i in range(g.count):
                    evs = p.events(i)
                    for e in evs:
                        httpf.push_decode_event(e, fs_sym=rate)
                    evs.clear()        # bounded ctxs across loops
            m = getattr(fleet.groups[0].pipeline, "mode",
                        None) if fleet.groups else None
            hub.publish(stream_active=True, blocks=fleet.blocks,
                        symbol_rate_hz=int(getattr(m, "symbol_rate",
                                                   4800)))
            if any(c.cmd is AppCommand.STOP for c in q.drain()):
                break
            if args.duration > 0 and _time.time() - t0 >= args.duration:
                break
            _time.sleep(max(0.0, block_s - (_time.time() - t_blk)))
    except KeyboardInterrupt:
        pass
    finally:
        httpf.stop()
    print(f"fleet: {fleet.blocks} blocks over "
          f"{fleet.total_channels} channels", file=sys.stderr)
    return 0


def _run_m17_tx(args) -> int:
    """Generate an M17 transmission as a baseband I/Q capture.

    The reference encoders (src/protocol/m17/m17.c encodeM17STR/PKT/BRT)
    emit 48 kHz RF audio; here the dibit stream is 4FSK-modulated at
    48 kHz (10 samples/symbol) and written as a cf32 capture that the
    decode path — ours or the reference's — can replay.  Host code
    (numpy): no device.
    """
    from dsdneo_tpu_torch.protocol.m17 import encoder as m17tx

    can, src, dst = 7, "DSD-NEO", "BROADCAST"
    parts = args.m17dat.upper().split(":")
    if parts and parts[0] == "M17":
        if len(parts) > 1 and parts[1].isdigit():
            can = min(int(parts[1]), 15)
        if len(parts) > 2 and parts[2]:
            src = parts[2][:9]
        if len(parts) > 3 and parts[3]:
            dst = parts[3][:9]

    if args.tx_mode == "str":
        voice = np.zeros((args.tx_frames, 128), dtype=np.uint8)
        dibits = m17tx.encode_stream_transmission(dst, src, voice, can=can)
        desc = f"M17 Stream  CAN:{can} SRC:{src} DST:{dst} ({args.tx_frames} frames)"
    elif args.tx_mode == "pkt":
        text = args.m17_sms or "dsd-neo-tpu M17 packet test"
        dibits = m17tx.encode_packet_transmission(dst, src, text, can=can)
        desc = f"M17 Packet  CAN:{can} SRC:{src} DST:{dst} SMS:{text!r}"
    else:
        dibits = m17tx.encode_bert_transmission(args.tx_frames)
        desc = f"M17 BERT ({args.tx_frames} frames)"

    iq = m17tx.dibits_to_baseband(dibits, sps=10, dev=0.15)
    print(f"M17 Encoder: {desc}", file=sys.stderr)
    print(f"M17 Encoder: {len(dibits)} symbols, {len(iq)} samples @48000",
          file=sys.stderr)
    if args.audio_out.startswith("iq:"):
        from dsdneo_tpu_torch.io.iq import IqMetadata, write_iq_capture
        write_iq_capture(args.audio_out[3:], iq,
                         IqMetadata(sample_format="cf32", sample_rate_hz=48000))
        print(f"M17 Encoder: wrote {args.audio_out[3:]}", file=sys.stderr)
    elif args.audio_out != "null":
        print("M17 Encoder: use -o iq:PATH to write the capture",
              file=sys.stderr)
        return 2
    return 0


def _prescan_argv(argv: list[str]) -> list[str]:
    """Rewrite reference-style fused tokens argparse can't express:
    ``-fh344``/``-fH434`` (EDACS mode + AFS bit split, reference
    args.c:2125-2215) become the base flag plus ``--edacs-afs``."""
    out = []
    for tok in argv:
        if (len(tok) == 6 and tok.startswith("-f")
                and tok[2] in "hHeE" and tok[3:].isdigit()):
            out += [tok[:3], "--edacs-afs", tok[3:]]
        else:
            out.append(tok)
    return out


def _close_uploader(recorder) -> None:
    """Let the Rdio uploader post what the finished calls queued before
    the process ends (the JAX CLI leaves its daemon worker to die with
    the process, dropping uploads still queued)."""
    if getattr(recorder, "uploader", None) is not None:
        recorder.uploader.close()


def _device(args):
    """The decode's device: the card unless ``--platform cpu``.  Prints
    why and returns None when the card is asked for and there is
    none."""
    import torch
    if args.platform == "cpu":
        return torch.device("cpu")
    from dsdneo_tpu_torch.device import require_cuda
    try:
        return require_cuda()
    except RuntimeError as e:
        print(f"dsd-neo-tpu: --platform {args.platform} needs the card: "
              f"{e}; pass --platform cpu to decode on the CPU",
              file=sys.stderr)
        return None


def main(argv: list[str] | None = None) -> int:
    import sys as _sys
    args = build_parser().parse_args(
        _prescan_argv(_sys.argv[1:] if argv is None else list(argv)))
    if args.list_devices:
        from dsdneo_tpu_torch.io.audio_out import list_audio_devices
        list_audio_devices()
        return 0
    if args.iq_info:
        from dsdneo_tpu_torch.io import read_iq_capture
        from dsdneo_tpu_torch.io.iq import read_iq_events
        try:
            meta, samples = read_iq_capture(args.iq_info)
        except (OSError, ValueError) as e:
            print(f"dsd-neo-tpu: cannot read {args.iq_info}: {e}",
                  file=sys.stderr)
            return 1
        print(f"format: {meta.sample_format}")
        print(f"sample_rate_hz: {meta.sample_rate_hz}")
        for name in ("center_freq_hz", "source", "created_utc", "notes"):
            v = getattr(meta, name, None)
            if v:
                print(f"{name}: {v}")
        print(f"samples: {len(samples)}")
        print(f"duration_s: {len(samples) / meta.sample_rate_hz:.3f}")
        for ev in read_iq_events(meta):
            # the JAX CLI reads IqEvent fields that do not exist here
            # (sample_index, fields) and raises on any journal
            print(f"event @{ev.byte_offset}: {ev.kind} "
                  f"center_frequency_hz={ev.center_frequency_hz}")
        return 0
    # reference short-flag aliases → canonical dests
    if args.frontend_terminal:
        args.frontend = "terminal"
    if args.modulation in ("q", "2", "3"):
        args.cqpsk = True              # -mq/-m2/-m3 lock the LSM chain
    if args.debug_mode:
        args.verbose = max(args.verbose, 2)
    if args.static_wav:
        args.audio_out = "wav:" + args.static_wav
        # reference openWavOutFile creates the file at startup, so a
        # data-only session still leaves a (silent) WAV behind
        from dsdneo_tpu_torch.io.audio_files import write_wav as _ww
        _ww(args.static_wav, np.zeros(0, dtype=np.float32), 8000)
    if args.percall_wav:
        args.calls_dir = args.calls_dir or args.percall_dir or "./WAV"
    if args.mbe_dir and not args.mbe_out:
        import time as _t
        os.makedirs(args.mbe_dir, exist_ok=True)
        ext = ".imb" if args.mode in ("p25p1", "provoice") else ".amb"
        args.mbe_out = os.path.join(
            args.mbe_dir, _t.strftime("mbe_%Y%m%d_%H%M%S") + ext)
    args.keys_dec = args.keys_dec or args.keys_dec_s
    args.keys_hex = args.keys_hex or args.keys_hex_s
    args.key_tyt16 = args.key_tyt16 or args.tyt16_key
    args.key_tyt_ap = args.key_tyt_ap or args.tyt_ap_key
    args.key_retevis = args.key_retevis or args.retevis_key
    args.key_tyt_ep = args.key_tyt_ep or args.tyt_ep_key
    args.sm_log = args.sm_log or args.sm_log_alias
    args.dmr_mono = args.analog_gain.strip() == "m"
    if args.profile and args.config and "@" not in args.config:
        args.config += "@" + args.profile
    if args.mbe_play:
        args.mbe_in = args.mbe_in or args.mbe_play[0]
    if not args.calc_lcn:
        # DSD_NEO_DMR_T3_CALC_CSV: env-driven calculator input
        # (reference oneshot_dmr_t3.c env fallback)
        args.calc_lcn = os.environ.get("DSD_NEO_DMR_T3_CALC_CSV", "")
    if args.calc_lcn:
        from dsdneo_tpu_torch.engine.lcn_calc import calc_dmr_t3_lcn
        ccf = args.calc_cc_freq
        cc_freq_hz = (round(ccf * 1e6) if 0 < ccf < 1e5 else round(ccf)) \
            if ccf > 0 else None
        return calc_dmr_t3_lcn(
            args.calc_lcn,
            step_hz=args.calc_step or None,
            cc_freq_hz=cc_freq_hz,
            cc_lcn=args.calc_cc_lcn or None,
            start_lcn=args.calc_start_lcn or None,
        )
    # reference mode-flag family: EDACS variants, DMR mono, trunk
    # helper, passive analog, M17 UDP (args.c:2125-2330)
    if args.edacs_variant and args.mode == "auto":
        args.mode = "edacs"
    if args.edacs_variant in ("ea", "ea_esk"):
        args.edacs_ea = True
    if args.edacs_variant in ("std_esk", "ea_esk") and not args.esk:
        args.esk = "A0"
    if args.dmr_mono_mode:
        args.mode = "dmr"
        args.analog_gain = args.analog_gain or "m"
    if args.trunk_helper:
        args.trunk = True
    if args.m17_udp_mode:
        args.mode = "m17"
        if not args.input:
            args.input = "m17udp"
    if args.analog_monitor:
        args.monitor_input = True
        # correlation scores are <=~1.0, so threshold 2.0 makes the
        # frame-sync hunt a no-op (reference -fA: not a hunt candidate)
        args.sync_threshold = 2.0
    if getattr(args, "tx_mode", None):
        return _run_m17_tx(args)
    # DSD_NEO_CONFIG names the INI to load when -c/--config was not
    # given; DSD_NEO_NO_BOOTSTRAP suppresses the wizard/INI bootstrap
    # chain entirely (embedders drive configuration themselves)
    from dsdneo_tpu_torch.runtime import config as _rtcfg0
    _env_cfg = _rtcfg0.load_env()
    if _env_cfg.no_bootstrap:
        args.wizard = False
        args.config = ""
    elif not args.config and _env_cfg.config_path:
        args.config = _env_cfg.config_path
    if args.platform == "tpu":
        print("dsd-neo-tpu: --platform tpu: this CLI runs on cuda or cpu",
              file=sys.stderr)
        return 2
    if args.mbe_in:
        device = _device(args)
        if device is None:
            return 1
        from dsdneo_tpu_torch.io.mbe_files import read_mbe_file, synthesize_mbe_file
        files = args.mbe_play or [args.mbe_in]
        pcms = []
        for path in files:
            try:
                kind, frames = read_mbe_file(path)
                pcm = synthesize_mbe_file(path, device=device)
            except (OSError, ValueError) as e:
                print(f"dsd-neo-tpu: cannot play {path}: {e}",
                      file=sys.stderr)
                return 1
            print(f"MBE file: {kind} {len(frames)} frames "
                  f"-> {len(pcm) / 8000.0:.2f} s", file=sys.stderr)
            pcms.append(pcm)
        if args.audio_out.startswith("wav:"):
            from dsdneo_tpu_torch.io.audio_files import write_wav
            write_wav(args.audio_out[4:], np.concatenate(pcms), 8000)
        return 0
    if args.wizard:
        from dsdneo_tpu_torch.runtime.wizard import run_wizard

        def ask(prompt, default):
            try:
                v = input(f"{prompt} [{default}]: ")
            except EOFError:
                return default
            return v or default

        w = run_wizard(ask, say=lambda ln: print(ln, file=sys.stderr))
        args.mode = w.mode
        args.iq_replay = args.iq_replay or w.iq_replay
        if w.audio_out != "null":
            args.audio_out = w.audio_out
        if w.stream_s > 0:
            args.stream = w.stream_s
    if not args.iq_replay and not args.input:
        print("dsd-neo-tpu: no input source (use --iq-replay or -i)",
              file=sys.stderr)
        return 2

    device = _device(args)
    if device is None:
        return 1

    from dsdneo_tpu_torch.runtime import config as rtcfg
    cfg = rtcfg.RuntimeConfig()
    if args.config:
        # "file.ini@profile" selects a [profile:<name>] section
        path, _, prof = args.config.partition("@")
        errs: list[str] = []
        cfg = rtcfg.load_ini(path, cfg, profile=prof, errors=errs)
        for e in errs:
            print(f"dsd-neo-tpu: config: {e}", file=sys.stderr)
    cfg = rtcfg.load_env(cfg)
    if args.no_cosine_filter:
        # -l: bypass the input channel low-pass (reference
        # opts->use_cosine_filter = 0)
        cfg = cfg.with_overrides(channel_lpf=False)
    rtcfg._config = cfg            # process-wide config for lazy readers
    if cfg.cqpsk and not args.cqpsk:
        args.cqpsk = True          # DSD_NEO_CQPSK forces the LSM chain
    if cfg.ftz_daz:
        # DSD_NEO_FTZ_DAZ: flush-to-zero/denormals-are-zero on the
        # decode thread's FPU (native MXCSR; no-op off x86)
        from dsdneo_tpu_torch.runtime.native import set_ftz_daz
        set_ftz_daz(True)
    if args.print_config:
        from dataclasses import fields as _dc_fields
        for fld in _dc_fields(cfg):
            print(f"{fld.name} = {getattr(cfg, fld.name)}")
        return 0
    frame_log = args.frame_log if args.frame_log is not None else cfg.frame_log
    perf_csv = args.perf_csv if args.perf_csv is not None else cfg.perf_csv
    # env-knob fallbacks for flags left at parser defaults (reference
    # DSD_NEO_* parity; every knob has the same consumer as its flag)
    if not args.enc_lockout:
        args.enc_lockout = cfg.enc_lockout
    if not args.auto_ppm:
        args.auto_ppm = cfg.auto_ppm
    if args.auto_ppm_snr == 9.0:
        args.auto_ppm_snr = cfg.auto_ppm_snr
    if args.input_volume == 1.0:
        args.input_volume = cfg.input_volume
    if args.input_level_warn_db == -200.0:
        args.input_level_warn_db = cfg.input_level_warn_db
    if args.trunk_scan_dwell_ms == 3000:
        args.trunk_scan_dwell_ms = cfg.trunk_scan_dwell_ms
    if args.trunk_scan_activity_hold_ms == 1200:
        args.trunk_scan_activity_hold_ms = cfg.trunk_scan_hold_ms
    if not args.rdio_api_url:
        args.rdio_api_url = cfg.rdio_api_url
        args.rdio_api_key = args.rdio_api_key or cfg.rdio_api_key
        args.rdio_system_id = args.rdio_system_id or cfg.rdio_system_id
    if args.p25_vc_grace == 1.5:
        args.p25_vc_grace = cfg.p25_vc_grace_s
    if args.p25_cc_grace == 5.0:
        args.p25_cc_grace = cfg.p25_cc_grace_s
    if args.iq_replay_rate == 0.0:
        args.iq_replay_rate = cfg.iq_replay_rate
    if not args.show_keys:
        args.show_keys = cfg.show_keys

    # sync warm-start calibration (reference sync_calibration.c /
    # DSD_NEO_SYNC_WARMSTART): adopt the learned threshold when the
    # user did not pass an explicit one
    sync_cal = None
    if cfg.sync_warmstart and cfg.sync_cal_path:
        from dsdneo_tpu_torch.runtime.calibration import SyncCalibration
        sync_cal = SyncCalibration(cfg.sync_cal_path)
        if args.sync_threshold == 0.62:
            args.sync_threshold = sync_cal.threshold_for(args.mode, 0.62)

    p2 = None
    if args.p2_params:
        v = args.p2_params
        if len(v) != 11:
            print("dsd-neo-tpu: -X needs 11 hex digits (WACN SYS NAC)",
                  file=sys.stderr)
            return 2
        p2 = (int(v[:5], 16), int(v[5:8], 16), int(v[8:], 16))

    keyring = None
    if args.keys_dec or args.keys_hex or args.keys_aes or args.rc4_key:
        from dsdneo_tpu_torch.crypto.keyring import KeyRing
        keyring = KeyRing()
        if args.keys_dec:
            keyring.import_dec_csv(args.keys_dec)
        if args.keys_hex:
            keyring.import_hex_csv(args.keys_hex)
        if args.keys_aes:
            keyring.import_aes_csv(args.keys_aes)
        if args.rc4_key:
            # -1: single RC4/DES key, forced over unmatched KIDs
            try:
                keyring.forced = int(args.rc4_key.replace(" ", ""), 16)
            except ValueError:
                print(f"dsd-neo-tpu: -1 expects hex ({args.rc4_key!r})",
                      file=sys.stderr)
                return 2
        # key summary (redacted unless --show-keys; reference behavior)
        print(keyring.describe(show_keys=args.show_keys), file=sys.stderr)

    recorder = None
    if args.calls_dir:
        from dsdneo_tpu_torch.core.calls import CallRecorder
        recorder = CallRecorder(args.calls_dir, mode=args.mode)
        if args.rdio_api_url:
            from dsdneo_tpu_torch.io.rdio import RdioUploader
            recorder.uploader = RdioUploader(
                args.rdio_api_url, args.rdio_api_key,
                args.rdio_system_id or "1")

    tg_policy = None
    if args.group_csv:
        from dsdneo_tpu_torch.core.talkgroup import TalkgroupPolicy
        tg_policy = TalkgroupPolicy()
        n = tg_policy.import_group_csv(args.group_csv)
        print(f"group list: {n} entries from {args.group_csv}",
              file=sys.stderr)
    if args.tg_hold or args.whitelist:
        if tg_policy is None:
            from dsdneo_tpu_torch.core.talkgroup import TalkgroupPolicy
            tg_policy = TalkgroupPolicy()
        tg_policy.whitelist_mode = bool(args.whitelist)
        if args.tg_hold:
            tg_policy.hold(0, args.tg_hold)
            tg_policy.hold(1, args.tg_hold)
    chan_map = None
    if args.chan_csv:
        from dsdneo_tpu_torch.engine.trunk import ChannelMap
        chan_map = ChannelMap()
        n = chan_map.import_csv(args.chan_csv)
        print(f"channel map: {n} entries from {args.chan_csv}",
              file=sys.stderr)

    mbe_sink = None
    if args.mbe_out:
        from dsdneo_tpu_torch.io.mbe_files import MbeFileWriter
        mbe_sink = MbeFileWriter(args.mbe_out)
    m17_udp = None
    if args.m17_udp:
        from dsdneo_tpu_torch.protocol.m17.ip import M17UdpOutput
        host, _, port = args.m17_udp.rpartition(":")
        m17_udp = M17UdpOutput(host or "127.0.0.1", int(port))

    if args.input:
        return _run_live(args, keyring, tg_policy, chan_map, recorder,
                         cfg=cfg, device=device)

    if args.wideband >= 0:
        from dsdneo_tpu_torch.engine.wideband import decode_wideband
        from dsdneo_tpu_torch.io import read_iq_capture
        try:
            meta, samples = read_iq_capture(args.iq_replay)
            results = decode_wideband(
                samples, float(meta.sample_rate_hz), mode=args.mode,
                n_ch=args.wideband or None,
                sync_threshold=args.sync_threshold, keyring=keyring,
                p2_params=p2, call_recorder=recorder, device=device)
        except (OSError, ValueError) as e:
            print(f"dsd-neo-tpu: wideband decode failed: {e}", file=sys.stderr)
            return 1
        for r in results:
            tag = f"[{r.freq_hz / 1e6:+.6f} MHz]"
            print(f"{tag} channel {r.index}: {len(r.ctx.events)} events, "
                  f"{r.power_db:+.1f} dB", file=sys.stderr)
            for ev in r.ctx.events:
                print(f"{tag} {ev.line}", file=sys.stderr)
            if frame_log:
                _write_frame_log(frame_log, r.ctx.events,
                                 as_json=cfg.pdu_json)
        if recorder is not None:
            recorder.finish_all()
            print(f"calls exported: {len(recorder.finished)} -> "
                  f"{args.calls_dir}", file=sys.stderr)
            _close_uploader(recorder)
        return 0

    if args.trunk_wideband:
        from dsdneo_tpu_torch.engine.fleettrunk import TrunkedFleet
        from dsdneo_tpu_torch.io import read_iq_capture
        try:
            meta, samples = read_iq_capture(args.iq_replay)
        except (OSError, ValueError) as e:
            print(f"dsd-neo-tpu: cannot replay {args.iq_replay}: {e}",
                  file=sys.stderr)
            return 1
        try:
            parts = args.trunk_wideband.split(":")
            cc_offs = [int(x) for x in parts[0].split(",")]
            n_vc = int(parts[1])
            tmode = parts[2] if len(parts) > 2 else "p25p1"
            n_p2 = int(parts[3]) if len(parts) > 3 else 0
        except (ValueError, IndexError):
            print("dsd-neo-tpu: bad --trunk-wideband spec (want "
                  "CCOFF[,CCOFF...]:N_VOICE[:MODE[:N_P2]])",
                  file=sys.stderr)
            return 2
        fs_band = float(meta.sample_rate_hz)
        try:
            fleet = TrunkedFleet(
                fs_band, cc_offs, n_vc,
                center_hz=float(meta.center_frequency_hz or 0.0),
                mode=tmode, cqpsk=bool(getattr(args, "cqpsk", False)),
                chan_map=chan_map, p2_rows=n_p2,
                # DSD_NEO_TRUNK_CC_DEVICE_PICK=0 reverts to the host
                # candidate pick (fleettrunk docstring; p25p1 only)
                cc_device_pick=(cfg.trunk_cc_device_pick
                                if cfg is not None else True),
                device=device)
        except ValueError as e:
            print(f"dsd-neo-tpu: {e}", file=sys.stderr)
            return 2
        from dsdneo_tpu_torch.io.audio_out import make_sink
        sink = make_sink(args.audio_out, float_audio=args.float_audio)
        B = int(fs_band)                      # 1 s device steps
        logged = 0
        # the conditioning's filter state, carried across the blocks of
        # the voice rows and of the Phase 2 slots
        vc_carry, p2_carry = {}, {}
        for i in range(0, len(samples), B):
            blk = samples[i:i + B]
            if blk.shape[0] < B // 4:
                break
            pcm = fleet.step(blk)
            for line in fleet.log[logged:]:
                print(line, file=sys.stderr)
            logged = len(fleet.log)
            # the block's rows conditioned in one call, each row's
            # filters carried on from its previous block (the JAX CLI
            # writes them raw; its serial branch alone conditions)
            if sink is not None and pcm.shape[1]:
                out = _condition_audio(pcm, cfg, device=device,
                                       carry=vc_carry)
                for row, call in fleet.calls.items():
                    if np.abs(pcm[row]).mean() > 1e-4:
                        sink.write(row & 1, out[row])
            if sink is not None and fleet.p2_pcm.shape[1]:
                out2 = _condition_audio(fleet.p2_pcm, cfg, device=device,
                                        carry=p2_carry)
                for (row, slot) in fleet.calls2:
                    p2 = fleet.p2_pcm[2 * row + slot]
                    if np.abs(p2).mean() > 1e-4:
                        sink.write(slot, out2[2 * row + slot])
        s = fleet.stats
        print(f"trunk-wideband: {s.grants} grants, "
              f"{s.grant_refreshes} refreshes, {s.releases} releases, "
              f"{s.unresolved} unresolved, {s.busy_drops} busy-drops "
              f"over {fleet.blocks} blocks", file=sys.stderr)
        if sink is not None:
            sink.close()
        return 0

    if args.fleet:
        from dsdneo_tpu_torch.engine.fleet import FleetMonitor
        from dsdneo_tpu_torch.io import read_iq_capture
        try:
            meta, samples = read_iq_capture(args.iq_replay)
        except (OSError, ValueError) as e:
            print(f"dsd-neo-tpu: cannot replay {args.iq_replay}: {e}",
                  file=sys.stderr)
            return 1
        fleet = FleetMonitor(fs=float(meta.sample_rate_hz), device=device)
        for part in args.fleet.split(","):
            bits = part.strip().split(":")
            if len(bits) != 3:
                print(f"dsd-neo-tpu: bad fleet group {part!r} "
                      "(want mode:kind:count)", file=sys.stderr)
                return 2
            fleet.assign(bits[0], int(bits[2]), kind=bits[1])
        iq1 = np.stack([samples.real, samples.imag],
                       axis=-1).astype(np.float32)
        block = np.broadcast_to(iq1[None],
                                (fleet.total_channels,) + iq1.shape).copy()
        if args.frontend == "http":
            # graphical fleet console: loop the replay block at
            # realtime pace, serve channel grid + events + calls over
            # the app_control HTTP frontend (reference Qt/QML shape)
            return _fleet_http_serve(args, fleet, block,
                                     float(meta.sample_rate_hz))
        fleet.decode_block(block)
        for g in fleet.groups:
            if g.kind == "voice":
                secs = (g.pcm.shape[1] / 8000.0 if g.pcm is not None
                        else 0.0)
                print(f"group {g.mode}/voice x{g.count}: "
                      f"{secs:.2f} s audio per channel", file=sys.stderr)
            else:
                n_ev = sum(len(g.pipeline.events(i))
                           for i in range(g.count))
                print(f"group {g.mode}/cc x{g.count}: {n_ev} events",
                      file=sys.stderr)
                for e in g.pipeline.events(0)[:10]:
                    print(e.line, file=sys.stderr)
        return 0

    if args.probe:
        # input probe: detected mode + SNR summary, then exit
        from dsdneo_tpu_torch.engine.decoder import detect_mode
        from dsdneo_tpu_torch.engine.stream import StreamDecoder
        from dsdneo_tpu_torch.io import read_iq_capture
        try:
            meta, samples = read_iq_capture(args.iq_replay)
        except (OSError, ValueError) as e:
            print(f"dsd-neo-tpu: cannot probe {args.iq_replay}: {e}",
                  file=sys.stderr)
            return 1
        mode = detect_mode(samples, float(meta.sample_rate_hz),
                           args.sync_threshold, device=device) \
            if args.mode == "auto" else args.mode
        name = mode if isinstance(mode, str) else mode.name
        sd = StreamDecoder(name, fs=float(meta.sample_rate_hz),
                           device=device)
        sd.push(samples)
        sd.flush()
        print(f"probe: mode={name} snr={sd.last_snr_db:.1f} dB "
              f"events={len(sd.ctx.events)} "
              f"duration={len(samples) / meta.sample_rate_hz:.2f} s")
        return 0

    from dsdneo_tpu_torch.engine.decoder import decode_capture
    from dsdneo_tpu_torch.runtime import trace
    perf = None
    if perf_csv:
        from dsdneo_tpu_torch.runtime.log import PerfProbe
        perf = PerfProbe(perf_csv, interval_s=cfg.perf_interval_ms / 1e3)
    # the decode's spans fill the probe's time columns
    trace.attach(perf)
    try:
        import time as _time
        if args.stream > 0:
            from dsdneo_tpu_torch.engine.stream import StreamDecoder
            from dsdneo_tpu_torch.io import read_iq_capture
            meta, samples = read_iq_capture(args.iq_replay)
            sd = StreamDecoder(args.mode, fs=float(meta.sample_rate_hz),
                               sync_threshold=args.sync_threshold,
                               device=device)
            sd.ctx.call_recorder = recorder
            sd.ctx.state.keyring = keyring
            for k, v in _state_attrs(args, tg_policy, chan_map).items():
                setattr(sd.ctx.state, k, v)
            if p2 is not None:
                (sd.ctx.state.p2_wacn, sd.ctx.state.p2_sysid,
                 sd.ctx.state.p2_cc) = p2
            if args.input_volume != 1.0:
                samples = samples * np.complex64(args.input_volume) \
                    if np.iscomplexobj(samples) else \
                    samples * np.float32(args.input_volume)
            chunk = max(int(meta.sample_rate_hz * args.stream), 4800)
            httpf = None
            if args.frontend == "http":
                # browser dashboard over the streamed replay; pacing
                # defaults to realtime so the view is watchable
                from dsdneo_tpu_torch.app_control.commands import CommandQueue
                from dsdneo_tpu_torch.app_control.http import HttpFrontend
                from dsdneo_tpu_torch.app_control.snapshot import MetricsHub
                hub, cq = MetricsHub(), CommandQueue()
                httpf = HttpFrontend(hub, cq,
                                     port=args.http_port).start()
                httpf.fs_sym = float(sd.mode.symbol_rate)
                print(f"http frontend: http://127.0.0.1:{httpf.port}/",
                      file=sys.stderr)
                if args.iq_replay_rate <= 0:
                    args.iq_replay_rate = 1.0
            n_blk = 0
            for _rep in range(max(args.iq_loop, 1)):
                for i in range(0, len(samples), chunk):
                    t0 = _time.perf_counter()
                    with trace.span("live.decode", i // chunk):
                        evs = sd.push(samples[i:i + chunk])
                    if perf is not None:
                        perf.add(channels=1, symbols=int(chunk / sd._sps))
                    if httpf is not None:
                        n_blk += 1
                        for e in evs:
                            httpf.push_decode_event(e)
                        extra = {}
                        if n_blk % 8 == 1:
                            z = samples[i:i + 4096]
                            if z.size >= 256:
                                sp = np.abs(np.fft.fftshift(np.fft.fft(z)))
                                extra["spectrum_db"] = (20.0 * np.log10(
                                    np.maximum(sp, 1e-9))
                                ).astype(np.float32)[::16]
                            soft = getattr(sd, "last_soft", None)
                            if soft is not None and len(soft):
                                extra["eye_symbols"] = np.asarray(
                                    soft[:512], np.float32)
                        hub.publish(stream_active=True, blocks=n_blk,
                                    snr_db=sd.last_snr_db,
                                    symbol_rate_hz=int(
                                        sd.mode.symbol_rate), **extra)
                    if args.iq_replay_rate > 0:
                        # paced replay (reference --iq-replay-rate)
                        want = chunk / meta.sample_rate_hz \
                            / args.iq_replay_rate
                        left = want - (_time.perf_counter() - t0)
                        if left > 0:
                            _time.sleep(left)
            sd.flush()
            if httpf is not None:
                httpf.stop()
            ctx = sd.ctx
        else:
            with trace.span("live.decode"):
                ctx = decode_capture(
                    args.iq_replay, args.mode,
                    sync_threshold=args.sync_threshold,
                    verbose=args.verbose, cqpsk=args.cqpsk, p2_params=p2,
                    call_recorder=recorder, keyring=keyring,
                    mbe_sink=mbe_sink, m17_udp=m17_udp,
                    state_attrs=_state_attrs(args, tg_policy, chan_map),
                    device=device)
            if perf is not None:
                perf.add(channels=1, symbols=0)
    except (OSError, ValueError) as e:
        print(f"dsd-neo-tpu: cannot replay {args.iq_replay}: {e}", file=sys.stderr)
        return 1
    finally:
        trace.detach(perf)
    if args.frontend == "terminal":
        from dsdneo_tpu_torch.ui.panes import history_from_events
        from dsdneo_tpu_torch.ui.terminal import UiModel, run
        audio_s = sum(len(c) for chunks in ctx.audio.values()
                      for c in chunks) / 8000.0
        drawn = run(UiModel(mode=args.mode, source=args.iq_replay,
                    n_events=len(ctx.events),
                    n_syncs=getattr(ctx, "n_syncs", 0),
                    audio_s=audio_s,
                    lines=[e.line for e in ctx.events],
                    soft=getattr(ctx, "debug_soft", None),
                    iq=getattr(ctx, "debug_iq", None),
                    history=history_from_events(ctx.events),
                    state=ctx.state, events=ctx.events))
        if not drawn:
            print(f"dsd-neo-tpu: {NO_TERMINAL}; nothing drawn",
                  file=sys.stderr)
    if recorder is not None:
        recorder.finish_all()
        print(f"calls exported: {len(recorder.finished)} -> {args.calls_dir}",
              file=sys.stderr)
        _close_uploader(recorder)
    for ev in ctx.events:
        print(ev.line, file=sys.stderr)
    if frame_log:
        _write_frame_log(frame_log, ctx.events, as_json=cfg.pdu_json)
    if args.event_log:
        # -J: event log (one line per decode event)
        with open(args.event_log, "a") as f:
            for ev in ctx.events:
                f.write(ev.line.rstrip("\n") + "\n")
    if args.lrrp_log:
        # -L: LRRP/GPS location lines only
        with open(args.lrrp_log, "a") as f:
            for ev in ctx.events:
                if "GPS" in ev.line or "LRRP" in ev.line:
                    f.write(f"{ev.pos}\t{ev.line.strip()}\n")
    if args.call_alert:
        for ev in ctx.events:
            if _call_alert_wants(ev):
                print("\a", end="", file=sys.stderr, flush=True)
                break
    if args.symbol_out:
        dib = getattr(ctx, "dibits", None)
        if dib is not None:
            from dsdneo_tpu_torch.io.symbol_capture import (soft_from_norm,
                                                      write_symbol_capture)
            cap = soft_from_norm(np.asarray(dib),
                                 np.asarray(ctx.debug_soft))
            write_symbol_capture(args.symbol_out, cap,
                                 soft=args.symbol_capture_format == "float")
            print(f"symbol capture: {len(cap.dibits)} dibits -> "
                  f"{args.symbol_out}", file=sys.stderr)
    if args.dsp_out:
        # -Q: float soft-symbol stream under ./DSP (reference layout)
        os.makedirs("./DSP", exist_ok=True)
        outp = os.path.join("./DSP", args.dsp_out)
        soft = getattr(ctx, "debug_soft", None)
        if soft is not None:
            np.asarray(soft, dtype="<f4").tofile(outp)
            print(f"DSP float stream: {len(soft)} samples -> {outp}",
                  file=sys.stderr)
    if args.raw_wav:
        from dsdneo_tpu_torch.io.audio_files import write_wav
        audio, rate = _demod_audio(args.iq_replay, device)
        write_wav(args.raw_wav, audio, rate)
        print(f"raw audio WAV: {len(audio)} samples @{rate} Hz -> "
              f"{args.raw_wav}", file=sys.stderr)
    if args.monitor_input and not ctx.events and args.audio_out != "null":
        # -8: analog source monitoring — no digital decode landed, so
        # pass the demodulated source audio through to the output
        audio, rate = _demod_audio(args.iq_replay, device)
        step = max(int(rate // 8000), 1)
        ga = 1.0
        if args.analog_gain not in ("", "m"):
            ga = max(0.0, min(float(args.analog_gain), 100.0)) / 50.0
        ctx.audio.setdefault(0, []).append(
            (audio[::step] * 0.5 * ga).astype(np.float32))
    if perf is not None:
        perf.close()
    if sync_cal is not None:
        sync_cal.record(args.mode, getattr(ctx, "sync_scores", []))
        sync_cal.save()
    if args.config and os.environ.get("DSD_NEO_CONFIG_AUTOSAVE", "") not in ("", "0"):
        rtcfg.save_ini(cfg.with_overrides(
            sync_threshold=args.sync_threshold), args.config)
    if mbe_sink is not None:
        mbe_sink.close()
        print(f"MBE out: {mbe_sink.frames} frames -> {args.mbe_out}",
              file=sys.stderr)
    if m17_udp is not None:
        print(f"M17 UDP: {m17_udp.sent} datagrams -> {args.m17_udp}",
              file=sys.stderr)
        m17_udp.close()

    if args.audio_out != "null":
        from dsdneo_tpu_torch.io.audio_out import make_sink
        sink = make_sink(args.audio_out, float_audio=args.float_audio)
        if sink is None:
            print(f"dsd-neo-tpu: unknown audio output {args.audio_out!r}",
                  file=sys.stderr)
            return 2
        slots = ctx.audio
        if (args.dmr_mono or args.slot_pref in (0, 1)) and len(slots) > 1:
            # -z / -nm mono output: keep the preferred slot only
            # (auto = the slot carrying the most audio)
            want = args.slot_pref if args.slot_pref in (0, 1) else None
            if want is None or not slots.get(want):
                want = max(slots, key=lambda k: sum(len(c)
                                                    for c in slots[k]))
            slots = {want: slots[want]}
        for slot, chunks in slots.items():
            if chunks:
                sink.write(slot, _condition_audio(np.concatenate(chunks),
                                                  cfg,
                                                  gain=args.digital_gain,
                                                  device=device))
        sink.close()
    return 0


def _demod_audio(iq_path: str, device) -> tuple["np.ndarray", int]:
    """FM-discriminate an I/Q capture into normalized demod audio at
    the capture rate, on ``device`` (the -6 raw source-audio tap;
    reference openWavOutFileRaw writes the same pre-decode stream)."""
    import torch

    from dsdneo_tpu_torch.dsp import frontend as _fe
    from dsdneo_tpu_torch.io import read_iq_capture
    meta, samples = read_iq_capture(iq_path)
    x = torch.from_numpy(np.asarray(samples, dtype=np.complex64)[None])
    d = _fe.fm_discriminate(x.to(device))[0].cpu().numpy()
    peak = float(np.max(np.abs(d))) or 1.0
    return (d / peak * 0.9).astype(np.float32), int(meta.sample_rate_hz)


def _condition_audio(pcm: "np.ndarray", cfg, gain: float = 0.0,
                     device=None, carry: dict | None = None
                     ) -> "np.ndarray":
    """Monitor-audio helpers on decoded 8 kHz PCM, ``[T]`` or
    ``[rows, T]`` (reference docs/cli.md:566-570: the -g fixed gain, the
    DSD_NEO_DEEMPH de-emphasis curve and the DSD_NEO_AUDIO_LPF one-pole
    cutoff; both filters off by default).  The filters run on a tensor
    on ``device`` through ``dsp.audio_filters.condition_audio``: on the
    card that is the one-pole kernel (K8), one launch for both.
    ``carry``, a dict the caller keeps across successive blocks of the
    same rows, holds the filters' state, so that the blocks come out as
    one call on their concatenation would."""
    import torch

    from dsdneo_tpu_torch.dsp.audio_filters import (DEEMPH_TAU_US,
                                                    condition_audio)
    deemph = cfg.deemph if cfg is not None else ""
    lpf = float(cfg.audio_lpf_hz) if cfg is not None else 0.0
    if deemph not in DEEMPH_TAU_US and lpf <= 0:
        if gain > 0:
            # -g fixed digital output gain (0..50, 25 = unity)
            pcm = np.asarray(pcm, dtype=np.float32) * (gain / 25.0)
        return pcm
    x = np.asarray(pcm, dtype=np.float32)
    t = torch.from_numpy(np.ascontiguousarray(x.reshape(-1, x.shape[-1])))
    t = t.to(device)
    state = None
    if carry is not None:
        state = carry.get("state")
        if state is None:
            state = carry["state"] = torch.zeros(
                (t.shape[0], 2), dtype=torch.float32, device=t.device)
    y = condition_audio(t, deemph=deemph, audio_lpf_hz=lpf, gain=gain,
                        state=state)
    return y.cpu().numpy().reshape(x.shape)


if __name__ == "__main__":
    raise SystemExit(main())
