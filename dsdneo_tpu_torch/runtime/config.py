"""Three-tier runtime configuration: CLI > environment > INI defaults.

Reference parity: the reference parses ~110 ``DSD_NEO_*`` env knobs once
into an immutable typed struct (include/dsd-neo/runtime/config.h:141,
src/runtime/config.cpp; documented docs/cli.md:311-658), layered under
CLI flags and over the INI user config (src/runtime/config_user.cpp,
docs/config-system.md).  This module mirrors that precedence with the
``DSDNEO_TPU_*`` prefix (the reference names are also accepted).

The port's own copy of ``dsdneo_tpu/runtime/config.py`` (pure Python),
unchanged in its logic: the same ``DSD_NEO_*`` / ``DSDNEO_TPU_*``
environment names set both packages alike.
"""

from __future__ import annotations

import configparser
import os
from dataclasses import dataclass, field, fields, replace
from typing import Optional


@dataclass(frozen=True)
class RuntimeConfig:
    # logging / observability
    log_level: str = "info"            # DSD_NEO_LOG_LEVEL
    log_sink: str = "stderr"           # DSD_NEO_LOG_SINK
    perf_csv: str = ""                 # DSD_NEO_RTL_PERF_CSV (path)
    perf_interval_ms: int = 1000       # DSD_NEO_RTL_PERF_CSV_INTERVAL_MS
    pdu_json: bool = False             # DSD_NEO_PDU_JSON
    frame_log: str = ""                # --frame-log path
    # decode behavior
    sync_threshold: float = 0.62
    sync_warmstart: bool = False       # DSD_NEO_SYNC_WARMSTART
    sync_cal_path: str = ""            # DSD_NEO_SYNC_CAL_PATH
    soft_erasure_threshold: int = 64   # DSD_NEO_P25_SOFT_ERASURE_THRESHOLD
    # trunking
    trunk_enable: bool = False
    trunk_hangtime_s: float = 1.0      # DSD_NEO_P25_VC_GRACE etc.
    p25_wd_ms: int = 250               # DSD_NEO_P25_WD_MS
    cc_cache_path: str = ""            # DSD_NEO_P25_CC_CACHE
    # device / batching
    platform: str = "cpu"              # the JAX CLI's --platform
    channels: int = 1
    block_s: float = 1.0
    # audio
    audio_gain: float = 0.0            # 0 = auto
    audio_out_rate: int = 8000
    # round-3 live/trunking surface (each mirrors a CLI flag consumer)
    enc_lockout: bool = False          # DSD_NEO_ENC_LOCKOUT
    auto_ppm: bool = False             # DSD_NEO_AUTO_PPM
    auto_ppm_snr: float = 9.0          # DSD_NEO_AUTO_PPM_SNR
    input_volume: float = 1.0          # DSD_NEO_INPUT_VOLUME
    input_level_warn_db: float = -200.0  # DSD_NEO_INPUT_LEVEL_WARN_DB
    trunk_scan_dwell_ms: int = 3000    # DSD_NEO_TRUNK_SCAN_DWELL_MS
    trunk_scan_hold_ms: int = 1200     # DSD_NEO_TRUNK_SCAN_ACTIVITY_HOLD_MS
    rdio_api_url: str = ""             # DSD_NEO_RDIO_API_URL
    rdio_api_key: str = ""             # DSD_NEO_RDIO_API_KEY
    rdio_system_id: str = ""           # DSD_NEO_RDIO_SYSTEM_ID
    p25_vc_grace_s: float = 1.5        # DSD_NEO_P25_VC_GRACE
    p25_cc_grace_s: float = 5.0        # DSD_NEO_P25_CC_GRACE
    iq_replay_rate: float = 0.0        # DSD_NEO_IQ_REPLAY_RATE
    show_keys: bool = False            # DSD_NEO_SHOW_KEYS
    retune_mute_ms: float = 75.0       # DSD_NEO_RETUNE_MUTE_MS
    squelch_hop_s: float = 0.5         # DSD_NEO_SQUELCH_HOP_S
    snr_sql_db: float = -200.0         # DSD_NEO_SNR_SQL_DB
    p25_hangtime_s: float = 0.0        # DSD_NEO_P25_HANGTIME (0=use -t)
    dmr_hangtime_s: float = 0.0        # DSD_NEO_DMR_HANGTIME
    auto_ppm_freeze: bool = False      # DSD_NEO_AUTO_PPM_FREEZE
    iq_dc_block: bool = False          # DSD_NEO_IQ_DC_BLOCK
    rtl_agc: bool = False              # DSD_NEO_RTL_AGC
    tuner_bw_hz: int = 0               # DSD_NEO_TUNER_BW_HZ
    # reference-name parity batch 4 (docs/cli.md:493-658), each with a
    # consumer: runtime/bootstrap, auto-PPM gates, P25/DMR trunk SM
    # timers, soft-decision thresholds, preemption policy
    config_path: str = ""              # DSD_NEO_CONFIG (INI path)
    cache_dir: str = ""                # DSD_NEO_CACHE_DIR
    cc_cache_enable: bool = True       # DSD_NEO_CC_CACHE (0 disables load)
    no_bootstrap: bool = False         # DSD_NEO_NO_BOOTSTRAP
    no_signal_handlers: bool = False   # DSD_NEO_NO_SIGNAL_HANDLERS
    mt: bool = False                   # DSD_NEO_MT (light worker pool)
    ftz_daz: bool = False              # DSD_NEO_FTZ_DAZ (native FTZ/DAZ)
    window_freeze: bool = False        # DSD_NEO_WINDOW_FREEZE
    auto_ppm_pwr_db: float = -80.0     # DSD_NEO_AUTO_PPM_PWR_DB
    auto_ppm_zerolock_ppm: float = 0.6   # DSD_NEO_AUTO_PPM_ZEROLOCK_PPM
    auto_ppm_zerolock_hz: float = 60.0   # DSD_NEO_AUTO_PPM_ZEROLOCK_HZ
    p25_grant_timeout_s: float = 0.0   # DSD_NEO_P25_GRANT_TIMEOUT (0=off)
    p25_grant_voice_to_s: float = 0.0  # DSD_NEO_P25_GRANT_VOICE_TO
    p25_min_follow_dwell_s: float = 0.0  # DSD_NEO_P25_MIN_FOLLOW_DWELL
    p25_mac_hold_s: float = 0.0        # DSD_NEO_P25_MAC_HOLD
    p25_ring_hold_s: float = 0.0       # DSD_NEO_P25_RING_HOLD
    p25_voice_hold_s: float = 0.0      # DSD_NEO_P25_VOICE_HOLD
    p25_force_release_extra_s: float = 0.0   # DSD_NEO_P25_FORCE_RELEASE_EXTRA
    p25_force_release_margin_s: float = 0.0  # DSD_NEO_P25_FORCE_RELEASE_MARGIN
    p25p1_err_hold_pct: float = 0.0    # DSD_NEO_P25P1_ERR_HOLD_PCT
    p25p1_err_hold_s: float = 0.0      # DSD_NEO_P25P1_ERR_HOLD_S
    dmr_grant_timeout_s: float = 0.0   # DSD_NEO_DMR_GRANT_TIMEOUT
    tg_preempt_min_dwell_ms: int = 750   # DSD_NEO_TG_PREEMPT_MIN_DWELL_MS
    tg_preempt_cooldown_ms: int = 1000   # DSD_NEO_TG_PREEMPT_COOLDOWN_MS
    p25_afc_status_gate: bool = False  # DSD_NEO_P25_AFC_STATUS_GATE
    p25p1_soft_erasure_threshold: int = 0   # 0 = inherit shared threshold
    p25p2_soft_erasure_threshold: int = 0   # DSD_NEO_P25P2_SOFT_ERASURE_...
    p25_soft_hard_override: bool = True  # DSD_NEO_P25_SOFT_HARD_OVERRIDE
    # batch 5: DSP helpers / capture-retune / rigctl / T3 heuristics
    deemph: str = "off"                # DSD_NEO_DEEMPH (off|50|75|nfm)
    audio_lpf_hz: int = 0              # DSD_NEO_AUDIO_LPF (0/off = bypass)
    channel_lpf: bool = True           # DSD_NEO_CHANNEL_LPF
    resamp_hz: int = 48000             # DSD_NEO_RESAMP (0/off = native)
    costas_bw: float = 0.0             # DSD_NEO_COSTAS_BW (0 = full range)
    costas_damping: float = 0.0        # DSD_NEO_COSTAS_DAMPING
    ted_gain: float = 1.0              # DSD_NEO_TED_GAIN
    cfo_windows: int = 0               # DSD_NEO_CFO_WINDOWS (0 = auto)
    call_alert_events: str = ""        # DSD_NEO_CALL_ALERT_EVENTS
    #   comma list of start/end/data; empty = all (reference -a chooser)
    cqpsk: bool = False                # DSD_NEO_CQPSK (force CQPSK demod)
    cqpsk_sync_inv: bool = False       # DSD_NEO_CQPSK_SYNC_INV
    cqpsk_sync_neg: bool = False       # DSD_NEO_CQPSK_SYNC_NEG
    debug_sync: bool = False           # DSD_NEO_DEBUG_SYNC
    debug_cqpsk: bool = False          # DSD_NEO_DEBUG_CQPSK
    disable_fs4_shift: bool = False    # DSD_NEO_DISABLE_FS4_SHIFT
    combine_rot: bool = True           # DSD_NEO_COMBINE_ROT
    # DSD_NEO_TRUNK_CC_DEVICE_PICK: fixed-capacity device TSDU pick in
    # the wideband trunked fleet (one d2h exchange per block; see
    # engine.fleettrunk.TrunkedFleet) — default ON for p25p1 C4FM
    trunk_cc_device_pick: bool = True
    iq_dc_shift: int = 0               # DSD_NEO_IQ_DC_SHIFT (one-pole k)
    retune_drain_ms: float = 0.0       # DSD_NEO_RETUNE_DRAIN_MS
    output_clear_on_retune: bool = False   # DSD_NEO_OUTPUT_CLEAR_ON_RETUNE
    rigctl_rcvtimeo_ms: int = 2000     # DSD_NEO_RIGCTL_RCVTIMEO
    tcpin_backoff_ms: int = 0          # DSD_NEO_TCPIN_BACKOFF_MS
    dmr_t3_heur: bool = False          # DSD_NEO_DMR_T3_HEUR
    # batch 6: rtl_tcp link tuning (reference docs/cli.md:562-571)
    tcp_prebuf_ms: int = 1000          # DSD_NEO_TCP_PREBUF_MS (5-1000)
    tcp_rcvbuf: int = 4 << 20          # DSD_NEO_TCP_RCVBUF (SO_RCVBUF)
    tcp_bufsz: int = 16384             # DSD_NEO_TCP_BUFSZ (read size)
    tcp_rcvtimeo_ms: int = 2000        # DSD_NEO_TCP_RCVTIMEO
    tcp_waitall: bool = False          # DSD_NEO_TCP_WAITALL (full reads)
    tcp_stats: bool = False            # DSD_NEO_TCP_STATS
    tcp_autotune: bool = False         # DSD_NEO_TCP_AUTOTUNE
    tcp_max_timeouts: int = 0          # DSD_NEO_TCP_MAX_TIMEOUTS (0 = ∞)
    # batch 7: librtlsdr options + tuner autogain
    # (reference docs/cli.md:573-592, rtl_sdr_fm.cpp demod_autogain_*)
    rtl_direct: int = 0                # DSD_NEO_RTL_DIRECT (0|1|2|I|Q)
    rtl_offset_tuning: bool = True     # DSD_NEO_RTL_OFFSET_TUNING
    rtl_xtal_hz: int = 0               # DSD_NEO_RTL_XTAL_HZ (0 = stock)
    tuner_xtal_hz: int = 0             # DSD_NEO_TUNER_XTAL_HZ
    rtl_if_gains: str = ""             # DSD_NEO_RTL_IF_GAINS stage:gain,...
    rtl_testmode: bool = False         # DSD_NEO_RTL_TESTMODE (ramp source)
    rtl_verify: bool = False           # DSD_NEO_RTL_VERIFY (read-back check)
    rtl_verify_attempts: int = 1       # DSD_NEO_RTL_VERIFY_ATTEMPTS (1-10)
    tuner_autogain: bool = False       # DSD_NEO_TUNER_AUTOGAIN
    tuner_autogain_probe_ms: int = 3000      # ..._PROBE_MS
    tuner_autogain_seed_db: float = 30.0     # ..._SEED_DB
    tuner_autogain_spec_snr_db: float = 6.0  # ..._SPEC_SNR_DB
    tuner_autogain_inband_ratio: float = 0.60  # ..._INBAND_RATIO
    tuner_autogain_up_step_db: float = 3.0   # ..._UP_STEP_DB
    tuner_autogain_up_persist: int = 2       # ..._UP_PERSIST

    def with_overrides(self, **kw) -> "RuntimeConfig":
        kw = {k: v for k, v in kw.items() if v is not None}
        return replace(self, **kw)


def _env_bool(v: str) -> bool:
    """Shared boolean converter for DSD_NEO_* env values —
    case-insensitive like the INI tier ('False', 'OFF', 'no' are
    false, not truthy)."""
    return v.strip().lower() not in ("0", "", "false", "no", "off")


_ENV_MAP = {
    "LOG_LEVEL": ("log_level", str),
    "LOG_SINK": ("log_sink", str),
    "RTL_PERF_CSV": ("perf_csv", str),
    "RTL_PERF_CSV_INTERVAL_MS": ("perf_interval_ms", int),
    "PDU_JSON": ("pdu_json", _env_bool),
    "SYNC_THRESHOLD": ("sync_threshold", float),
    "SYNC_WARMSTART": ("sync_warmstart", _env_bool),
    "SYNC_CAL_PATH": ("sync_cal_path", str),
    "TRUNK_ENABLE": ("trunk_enable", _env_bool),
    "TRUNK_HANGTIME_S": ("trunk_hangtime_s", float),
    "P25_WD_MS": ("p25_wd_ms", int),
    "P25_CC_CACHE": ("cc_cache_path", str),
    "PLATFORM": ("platform", str),
    "CHANNELS": ("channels", int),
    "AUDIO_GAIN": ("audio_gain", float),
    "ENC_LOCKOUT": ("enc_lockout", _env_bool),
    "AUTO_PPM": ("auto_ppm", _env_bool),
    "AUTO_PPM_SNR": ("auto_ppm_snr", float),
    "INPUT_VOLUME": ("input_volume", float),
    "INPUT_LEVEL_WARN_DB": ("input_level_warn_db", float),
    "TRUNK_SCAN_DWELL_MS": ("trunk_scan_dwell_ms", int),
    "TRUNK_SCAN_ACTIVITY_HOLD_MS": ("trunk_scan_hold_ms", int),
    "RDIO_API_URL": ("rdio_api_url", str),
    "RDIO_API_KEY": ("rdio_api_key", str),
    "RDIO_SYSTEM_ID": ("rdio_system_id", str),
    "P25_VC_GRACE": ("p25_vc_grace_s", float),
    "P25_CC_GRACE": ("p25_cc_grace_s", float),
    "IQ_REPLAY_RATE": ("iq_replay_rate", float),
    "SHOW_KEYS": ("show_keys", _env_bool),
    "RETUNE_MUTE_MS": ("retune_mute_ms", float),
    "SQUELCH_HOP_S": ("squelch_hop_s", float),
    "SNR_SQL_DB": ("snr_sql_db", float),
    "P25_HANGTIME": ("p25_hangtime_s", float),
    "DMR_HANGTIME": ("dmr_hangtime_s", float),
    "AUTO_PPM_FREEZE": ("auto_ppm_freeze",
                        _env_bool),
    "AUTO_PPM_SNR_DB": ("auto_ppm_snr", float),
    "IQ_DC_BLOCK": ("iq_dc_block", _env_bool),
    "RTL_AGC": ("rtl_agc", _env_bool),
    "TUNER_BW_HZ": ("tuner_bw_hz", int),
    # reference-name parity batch 4 (the names in docs/cli.md:493-658)
    "CONFIG": ("config_path", str),
    "CACHE_DIR": ("cache_dir", str),
    "CC_CACHE": ("cc_cache_enable", lambda v: v not in ("0", "false")),
    "NO_BOOTSTRAP": ("no_bootstrap", _env_bool),
    "NO_SIGNAL_HANDLERS": ("no_signal_handlers",
                           _env_bool),
    "MT": ("mt", _env_bool),
    "FTZ_DAZ": ("ftz_daz", _env_bool),
    "WINDOW_FREEZE": ("window_freeze", _env_bool),
    "AUTO_PPM_PWR_DB": ("auto_ppm_pwr_db", float),
    "AUTO_PPM_ZEROLOCK_PPM": ("auto_ppm_zerolock_ppm", float),
    "AUTO_PPM_ZEROLOCK_HZ": ("auto_ppm_zerolock_hz", float),
    "INPUT_WARN_DB": ("input_level_warn_db", float),
    "P25_GRANT_TIMEOUT": ("p25_grant_timeout_s", float),
    "P25_GRANT_VOICE_TO": ("p25_grant_voice_to_s", float),
    "P25_MIN_FOLLOW_DWELL": ("p25_min_follow_dwell_s", float),
    "P25_MAC_HOLD": ("p25_mac_hold_s", float),
    "P25_RING_HOLD": ("p25_ring_hold_s", float),
    "P25_VOICE_HOLD": ("p25_voice_hold_s", float),
    "P25_FORCE_RELEASE_EXTRA": ("p25_force_release_extra_s", float),
    "P25_FORCE_RELEASE_MARGIN": ("p25_force_release_margin_s", float),
    "P25P1_ERR_HOLD_PCT": ("p25p1_err_hold_pct", float),
    "P25P1_ERR_HOLD_S": ("p25p1_err_hold_s", float),
    "DMR_GRANT_TIMEOUT": ("dmr_grant_timeout_s", float),
    "TG_PREEMPT_MIN_DWELL_MS": ("tg_preempt_min_dwell_ms", int),
    "TG_PREEMPT_COOLDOWN_MS": ("tg_preempt_cooldown_ms", int),
    "P25_AFC_STATUS_GATE": ("p25_afc_status_gate",
                            _env_bool),
    "P25_SOFT_ERASURE_THRESHOLD": ("soft_erasure_threshold", int),
    "P25P1_SOFT_ERASURE_THRESHOLD": ("p25p1_soft_erasure_threshold", int),
    "P25P2_SOFT_ERASURE_THRESHOLD": ("p25p2_soft_erasure_threshold", int),
    "P25_SOFT_HARD_OVERRIDE": ("p25_soft_hard_override",
                               lambda v: v not in ("0", "false")),
    # batch 5
    "DEEMPH": ("deemph", str),
    "AUDIO_LPF": ("audio_lpf_hz",
                  lambda v: 0 if v.lower() in ("off", "") else int(v)),
    "CHANNEL_LPF": ("channel_lpf", lambda v: v not in ("0", "false")),
    "RESAMP": ("resamp_hz",
               lambda v: 0 if v.lower() in ("off", "") else int(v)),
    "COSTAS_BW": ("costas_bw", float),
    "COSTAS_DAMPING": ("costas_damping", float),
    "TED_GAIN": ("ted_gain", float),
    "CFO_WINDOWS": ("cfo_windows", int),
    "CALL_ALERT_EVENTS": ("call_alert_events", str),
    "CQPSK": ("cqpsk", _env_bool),
    "CQPSK_SYNC_INV": ("cqpsk_sync_inv",
                       _env_bool),
    "CQPSK_SYNC_NEG": ("cqpsk_sync_neg",
                       _env_bool),
    "DEBUG_SYNC": ("debug_sync", _env_bool),
    "DEBUG_CQPSK": ("debug_cqpsk", _env_bool),
    "DISABLE_FS4_SHIFT": ("disable_fs4_shift",
                          _env_bool),
    "COMBINE_ROT": ("combine_rot", lambda v: v not in ("0", "false")),
    "TRUNK_CC_DEVICE_PICK": ("trunk_cc_device_pick",
                             lambda v: v not in ("0", "false")),
    "IQ_DC_SHIFT": ("iq_dc_shift", int),
    "RETUNE_DRAIN_MS": ("retune_drain_ms", float),
    "OUTPUT_CLEAR_ON_RETUNE": ("output_clear_on_retune",
                               _env_bool),
    "RIGCTL_RCVTIMEO": ("rigctl_rcvtimeo_ms", int),
    "TCPIN_BACKOFF_MS": ("tcpin_backoff_ms", int),
    "DMR_T3_HEUR": ("dmr_t3_heur", _env_bool),
    # batch 6
    "TCP_PREBUF_MS": ("tcp_prebuf_ms",
                      lambda v: max(5, min(1000, int(v)))),
    "TCP_RCVBUF": ("tcp_rcvbuf", int),
    "TCP_BUFSZ": ("tcp_bufsz", int),
    "TCP_RCVTIMEO": ("tcp_rcvtimeo_ms", int),
    "TCP_WAITALL": ("tcp_waitall", _env_bool),
    "TCP_STATS": ("tcp_stats", _env_bool),
    "TCP_AUTOTUNE": ("tcp_autotune", _env_bool),
    "TCP_MAX_TIMEOUTS": ("tcp_max_timeouts", int),
    # batch 7
    "RTL_DIRECT": ("rtl_direct",
                   lambda v: {"i": 1, "q": 2}.get(v.lower(),
                                                  None) if v.isalpha()
                   else int(v)),
    "RTL_OFFSET_TUNING": ("rtl_offset_tuning",
                          lambda v: v not in ("0", "false")),
    "RTL_XTAL_HZ": ("rtl_xtal_hz", int),
    "TUNER_XTAL_HZ": ("tuner_xtal_hz", int),
    "RTL_IF_GAINS": ("rtl_if_gains", str),
    "RTL_TESTMODE": ("rtl_testmode", _env_bool),
    "RTL_VERIFY": ("rtl_verify", _env_bool),
    "RTL_VERIFY_ATTEMPTS": ("rtl_verify_attempts",
                            lambda v: max(1, min(10, int(v)))),
    "TUNER_AUTOGAIN": ("tuner_autogain",
                       _env_bool),
    "TUNER_AUTOGAIN_PROBE_MS": ("tuner_autogain_probe_ms", int),
    "TUNER_AUTOGAIN_SEED_DB": ("tuner_autogain_seed_db", float),
    "TUNER_AUTOGAIN_SPEC_SNR_DB": ("tuner_autogain_spec_snr_db", float),
    "TUNER_AUTOGAIN_INBAND_RATIO": ("tuner_autogain_inband_ratio", float),
    "TUNER_AUTOGAIN_UP_STEP_DB": ("tuner_autogain_up_step_db", float),
    "TUNER_AUTOGAIN_UP_PERSIST": ("tuner_autogain_up_persist", int),
}

_PREFIXES = ("DSDNEO_TPU_", "DSD_NEO_")

_config: Optional[RuntimeConfig] = None


def load_env(base: RuntimeConfig | None = None,
             environ: dict | None = None) -> RuntimeConfig:
    env = environ if environ is not None else os.environ
    cfg = base or RuntimeConfig()
    overrides = {}
    for key, (attr, conv) in _ENV_MAP.items():
        for prefix in _PREFIXES:
            raw = env.get(prefix + key)
            if raw is not None:
                try:
                    overrides[attr] = conv(raw)
                except (TypeError, ValueError):
                    pass
                break
    return cfg.with_overrides(**overrides)


def load_ini(path: str, base: RuntimeConfig | None = None,
             profile: str = "",
             errors: list[str] | None = None,
             _seen: frozenset | None = None) -> RuntimeConfig:
    """INI user config (``[dsdneo]`` section, keys = field names).
    Supports ``include = other.ini`` chains and named
    ``[profile:<name>]`` sections layered over the base section,
    like the reference's profile/include system
    (docs/config-system.md).  Validation problems (unknown keys,
    unparsable values, missing profiles) are appended to ``errors``
    when given."""
    cfg = base or RuntimeConfig()
    errs = errors if errors is not None else []
    rp = os.path.realpath(path)
    seen = _seen or frozenset()
    if rp in seen:
        errs.append(f"{path}: include cycle")
        return cfg
    seen = seen | {rp}
    cp = configparser.ConfigParser()
    read = cp.read(path)
    if not read:
        errs.append(f"{path}: unreadable")
        return cfg
    sec = cp["dsdneo"] if cp.has_section("dsdneo") else cp["DEFAULT"]
    inc = sec.get("include", "")
    if inc:
        inc_path = os.path.join(os.path.dirname(path), inc)
        cfg = load_ini(inc_path, cfg, errors=errs, _seen=seen)

    def apply(section, cfg):
        overrides = {}
        valid = {f.name: f.type for f in fields(RuntimeConfig)}
        for key, raw in section.items():
            if key == "include":
                continue
            if key not in valid:
                errs.append(f"{path}: unknown key '{key}'")
                continue
            cur = getattr(cfg, key)
            try:
                if isinstance(cur, bool):
                    overrides[key] = raw.lower() in ("1", "true", "yes",
                                                     "on")
                elif isinstance(cur, int):
                    overrides[key] = int(raw)
                elif isinstance(cur, float):
                    overrides[key] = float(raw)
                else:
                    overrides[key] = raw
            except ValueError:
                errs.append(f"{path}: bad value for '{key}': {raw!r}")
                continue
        return cfg.with_overrides(**overrides)

    cfg = apply(sec, cfg)
    if profile:
        pname = f"profile:{profile}"
        if cp.has_section(pname):
            cfg = apply(cp[pname], cfg)
        else:
            errs.append(f"{path}: no such profile '{profile}'")
    return cfg


def validate_ini(path: str, profile: str = "") -> list[str]:
    """Schema check of an INI file; returns human-readable problems
    (reference config validation, docs/config-system.md)."""
    errors: list[str] = []
    load_ini(path, profile=profile, errors=errors)
    return errors


def bootstrap(ini_path: str | None = None, **cli_overrides) -> RuntimeConfig:
    """Full precedence chain: defaults < INI < env < CLI.  The result is
    cached as the process-wide immutable config (reference
    dsd_runtime_bootstrap, src/runtime/bootstrap/bootstrap.c:716)."""
    global _config
    cfg = RuntimeConfig()
    if ini_path:
        cfg = load_ini(ini_path, cfg)
    cfg = load_env(cfg)
    cfg = cfg.with_overrides(**cli_overrides)
    _config = cfg
    return cfg


def get() -> RuntimeConfig:
    global _config
    if _config is None:
        _config = load_env()
    return _config


def save_ini(cfg: RuntimeConfig, path: str) -> None:
    """INI autosave (reference engine.c:2604 config autosave on exit)."""
    cp = configparser.ConfigParser()
    cp["dsdneo"] = {f.name: str(getattr(cfg, f.name))
                    for f in fields(RuntimeConfig)}
    with open(path, "w") as f:
        cp.write(f)
