"""The JAX package's own tests of the host modules the port copies, run
against the port's copies.

Every test of ``tests/test_events.py``, ``test_native_ring.py``,
``test_lcn_calc.py``, ``test_env_knobs_batch4.py``,
``test_env_knobs_batch6.py``, ``test_env_knobs_batch7.py``,
``test_audio_playback.py``, ``test_io.py``, ``test_app_control.py``,
``test_ui_panes.py``, ``test_m17_tx.py`` and ``test_http_frontend.py``
is loaded from its file with every name of the JAX package
(``dsdneo_tpu.``) pointed at the port (``dsdneo_tpu_torch.``) and run
with its fixtures: the same inputs, and the JAX test's own assertions,
on ``core/events``, the ingest ring, ``engine/lcn_calc``,
``runtime/config``, ``engine/trunk``, ``io/auto_ppm``, ``io/rtl_tcp``,
``runtime/rt_sched``, ``io/sdr_device`` (against the JAX test's
compiled librtlsdr stub), ``io/auto_gain``, ``io/audio_out``,
``io/audio_files``, ``io/symbol_capture``, ``io/net``,
``io/mbe_files``, ``io/serial_control`` (on a pty pair), ``io/rdio``
(against a local server), ``core/talkgroup``, ``app_control`` with its
HTTP frontend (on ports the OS picks), ``ui/menu``, ``ui/panes``,
``ui/terminal``'s views and ``protocol/m17/encoder``.
The JAX package's own run of the same tests is the rest of Tier-1.
The tests that need JAX arrays, an absent capture fixture, the JAX CLI,
a device-less ``LiveEngine`` or a module the port has not taken yet are
left out by name, each with its reason (``LEFT_OUT``).
"""

import importlib.util
import inspect
import os
import re
import sys
import types

import pytest

pytest.importorskip("jax")     # the card's machine has none (and the
                               # loaded files import pytest helpers only)

HERE = os.path.dirname(os.path.abspath(__file__))

# file -> the tests left out, each with why (every other test runs)
LEFT_OUT = {
    "test_events.py": set(),
    "test_native_ring.py": set(),
    "test_lcn_calc.py": set(),
    "test_env_knobs_batch6.py": {
        # its 50 ms receive timeout races the fake server's thread on a
        # loaded host (the JAX copy fails so too)
        "test_tcp_max_timeouts_gives_up"},
    "test_env_knobs_batch7.py": set(),
    "test_audio_playback.py": {
        # holds the upsampler to the JAX resampler on JAX arrays
        "test_streaming_upsampler_matches_one_shot"},
    "test_io.py": {
        # a capture fixture the repository lacks, through the JAX CLI
        "test_cli_group_policy_mutes_blocked_tg"},
    "test_app_control.py": {
        # LiveEngine without a device (the port's takes the card; its
        # command drain is held to the JAX engine in test_torch_live.py)
        "test_live_engine_commands_and_snapshots",
        "test_live_engine_drains_all_menu_commands"},
    "test_ui_panes.py": {
        # a capture fixture the repository lacks, through decode_samples
        "test_history_from_events_fixture",
        # LiveEngine without a device (held on the CPU engine in
        # test_torch_frontends.py)
        "test_run_live_headless"},
    "test_m17_tx.py": {
        # decode_samples without a device (the port's takes the card;
        # held on the CPU in test_torch_m17_tx.py)
        "test_m17_modulated_loopback"},
    "test_env_knobs_batch4.py": {
        # FleetMonitor without a device (the port's takes the card)
        "test_fleet_mt_pool"},
    "test_http_frontend.py": {
        # a capture fixture the repository lacks, through the CLI
        "test_fleet_http_console_cli", "test_stream_http_dashboard_cli"},
}


def _load(fname: str) -> types.ModuleType:
    """``tests/<fname>`` with the JAX package's names pointed at the
    port's, as a module of its own."""
    path = os.path.join(HERE, fname)
    with open(path) as f:
        src = f.read()
    src = re.sub(r"\bdsdneo_tpu\b(?!_torch)", "dsdneo_tpu_torch", src)
    name = "torch_copy_of_" + fname[:-3]
    mod = types.ModuleType(name)
    mod.__file__ = path
    sys.modules[name] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def _tests(fname: str):
    path = os.path.join(HERE, fname)
    with open(path) as f:
        names = re.findall(r"^def (test_\w+)\(", f.read(), re.M)
    assert LEFT_OUT[fname] <= set(names), LEFT_OUT[fname] - set(names)
    return [n for n in names if n not in LEFT_OUT[fname]]


def _params():
    out = []
    for fname in LEFT_OUT:
        for n in _tests(fname):
            out.append(pytest.param(fname, n, id=f"{fname[:-3]}::{n}"))
    return out


_MODS: dict = {}
_MOD_FIXTURES: dict = {}      # (file, name) -> value of a module fixture


def _arg(fname: str, mod, p: str, request):
    """A test's argument: a fixture the loaded file defines (its
    module-scoped, value-returning ones, computed once), else pytest's."""
    fx = getattr(mod, p, None)
    wrapped = getattr(fx, "_get_wrapped_function", None)
    if wrapped is None:
        return request.getfixturevalue(p)
    key = (fname, p)
    if key not in _MOD_FIXTURES:
        f = wrapped()
        _MOD_FIXTURES[key] = f(**{q: _arg(fname, mod, q, request)
                                  for q in inspect.signature(f).parameters})
    return _MOD_FIXTURES[key]


@pytest.mark.parametrize("fname,name", _params())
def test_jax_host_test_on_the_port(fname, name, request):
    if fname not in _MODS:
        _MODS[fname] = _load(fname)
    mod = _MODS[fname]
    fn = getattr(mod, name)
    fn(**{p: _arg(fname, mod, p, request)
          for p in inspect.signature(fn).parameters})
