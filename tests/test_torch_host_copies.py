"""The JAX package's own tests of the host modules the port copies, run
against the port's copies.

Every test of ``tests/test_events.py``, ``test_native_ring.py``,
``test_lcn_calc.py``, ``test_env_knobs_batch6.py``,
``test_env_knobs_batch7.py``, ``test_audio_playback.py``, ``test_io.py``
and ``test_app_control.py`` is loaded from its file with every name of
the JAX package (``dsdneo_tpu.``) pointed at the port
(``dsdneo_tpu_torch.``) and run with its fixtures: the same inputs, and
the JAX test's own assertions, on ``core/events``, the ingest ring,
``engine/lcn_calc``, ``io/rtl_tcp``, ``runtime/rt_sched``,
``io/sdr_device`` (against the JAX test's compiled librtlsdr stub),
``io/audio_out``, ``io/audio_files``, ``io/symbol_capture``,
``io/net``, ``io/mbe_files``, ``core/talkgroup`` and ``app_control``.
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
    "test_events.py": {
        # ui/panes is not ported (ROADMAP queue 1, item 5b)
        "test_history_adapter_enriches_alias_and_gps"},
    "test_native_ring.py": set(),
    "test_lcn_calc.py": set(),
    "test_env_knobs_batch6.py": {
        # its 50 ms receive timeout races the fake server's thread on a
        # loaded host (the JAX copy fails so too)
        "test_tcp_max_timeouts_gives_up"},
    "test_env_knobs_batch7.py": {
        # io/auto_gain is not ported (ROADMAP queue 1, item 6a)
        "test_autogain_seeds_then_backs_off_on_clipping",
        "test_autogain_steps_up_on_quiet_clean_signal",
        "test_autogain_gate_blocks_empty_channel",
        "test_autogain_retune_hold"},
    "test_audio_playback.py": {
        # holds the upsampler to the JAX resampler on JAX arrays
        "test_streaming_upsampler_matches_one_shot"},
    "test_io.py": {
        # a /root/reference fixture through the JAX CLI; io/serial_control
        # and io/rdio are not ported (ROADMAP queue 1, item 6a)
        "test_cli_group_policy_mutes_blocked_tg", "test_serial_control_pty",
        "test_rdio_uploader_multipart"},
    "test_app_control.py": {
        # LiveEngine without a device (the port's takes the card; its
        # command drain is held to the JAX engine in test_torch_live.py),
        # and ui/menu, not ported (ROADMAP queue 1, item 5b)
        "test_live_engine_commands_and_snapshots",
        "test_live_engine_drains_all_menu_commands",
        "test_menu_navigation_and_input_dispatch",
        "test_menu_mode_submenu_lists_all_modes"},
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
