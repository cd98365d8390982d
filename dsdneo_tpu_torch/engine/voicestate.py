"""The voice-carry lifecycle the batched AMBE pipelines share.

Counterpart of ``dsdneo_tpu/engine/voicestate.py``.  A pipeline keeps its
(synthesis, frame-repeat) carry on the device between blocks so a talker
who spans a block boundary is synthesized phase-continuously; a channel
row retuned to another call must not continue the previous talker, so
its rows are cleared.
"""

from __future__ import annotations

from dsdneo_tpu_torch.vocoder.device import voice_state_reset


class VoiceCarryMixin:
    """Adds ``reset_voice_state`` to pipelines that keep their (synthesis,
    repeat) carry in ``self._vstate``."""

    _vstate = None

    def reset_voice_state(self, channels=None) -> None:
        """Clear the carry: every row when ``channels`` is None, else
        only the given rows."""
        if channels is None or self._vstate is None:
            self._vstate = None
            return
        self._vstate = tuple(voice_state_reset(part, channels)
                             for part in self._vstate)
