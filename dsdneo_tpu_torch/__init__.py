"""dsdneo_tpu_torch — the PyTorch and CUDA port of dsdneo_tpu.

The JAX package ``dsdneo_tpu`` is the reference; this package mirrors
its module names so each function's counterpart is easy to find:

  - ``device``            card checks and identity (name, power limit)
  - ``params``            the constant tables (``data/p25p1_tables.npz``)
                          and the per-channel carries, as tensors
  - ``dsp.frontend``      channel FIR, FM discriminator, power
  - ``ops``               the hand-written CUDA kernels' wrappers:
                          ``fir_discriminate`` (K1), ``audio_wire`` (K3)
  - ``engine.batched``    front end + symbol timing + slicing
  - ``engine.voicebatch`` ``BatchedP25VoicePipeline``: I/Q → PCM
  - ``fec.device``        batched IMBE voice-frame ECC
  - ``vocoder.device``    dequantization, prediction (K2), repeat gate
  - ``vocoder.synth``     batched harmonic synthesis
  - ``protocol.p25.encode`` the C4FM test-signal generator

It imports torch and numpy and never JAX; from the JAX package it uses
only the jax-free modules ``dsdneo_tpu.fec.blockcodes`` and
``dsdneo_tpu.runtime.native``.  Every function takes its tensors'
device from its inputs; CUDA kernels launch for CUDA tensors, their
plain PyTorch versions run for CPU tensors.
"""

__version__ = "0.1.0"
