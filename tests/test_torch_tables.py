"""The PyTorch port's constant tables and its independence from JAX.

The checked-in ``dsdneo_tpu_torch/data/p25p1_tables.npz`` must equal
what ``tools/export_torch_tables.py`` builds from the JAX package now
(exact), and importing the port must never load JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

PORT_MODULES = (
    "dsdneo_tpu_torch", "dsdneo_tpu_torch.device", "dsdneo_tpu_torch.params",
    "dsdneo_tpu_torch.kernels", "dsdneo_tpu_torch.dsp.frontend",
    "dsdneo_tpu_torch.ops.fir_discriminate",
    "dsdneo_tpu_torch.ops.audio_wire", "dsdneo_tpu_torch.engine.batched",
    "dsdneo_tpu_torch.engine.voicebatch", "dsdneo_tpu_torch.fec.device",
    "dsdneo_tpu_torch.vocoder.device", "dsdneo_tpu_torch.vocoder.synth",
    "dsdneo_tpu_torch.protocol.p25.encode")


@pytest.fixture(scope="module")
def exported():
    from export_torch_tables import build_tables
    return build_tables()


@pytest.fixture(scope="module")
def stored():
    from dsdneo_tpu_torch.params import TABLES_NPZ
    with np.load(TABLES_NPZ) as z:
        return {k: z[k] for k in z.files}


def test_npz_has_every_exported_array(exported, stored):
    assert sorted(exported) == sorted(stored)


@pytest.mark.parametrize("group", ["front", "ecc", "dequant", "scalars",
                                   "wire_synth", "vector"])
def test_npz_equals_exporter(exported, stored, group):
    prefix = {"front": ("taps", "symbol_rate", "four_level", "sync_"),
              "ecc": ("ecc_", "golay_", "h15_"),
              "dequant": ("dq_",),
              "scalars": ("gain_", "b0_", "voicing_", "pred_", "imbe_",
                          "tone_"),
              "wire_synth": ("adpcm_", "synth_"),
              "vector": ("tv_",)}[group]
    keys = [k for k in exported if k.startswith(prefix)]
    assert keys
    for k in keys:
        a, b = np.asarray(exported[k]), np.asarray(stored[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_port_never_imports_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in PORT_MODULES)
            + "assert 'jax' not in sys.modules, sorted(m for m in "
              "sys.modules if m.startswith('jax'))\n"
              "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_from_numpy_of_jax_arrays_equals_loaded(exported):
    """The tables built straight from the JAX package and the npz give
    the port the same tensors."""
    from dsdneo_tpu_torch import params
    a = params.from_numpy(exported, "cpu")
    b = params.load("cpu")
    for name, v in vars(a).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, getattr(b, name)), name
    # the NID codebook the port builds is the JAX pipeline's
    from dsdneo_tpu.engine.voicebatch import BatchedP25VoicePipeline
    pm = BatchedP25VoicePipeline(1).bch.pm
    np.testing.assert_array_equal(a.bch_pm.numpy(), pm)


def test_state_from_numpy_layout():
    from dsdneo_tpu_torch import params
    C = 3
    pred = (np.ones((C, 56), np.float32), np.full(C, 9, np.int32))
    synth = (np.zeros(C, np.float32), np.zeros(C, np.float32),
             np.zeros((C, 56), np.float32))
    rep = (np.zeros(C, np.float32), np.zeros((C, 56), np.float32),
           np.zeros((C, 56), np.float32), np.zeros(C, np.int32),
           np.zeros(C, np.float32))
    p, s, r = params.state_from_numpy(pred, synth, rep, "cpu")
    assert p[0].dtype == torch.float32 and p[1].dtype == torch.int32
    assert [t.shape for t in s] == [(C,), (C,), (C, 56)]
    assert r[3].dtype == torch.int32 and r[4].dtype == torch.float32
    assert params.state_from_numpy(pred, synth, None, "cpu")[2] is None
