"""The sharded steps of ``parallel/mesh.py`` in the PyTorch port at world
sizes 1 and 2 (spawned gloo ranks on the CPU) against the JAX steps on
a two-device mesh, on the signals of ``test_torch_mesh_bodies.py`` (C=4
channels) and the trunked bands of ``tests/test_trunkmesh.py`` (S=2
systems).

  - World size 2 equals world size 1 bit for bit in every valid
    candidate's blob, every mask, meta, dibit and P25 PCM row; the AMBE
    paths' PCM bit for bit on rank 0's rows (the synthesis noise phase
    follows a row's index in its shard, in the JAX steps too), the
    analog rows within 1e-6 of the peak; the fleet CRC-ok count is
    exact; the fleet power, a mean of the ranks' means, within 1e-6
    relative of world size 1's and of JAX's.
  - Against JAX: blobs, valid masks, meta and dibits bit for bit; soft
    symbols within 1e-5; PCM within the bounds of
    ``test_torch_mesh_bodies.py``; the trunk step in p25p1 (on its
    band) and nxdn96 (on noise), ``test_torch_trunkmesh.py``'s fleets
    holding it in the other four modes.
  - ``dryrun_multichip(2, device="cpu")`` runs every step with its
    checks; a world size that does not divide C or S raises; a rank that
    fails fails the run; no card and no ``device="cpu"`` raises, and so
    does NCCL on the CPU.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")     # the card's machine has none

from dsdneo_tpu_torch.parallel import dist as pdist  # noqa: E402
from dsdneo_tpu_torch.parallel import mesh as PM  # noqa: E402

C = 4
S = 2
FS = 48000.0
TRUNK_FS = 192000.0
TRUNK_B = 96000                 # 0.5 s of band per system
# the trunk modes held to the JAX step here; test_torch_trunkmesh.py holds
# the sharded fleet, and so the trunk step, to JAX in the other four
JAX_TRUNK = ("p25p1", "nxdn96")


# -- the rank side (no JAX) ---------------------------------------------------
def run_steps(mesh, sig: dict, trunk: dict) -> dict | None:
    """Every step once on this rank's rows; outputs gathered in rank
    order (rank 0 returns them)."""
    g = lambda t: pdist.gather_rows(mesh, t)   # noqa: E731
    out = {}
    fe, shard = PM.make_sharded_frontend(mesh, "p25p1", C, 48000)
    d, s, p, fleet = fe(shard(sig["p25_voice"]))
    out["frontend"] = (g(d), g(s), g(p), float(fleet))
    st, shard = PM.make_sharded_voice_step(mesh, C, 48000, max_ldus=4)
    pcm, fleet = st(shard(sig["p25_voice"]))
    out["voice"] = (g(pcm), float(fleet))
    st, shard = PM.make_sharded_dmr_voice_step(mesh, C, 57600)
    pcm, fleet = st(shard(sig["dmr_voice"]))
    out["dmr_voice"] = (g(pcm), float(fleet))
    st, shard = PM.make_sharded_p2_voice_step(mesh, C, 57600, max_frames=8)
    pcm, fleet = st(shard(sig["p2_voice"]))
    out["p2_voice"] = (g(pcm), float(fleet))
    st, shard = PM.make_sharded_p25_cc_step(mesh, C, 48000, max_tsdus=8)
    blob, valid, ok = st(shard(sig["p25_cc"]))
    out["p25_cc"] = (g(blob), g(valid), int(ok))
    for mode, (kw, wide, offs) in trunk.items():
        st, (ws, os_) = PM.make_sharded_trunk_step(mesh, S, **kw)
        blob, valid, meta, pcm, ok = st(ws(wide), os_(offs))
        out[f"trunk_{mode}"] = (g(blob), g(valid), g(meta), g(pcm), int(ok))
    return out if mesh.rank == 0 else None


def fail_on_rank_one(mesh):
    if mesh.rank == 1:
        raise RuntimeError("rank one fails")
    return mesh.rank


# -- inputs and the JAX side --------------------------------------------------
@pytest.fixture(scope="module")
def inputs():
    import test_torch_mesh_bodies as TB
    import test_trunkmesh as T
    sig = {"p25_voice": TB.channels(TB.p25_voice, 48000, 10),
           "dmr_voice": TB.channels(TB.dmr_voice, 57600, 20),
           "p2_voice": TB.channels(TB.p2_voice, 57600, 80),
           "p25_cc": TB.channels(TB.p25_cc, 48000, 90)}
    n = TRUNK_B
    p25 = np.stack([T._build_system(101, seed=10)[:n],
                    T._build_system(202, seed=20)[:n]])
    dmr = np.stack([T._build_dmr_system(101, 24, seed=30)[:n]] * 2)
    edacs = np.stack([T._build_edacs_system()[:n]] * 2)
    mixed = np.stack([T._build_mixed_system()[:n]] * 2)
    rng = np.random.default_rng(0)
    noise = (rng.normal(size=(S, n, 2)) * 0.3).astype(np.float32)
    cc_vc = np.array([[T.CC_OFF, T.VC_OFF, T.CC_OFF]] * S, np.int32)
    mixed_offs = np.array([[T.CC_OFF, T.VC_OFF_P2, T.CC_OFF]] * S,
                          np.int32)
    kw = dict(fs=TRUNK_FS, B=n, n_cc=1, n_vc=2, max_tsdus=4, max_ldus=4)
    planes = TB.planes
    trunk = {"p25p1": (kw, planes(p25), cc_vc),
             "dmr": (dict(kw, trunk_mode="dmr", max_tsdus=8), planes(dmr),
                     cc_vc),
             "nxdn48": (dict(kw, trunk_mode="nxdn48"), noise, cc_vc),
             "nxdn96": (dict(kw, trunk_mode="nxdn96"), noise, cc_vc),
             "edacs": (dict(kw, trunk_mode="edacs", max_tsdus=8),
                       planes(edacs), cc_vc),
             "p25_mixed": (dict(kw, trunk_mode="p25_mixed",
                                p2_params=(T.WACN_M, T.SYSID_M, T.NAC_M)),
                           planes(mixed), mixed_offs)}
    return sig, trunk


@pytest.fixture(scope="module")
def ranks(inputs):
    sig, trunk = inputs
    one = pdist.spawn(run_steps, 1, sig, trunk, device="cpu")[0]
    two = pdist.spawn(run_steps, 2, sig, trunk, device="cpu")[0]
    return one, two


@pytest.fixture(scope="module")
def jax_out(inputs):
    import jax
    from jax.sharding import Mesh
    from dsdneo_tpu.parallel import mesh as JM
    sig, trunk = inputs
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("ch",))
    put = lambda a, sh: jax.device_put(a, sh)   # noqa: E731
    arr = lambda xs: tuple(np.asarray(x) for x in xs)  # noqa: E731
    out = {}
    st, sh = JM.make_sharded_frontend(mesh, "p25p1", C, 48000)
    out["frontend"] = arr(st(put(sig["p25_voice"], sh)))
    st, sh = JM.make_sharded_voice_step(mesh, C, 48000, max_ldus=4)
    out["voice"] = arr(st(put(sig["p25_voice"], sh)))
    st, sh = JM.make_sharded_dmr_voice_step(mesh, C, 57600)
    out["dmr_voice"] = arr(st(put(sig["dmr_voice"], sh)))
    st, sh = JM.make_sharded_p2_voice_step(mesh, C, 57600, max_frames=8)
    out["p2_voice"] = arr(st(put(sig["p2_voice"], sh)))
    st, sh = JM.make_sharded_p25_cc_step(mesh, C, 48000, max_tsdus=8)
    out["p25_cc"] = arr(st(put(sig["p25_cc"], sh)))
    smesh = Mesh(np.array(jax.devices()[:2]), axis_names=("sys",))
    for mode in JAX_TRUNK:
        kw, wide, offs = trunk[mode]
        st, (ws, os_) = JM.make_sharded_trunk_step(smesh, S, **kw)
        out[f"trunk_{mode}"] = arr(st(put(wide, ws), put(offs, os_)))
    return out


def _pcm(a, b, rel):
    a = np.asarray(a, np.float32)
    peak = float(np.abs(a).max())
    assert a.shape == b.shape and np.isfinite(b).all()
    if peak == 0:
        assert not np.abs(b).any()
        return
    np.testing.assert_allclose(b, a, atol=rel * peak, rtol=2.0 ** -10)


# -- world 1 against world 2 --------------------------------------------------
STEPS = ["frontend", "voice", "dmr_voice", "p2_voice", "p25_cc"] + [
    f"trunk_{m}" for m in PM.TRUNK_MODES]


# the AMBE synthesizers' noise phase is a function of a row's index in
# its shard (``vocoder/device.noise_phases``, as the JAX package builds
# it), so their unvoiced bands differ between world sizes on the rows
# whose local index changes (rank 1's); the JAX steps on one and two
# devices differ on the same rows by the same amounts.  The analog rows'
# convolution rounds by batch size on the CPU.  An invalid candidate's
# blob decodes the drop row's gather (the shard's last channel, as in
# JAX), so the blobs are compared on the valid candidates.
SHARD_NOISE = {"dmr_voice", "p2_voice", "trunk_dmr", "trunk_nxdn48",
               "trunk_nxdn96", "trunk_p25_mixed"}


@pytest.mark.parametrize("name", STEPS)
def test_world_two_equals_world_one(ranks, name):
    one, two = ranks
    pcm_at = {"voice": 0, "dmr_voice": 0, "p2_voice": 0}.get(
        name, 3 if name.startswith("trunk_") else None)
    blob_at = 0 if name == "p25_cc" or name.startswith("trunk_") else None
    for i, (a, b) in enumerate(zip(one[name], two[name])):
        if i == blob_at:
            valid = one[name][1]
            np.testing.assert_array_equal(two[name][1], valid)
            np.testing.assert_array_equal(b[valid], a[valid])
        elif isinstance(a, float):
            assert b == pytest.approx(a, rel=1e-6)
        elif isinstance(a, int):
            assert a == b
        elif i == pcm_at and name in SHARD_NOISE:
            half = a.shape[0] // 2              # rank 0's rows
            np.testing.assert_array_equal(b[:half], a[:half])
        elif i == pcm_at and name == "trunk_edacs":
            np.testing.assert_allclose(b, a, rtol=0,
                                       atol=1e-6 * np.abs(a).max())
        else:
            np.testing.assert_array_equal(b, a)


# -- world 2 against the JAX mesh ---------------------------------------------
@pytest.mark.parametrize("name", ["frontend", "voice", "dmr_voice",
                                  "p2_voice"])
def test_channel_steps_against_jax(ranks, jax_out, name):
    _one, two = ranks
    j, p = jax_out[name], two[name]
    assert p[-1] == pytest.approx(float(j[-1]), rel=1e-6)  # fleet power
    if name == "frontend":
        np.testing.assert_array_equal(p[0], j[0])
        np.testing.assert_allclose(p[1], j[1], atol=1e-5)
        np.testing.assert_allclose(p[2], j[2], rtol=1e-6)
        return
    _pcm(j[0], p[0], 2e-3 if name == "voice" else 2e-4)
    assert (np.abs(p[0]).max(axis=1) > 1e-3).all()


def test_p25_cc_step_against_jax(ranks, jax_out):
    _one, two = ranks
    j, p = jax_out["p25_cc"], two["p25_cc"]
    np.testing.assert_array_equal(p[0], j[0])
    np.testing.assert_array_equal(p[1], j[1])
    assert p[2] == int(j[2]) and p[2] >= 3 * C * 2


@pytest.mark.parametrize("mode", JAX_TRUNK)
def test_trunk_step_against_jax(ranks, jax_out, mode):
    _one, two = ranks
    j, p = jax_out[f"trunk_{mode}"], two[f"trunk_{mode}"]
    for a, b in zip(j[:3], p[:3]):
        np.testing.assert_array_equal(b, a)
    assert p[4] == int(j[4])
    _pcm(j[3], p[3], 2e-3 if mode == "p25p1" else 2e-4)
    if mode not in ("nxdn48", "nxdn96"):       # noise bands decode nothing
        assert p[4] > 0 and np.abs(p[3][:, 0]).max() > 1e-3


# -- the multi-chip dry run and the refusals ----------------------------------
def test_dryrun_multichip_on_two_cpu_ranks():
    out = PM.dryrun_multichip(2, device="cpu")
    assert len(out) == 2
    for r in out:
        assert r["pcm_shapes"] == [[4, 2880], [4, 5760], [8, 2560],
                                   [1, 2, 1440]]
        assert np.isfinite(r["frontend_power"]) and r["cc_ok"] >= 0
    # the fleet metrics are the same on every rank
    assert out[0]["frontend_power"] == out[1]["frontend_power"]
    assert out[0]["cc_ok"] == out[1]["cc_ok"]


@pytest.mark.parametrize("world", [3])
def test_world_that_does_not_divide_raises(world):
    mesh = pdist.Mesh(None, world, 0, torch.device("cpu"), "gloo")
    for make in (lambda: PM.make_sharded_voice_step(mesh, C, 4800),
                 lambda: PM.make_sharded_dmr_voice_step(mesh, C, 4800),
                 lambda: PM.make_sharded_p2_voice_step(mesh, C, 4800),
                 lambda: PM.make_sharded_p25_cc_step(mesh, C, 4800),
                 lambda: PM.make_sharded_frontend(mesh, "p25p1", C, 4800),
                 lambda: PM.make_sharded_trunk_step(mesh, S, TRUNK_FS,
                                                    19200)):
        with pytest.raises(ValueError, match="must divide the mesh"):
            make()


def test_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        pdist.spawn(fail_on_rank_one, 2, device="cpu")


def test_no_card_no_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PM.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pdist.init_mesh(0, 1, "tcp://127.0.0.1:1")
    with pytest.raises(ValueError, match="NCCL runs on CUDA"):
        pdist.spawn(fail_on_rank_one, 1, device="cpu", backend="nccl")
