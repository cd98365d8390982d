"""The sharded steps and ``ShardedTrunkedFleet`` on the card: one rank on
``cuda:0`` under NCCL against one rank on the CPU under gloo, and two
ranks sharing ``cuda:0`` under gloo against the NCCL rank.

  - the P25 voice, DMR voice and P25 CC steps at C=8 on the vectors of
    ``data/p25p1_tables.npz``, ``dmr_tables.npz`` and ``cc_tables.npz``
    (each channel its own lead and noise);
  - the P25 trunk step and the sharded fleet on two systems of
    ``engine/fleetvec.system_band`` (768 kHz, 1 s blocks);
  - ``dryrun_multichip(1)``, and more ranks than cards refused.

Held: picks, valid blobs, masks, offsets, log and stats equal; PCM within
2e-3 of its peak between the card and the CPU, and within one float16
step of the peak (2^-10) on rank 0's rows between two gloo ranks and one
NCCL rank: the synthesizers' noise phase follows a row's index in its
shard, and the card's float32 products round by batch size before the
float16 wire (1.05e-4 of the peak at C=8 on the card).  Every test needs a card
(``cuda`` marker) and none imports JAX:
``python -m pytest --noconftest -q -m cuda tests/test_torch_mesh_card.py``.
"""

import numpy as np
import pytest
import torch

from dsdneo_tpu_torch import params
from dsdneo_tpu_torch.engine import fleetvec as FV
from dsdneo_tpu_torch.parallel import dist as pdist
from dsdneo_tpu_torch.parallel import mesh as PM
from dsdneo_tpu_torch.protocol.dmr import encode as dmr_encode
from dsdneo_tpu_torch.protocol.p25 import encode as p25_encode

pytestmark = pytest.mark.cuda
C = 8
S = 2


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _inputs() -> dict:
    rng = np.random.default_rng(21)
    tv = params.load("cpu").test_vector()
    leads = rng.integers(30, len(tv["lead"]) + 1, size=C)
    voice = p25_encode.vector_block(tv, leads, rng.permutation(1 << 20)[:C],
                                    48000)
    dtv = params.load_dmr("cpu").test_vector()
    dmr = dmr_encode.vector_block(dtv, rng.integers(0, 97, size=C),
                                  rng.permutation(1 << 20)[:C], 57600)
    ctv = params.load_cc("p25", "cpu").test_vector()
    cc = dmr_encode.vector_block(
        ctv, rng.integers(0, 97, size=C), rng.permutation(1 << 20)[:C],
        48000, sps=10, modulate=lambda d, s: p25_encode.c4fm_clean(d, s),
        lead_dibits=ctv.get("lead"))
    tvf = FV.vector()
    cc_off, vc_off = FV.system_offsets(tvf, "p25p1")
    bands = torch.stack([FV.cu8_planes(FV.system_band(tvf, "p25p1", 11 * s,
                                                      7 + s))
                         for s in range(S)]).numpy()
    return {"voice": voice, "dmr_voice": dmr, "p25_cc": cc, "bands": bands,
            "offs": np.array([[cc_off, vc_off, cc_off]] * S, np.int32)}


def run_rank(mesh, x: dict) -> dict | None:
    """The steps and the fleet on this rank's rows, gathered (rank 0
    returns them)."""
    from dsdneo_tpu_torch.parallel.trunkfleet import ShardedTrunkedFleet
    g = lambda t: pdist.gather_rows(mesh, t)   # noqa: E731
    out = {}
    for name, make, kw in (
            ("voice", PM.make_sharded_voice_step, {"max_ldus": 8}),
            ("dmr_voice", PM.make_sharded_dmr_voice_step, {"max_sf": 8}),
            ("p25_cc", PM.make_sharded_p25_cc_step, {"max_tsdus": 16})):
        st, shard = make(mesh, C, x[name].shape[1], **kw)
        res = st(shard(x[name]))
        picks = getattr(st.body, "picks", None)
        out[name] = ([g(r) for r in res[:-1]], float(res[-1]),
                     None if picks is None else g(picks))
    nb = int(FV.MODE_FS)
    st, (ws, os_) = PM.make_sharded_trunk_step(mesh, S, FV.MODE_FS, nb, 1, 2)
    res = st(ws(x["bands"][:, :nb]), os_(x["offs"]))
    out["trunk"] = ([g(r) for r in res[:4]], int(res[4]), None)
    cc_off, _vc = FV.system_offsets(FV.vector(), "p25p1")
    f = ShardedTrunkedFleet(mesh, S, FV.MODE_FS, nb, [cc_off] * S, 2,
                            centers_hz=FV.BENCH_CENTER, hangtime_s=0.6,
                            grant_grace_s=0.5)
    pcm = [g(f.step(x["bands"][:, i * nb:(i + 1) * nb])) for i in range(2)]
    out["fleet"] = (pcm, f.gather())
    return out if mesh.rank == 0 else None


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():     # before the autouse check runs
        pytest.skip("needs a CUDA device")
    x = _inputs()
    return {"nccl": pdist.spawn(run_rank, 1, x)[0],
            "cpu": pdist.spawn(run_rank, 1, x, device="cpu")[0],
            "gloo2": pdist.spawn(run_rank, 2, x, device="cuda:0",
                                 backend="gloo")[0]}


def _rel(a, b):
    peak = float(np.abs(b).max())
    return float(np.abs(a - b).max()) / peak if peak else float(
        np.abs(a).max())


@pytest.mark.parametrize("other, pcm_tol, half", [("cpu", 2e-3, False),
                                                  ("gloo2", 2.0 ** -10, True)])
def test_steps_against_the_nccl_rank(runs, other, pcm_tol, half):
    a, b = runs["nccl"], runs[other]
    for name in ("voice", "dmr_voice", "p25_cc", "trunk"):
        (xa, ma, pa), (xb, mb, pb) = a[name], b[name]
        assert (pa is None) == (pb is None)
        if pa is not None:
            np.testing.assert_array_equal(pb, pa)
        assert mb == pytest.approx(ma, rel=1e-6)
        if name in ("p25_cc", "trunk"):
            np.testing.assert_array_equal(xb[1], xa[1])
            np.testing.assert_array_equal(xb[0][xa[1]], xa[0][xa[1]])
        if name == "trunk":
            np.testing.assert_array_equal(xb[2], xa[2])
        if name != "p25_cc":
            p_a, p_b = xa[-1], xb[-1]
            rows = p_a.shape[0] // 2 if half else p_a.shape[0]
            assert np.abs(p_a).max() > 1e-3
            assert _rel(p_b[:rows], p_a[:rows]) <= pcm_tol


@pytest.mark.parametrize("other, pcm_tol", [("cpu", 2e-3),
                                            ("gloo2", 2.0 ** -10)])
def test_sharded_fleet_against_the_nccl_rank(runs, other, pcm_tol):
    (pa, va), (pb, vb) = runs["nccl"]["fleet"], runs[other]["fleet"]
    assert vb.log == va.log and vb.stats == va.stats
    assert vb.offs.tolist() == va.offs.tolist() and vb.rows == va.rows
    assert va.stats.grants == S
    for x, y in zip(pb, pa):
        rows = 1 if other == "gloo2" else S      # rank 0's system
        if np.abs(y).max():
            assert _rel(x[:rows], y[:rows]) <= pcm_tol


def test_dryrun_multichip_on_the_card():
    out = PM.dryrun_multichip(1)
    assert out[0]["pcm_shapes"] == [[8, 2880], [8, 5760], [16, 2560],
                                    [1, 2, 1440]]


def test_more_ranks_than_cards_refused():
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="ranks need"):
        PM.dryrun_multichip(n)
