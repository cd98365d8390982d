#!/usr/bin/env python3
"""Drive the PyTorch port's three voice paths once on one CUDA card.

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
    prediction recurrence).

Phases, in order; any failure exits non-zero:

  1. set-up: the card (name and power limit), no JAX and no module of
     the JAX package ``dsdneo_tpu`` in the process, the CUDA kernels
     built from ``dsdneo_tpu_torch/csrc``, the input blocks of the three
     paths: 320 distinct channels each (own leading offset and noise
     seed; on CQPSK also an own carrier offset within ±300 Hz) built
     from the test vectors in ``dsdneo_tpu_torch/data``;
  2. each kernel against its plain PyTorch version on the card, at the
     paths' shapes, with its time, its bound (the larger of bytes over
     3.35 TB/s and operations over the 67 TFLOP/s FP32 peak; for the
     recurrences K2 and K3 also the recurrence floor) and its share of
     that bound: K1 at [320, 144000] and at the DMR block [320, 141140],
     through the two stride-2 views the paths give it; K2 at [320, 162];
     K3 at [320, 25920] and at the DMR path's [320, 46080]; and the RRC
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
     the port's CPU path for channels 0-1.  Every path: PCM finite and
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
     own grids beside random ones.

The last lines of standard output are the card's name and power limit,
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
SPIN_CYCLES = 20_000_000     # ~10 ms: the card's lead over the host in cuda_ms
OURS = ("fir_disc", "imbe_pred", "adpcm_enc")   # kernel names in a profile


def log(*a) -> None:
    print(*a, flush=True)


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


def time_path(label: str, ident: str, pipe, blocks, block_s: float, pick):
    """The pipelined loop of the JAX package's bench over ``N_TIMED``
    blocks, the stage split of one block, and a profile of two blocks.
    ``pick(pipe, fe6)`` is the path's host picker.  Returns the step in
    seconds."""
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
    t1 = time.perf_counter()
    pipe.fetch_pcm(h)
    stages["PCM to host + expand"] = time.perf_counter() - t1
    log(f"{label} stages (ms): " + ", ".join(f"{k} {v * 1e3:.1f}"
                                            for k, v in stages.items()))

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
    from dsdneo_tpu_torch.dsp import cqpsk, firdes
    from dsdneo_tpu_torch.dsp.frontend import fir_complex
    from dsdneo_tpu_torch.engine import voicestate          # noqa: F401
    from dsdneo_tpu_torch.engine.dmrbatch import BatchedDmrVoicePipeline
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu_torch.ops import audio_wire, fir_discriminate as k1mod
    from dsdneo_tpu_torch.protocol.dmr import encode as dmr_encode
    from dsdneo_tpu_torch.protocol.p25 import encode
    from dsdneo_tpu_torch.symbols import timing             # noqa: F401
    from dsdneo_tpu_torch.vocoder import device as vdev

    t_start = time.perf_counter()
    dev = device.require_cuda()
    ident = device.card_identity().splitlines()[0]
    log(ident)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_count {torch.cuda.device_count()}")
    no_reference_modules()
    # full float32 for every matmul the paths take; the convolution of the
    # CQPSK path (fir_complex) switches cuDNN's TF32 off itself, and its
    # check in phase 2 runs with the process's switch on
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = kernels.build_info()
    log(f"kernels built in {info['seconds']:.2f} s -> "
        f"{os.path.relpath(info['path'], HERE)}")
    for line in info["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    t0 = time.perf_counter()
    tables = params.load(dev)
    tv = tables.test_vector()
    B = int(FS * BLOCK_S)
    n_sym = int(B // (FS / tables.symbol_rate)) - 2
    rng = np.random.default_rng(SEED)
    leads = rng.integers(30, len(tv["lead"]) + 1, size=C)
    seeds = rng.permutation(1 << 20)[:2 * C]
    blocks = [torch.as_tensor(encode.vector_block(tv, leads, seeds[i::2], B)
                              ).to(dev) for i in range(2)]
    want_ldus = np.array([encode.expected_ldus(tv, int(l), n_sym)
                          for l in leads])
    # CQPSK: the same vector, own carrier offset per channel; the
    # differential demodulator gives its first symbol up, so every sync
    # sits one dibit earlier
    cfo = rng.uniform(-CFO_MAX_HZ, CFO_MAX_HZ, size=C)
    q_blocks = [torch.as_tensor(encode.vector_block(
        tv, leads, seeds[i::2], B, modulation="cqpsk", cfo_hz=cfo)).to(dev)
        for i in range(2)]
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
    d_blocks = [torch.as_tensor(dmr_encode.vector_block(
        dtv, d_leads, d_seeds[i::2], d_B)).to(dev) for i in range(2)]
    d_want = [dmr_encode.expected_frames(dtv, int(l), d_n_sym)
              for l in d_leads]
    log(f"set-up {time.perf_counter() - t0:.1f} s: C={C}; P25 B={B} "
        f"({BLOCK_S} s) n_sym={n_sym}, LDUs per channel "
        f"{want_ldus.min()}..{want_ldus.max()} (CQPSK "
        f"{q_want_ldus.min()}..{q_want_ldus.max()}, carrier offsets "
        f"{cfo.min():.1f}..{cfo.max():.1f} Hz); DMR B={d_B} "
        f"({d_block_s:.4f} s) n_sym={d_n_sym}, superframes per channel "
        f"{min(len(w[0]) for w in d_want)}..{max(len(w[0]) for w in d_want)}")

    # -- 2. kernels against their plain versions ---------------------------
    report = {}
    clk = sm_clock_mhz()

    def show(name, err, k_ms, plain_ms, b_ms, b_by, extra="", shape=None):
        log(f"  {name}: kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / k_ms:.1f}% of "
            f"the bound{extra}")
        row = {"max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by}
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

    def check_k3(pcm, shape=None):
        """K3 on ``pcm`` against its plain version: bit-identical."""
        S, T = pcm.shape
        got = audio_wire.adpcm_compress(pcm, tables.adpcm_step,
                                        tables.adpcm_index)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        want = audio_wire.adpcm_compress_plain(pcm, tables.adpcm_step,
                                               tables.adpcm_index)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t1) * 1e3
        n_diff = int((got != want).sum())
        err = float((got.int() - want.int()).abs().max())
        k_ms = cuda_ms(lambda: audio_wire.adpcm_compress(
            pcm, tables.adpcm_step, tables.adpcm_index), 20)
        log(f"K3 adpcm_enc [{S},{T}] three-tone sinusoids: {n_diff} bytes "
            f"differ (tol 0: bit-identical)")
        if n_diff:
            raise RuntimeError("K3 is not bit-identical to its plain "
                               "version")
        b_ms, b_by = bound(nbytes(pcm, got), 0)
        k3_floor_ms = T * K3_CHAIN_CYCLES / (clk * 1e3)
        show("adpcm_enc", err, k_ms, plain_ms, b_ms, b_by,
             f"; recurrence floor ~{k3_floor_ms:.4f} ms ({T} samples x "
             f"{K3_CHAIN_CYCLES} cycles at {clk:.0f} MHz), "
             f"{100 * k3_floor_ms / k_ms:.1f}% of it", shape=shape)

    S, T = C, Tn * 160
    sines = three_tones(S, T)
    check_k3(sines)
    # the DMR path: 16 superframes x 18 frames = 288 steps (a multiple of
    # the 36-step bucket) of 160 samples
    d_T = 16 * 18 * 160
    check_k3(three_tones(C, d_T), shape=[C, d_T])

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

    # -- 3. the paths at C=320 ----------------------------------------------
    counted = (k1mod.fir_discriminate, vdev.prediction_scan,
               audio_wire.adpcm_compress)
    k1fn, k2fn, k3fn = counted
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
            label, counted, (k2fn, k3fn) if cqpsk_on else counted,
            (k1fn,) if cqpsk_on else ())
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
                                     (k2fn,))
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
    time_path("DMR path", ident,
              BatchedDmrVoicePipeline(C, FS, pcm_fmt="adpcm", tables=dtab),
              d_blocks, d_block_s,
              lambda p, fe6: p.pick_superframes(*fe6[1:]))
    log(f"whole run {time.perf_counter() - t_start:.1f} s after the build")

    rows = [("fir_disc", "dsdneo_tpu_torch/csrc/fir_disc.cu",
             "dsdneo_tpu/ops/pallas_frontend.py:123", "fir_discriminate"),
            ("imbe_pred", "dsdneo_tpu_torch/csrc/imbe_pred.cu",
             "dsdneo_tpu/vocoder/device.py:101", "prediction_scan"),
            ("adpcm_enc", "dsdneo_tpu_torch/csrc/adpcm_enc.cu",
             "dsdneo_tpu/ops/audio_wire.py:47", "adpcm_compress")]
    # no single PyTorch call computes any of the three functions.
    # "launches" sums the three paths' runs; "launches_by_path" splits it
    log(ident)
    log(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": sum(by[fn] for by in launches.values()),
         "launches_by_path": {p: by[fn] for p, by in launches.items()},
         **report[n], "library_ms": None}
        for n, src, rep, fn in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
