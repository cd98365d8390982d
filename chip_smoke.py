#!/usr/bin/env python3
"""Drive the PyTorch port's P25p1 voice main path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. set-up: the card (name and power limit), no JAX and no module of
     the JAX package ``dsdneo_tpu`` in the process, the CUDA kernels
     built from ``dsdneo_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (C=320 channels, 3 s blocks), with its time,
     its bound (the larger of bytes over 3.35 TB/s and operations over
     the 67 TFLOP/s FP32 peak; for the recurrences K2 and K3 also the
     recurrence floor) and its share of that bound; K1 reads the
     interleaved block through two stride-2 views, as the main path
     does;
  3. the main path, ``BatchedP25VoicePipeline(320)`` for ``pcm_fmt``
     f16 and adpcm over two consecutive blocks with the carry kept:
     320 distinct channels (own noise seed and leading offset each) built
     from the test vector in ``dsdneo_tpu_torch/data/p25p1_tables.npz``;
     every channel must accept every LDU and decode the vector's IMBE
     bits, the PCM must be finite and non-silent, and channels 0-1 must
     agree with the port's plain CPU path on the same input; every
     kernel's launch counter must have risen;
  4. timing: K3 on the main path's own PCM (the f16 output of phase 3,
     scaled and clipped as the wire encoder takes it) beside its time on
     three-tone sinusoids; K2 on the main path's own grids (phase 3's
     decoded frames through ``vocoder.device.prediction_inputs``), held
     to its plain version, beside its time on phase 2's random grids;
     the pipelined loop (dispatch N+1, finish N, fetch N-1's PCM last)
     over 6 blocks at C=320 with adpcm; the stage
     split of one block; a torch.profiler window over two blocks (kernel
     times in the pipeline, the port's three kernels by name with their
     device time per launch, and the device busy share: device time per
     block over the unprofiled pipelined step, since the profiler
     slows the host).

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
BLOCK_S = 3.0                # one block of I/Q per channel
N_TIMED = 6                  # blocks in the pipelined timing loop
SEED = 20261016
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
    from dsdneo_tpu_torch.engine.voicebatch import BatchedP25VoicePipeline
    from dsdneo_tpu_torch.ops import audio_wire, fir_discriminate as k1mod
    from dsdneo_tpu_torch.protocol.p25 import encode
    from dsdneo_tpu_torch.vocoder import device as vdev

    dev = device.require_cuda()
    ident = device.card_identity().splitlines()[0]
    log(ident)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device_count {torch.cuda.device_count()}")
    no_reference_modules()
    # full float32 for every matmul and convolution the path takes
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
    log(f"set-up {time.perf_counter() - t0:.1f} s: C={C} B={B} "
        f"({BLOCK_S} s) n_sym={n_sym}, LDUs per channel "
        f"{want_ldus.min()}..{want_ldus.max()}")

    # -- 2. kernels against their plain versions ---------------------------
    report = {}
    clk = sm_clock_mhz()

    def show(name, err, k_ms, plain_ms, b_ms, b_by, extra=""):
        log(f"  {name}: kernel {k_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / k_ms:.1f}% of "
            f"the bound{extra}")
        report[name] = {"max_abs_err": err, "ms": k_ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by}

    x = blocks[0]
    xr, xi = x[..., 0], x[..., 1]            # stride-2 views, as the path
    ntaps = tables.taps.shape[0]
    got = k1mod.fir_discriminate(xr, xi, tables.taps)
    planes = k1mod.fir_discriminate(xr.contiguous(), xi.contiguous(),
                                    tables.taps)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = k1mod.fir_discriminate_plain(xr, xi, tables.taps)
        plain_ms = cuda_ms(lambda: k1mod.fir_discriminate_plain(
            xr, xi, tables.taps), 5)
    err = float((got - want).abs().max())
    k_ms = cuda_ms(lambda: k1mod.fir_discriminate(xr, xi, tables.taps), 20)
    log(f"K1 fir_disc [{C},{B}], {ntaps} taps: max_abs_err {err:.3e} "
        f"(tol 2e-4); views equal contiguous planes: "
        f"{bool(torch.equal(got, planes))}")
    if not err <= 2e-4 or not torch.equal(got, planes):
        raise RuntimeError(f"K1 disagrees with its plain version: {err}")
    # FIR: 2 planes x ntaps multiply-adds; the conjugate product 6 FLOP
    b_ms, b_by = bound(nbytes(x, got, tables.taps),
                       C * B * (4 * ntaps + 6))
    show("fir_disc", err, k_ms, plain_ms, b_ms, b_by)
    del got, want, planes

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

    S, T = C, Tn * 160
    tt = torch.arange(T, dtype=torch.float32) / 8000.0
    f = 200.0 + 1500.0 * torch.rand((S, 3, 1), generator=g)
    a = 0.3 * torch.rand((S, 3, 1), generator=g)
    sines = torch.clamp((a * torch.sin(2 * np.pi * f * tt)).sum(1)
                        + 0.01 * torch.randn((S, T), generator=g), -1.0, 1.0)
    sines = sines.contiguous().to(dev)
    got = audio_wire.adpcm_compress(sines, tables.adpcm_step,
                                    tables.adpcm_index)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want = audio_wire.adpcm_compress_plain(sines, tables.adpcm_step,
                                           tables.adpcm_index)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t1) * 1e3
    n_diff = int((got != want).sum())
    err = float((got.int() - want.int()).abs().max())
    k_ms = cuda_ms(lambda: audio_wire.adpcm_compress(
        sines, tables.adpcm_step, tables.adpcm_index), 20)
    log(f"K3 adpcm_enc [{S},{T}] three-tone sinusoids: {n_diff} bytes "
        f"differ (tol 0: bit-identical)")
    if n_diff:
        raise RuntimeError("K3 is not bit-identical to its plain version")
    b_ms, b_by = bound(nbytes(sines, got), 0)
    k3_floor_ms = T * K3_CHAIN_CYCLES / (clk * 1e3)
    show("adpcm_enc", err, k_ms, plain_ms, b_ms, b_by,
         f"; recurrence floor ~{k3_floor_ms:.4f} ms ({T} samples x "
         f"{K3_CHAIN_CYCLES} cycles at {clk:.0f} MHz), "
         f"{100 * k3_floor_ms / k_ms:.1f}% of it")
    del got, want

    # -- 3. the main path at C=320 ------------------------------------------
    counted = (k1mod.fir_discriminate, vdev.prediction_scan,
               audio_wire.adpcm_compress)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outputs = {}
    for fmt in ("f16", "adpcm"):
        # no device given: the pipeline takes the card itself
        pipe = BatchedP25VoicePipeline(C, FS, pcm_fmt=fmt, tables=tables)
        for blk, xb in enumerate(blocks):
            t1 = time.perf_counter()
            pcm = pipe.fetch_pcm(pipe.decode_block_async(xb))
            dt = time.perf_counter() - t1
            bits, errs, fch, forder = pipe.last_frames
            bits = bits.cpu().numpy()
            got_ldus = np.bincount(fch, minlength=C) // 9
            bad = np.flatnonzero(got_ldus != want_ldus)
            if bad.size:
                raise RuntimeError(
                    f"{fmt} block {blk}: channels {bad[:8].tolist()} "
                    f"accepted {got_ldus[bad[:8]].tolist()} LDUs, want "
                    f"{want_ldus[bad[:8]].tolist()}")
            for c in range(C):
                sel = np.flatnonzero(fch == c)
                fb = bits[sel[np.argsort(forder[sel])]]
                if not np.array_equal(fb, tv["bits88"][:len(fb)]):
                    raise RuntimeError(f"{fmt} block {blk} channel {c}: "
                                       "IMBE bits differ from the vector")
            if not np.isfinite(pcm).all():
                raise RuntimeError(f"{fmt} block {blk}: non-finite PCM")
            rms = np.sqrt(np.mean(pcm.astype(np.float64) ** 2, axis=1))
            if not (rms > 1e-3).all():
                raise RuntimeError(f"{fmt} block {blk}: silent channels "
                                   f"{np.flatnonzero(rms <= 1e-3)[:8]}")
            log(f"main path {fmt} block {blk}: {C}/{C} channels accept "
                f"{want_ldus.min()}..{want_ldus.max()} LDUs, "
                f"{bits.shape[0]} frames' IMBE bits equal the vector "
                f"(max ECC errors {int(errs.max())}), PCM {pcm.shape} "
                f"finite, rms {rms.min():.4f}..{rms.max():.4f}, "
                f"{dt * 1e3:.1f} ms")
            outputs[fmt, blk] = pcm
            if fmt == "f16" and blk == 0:
                carry01 = [None if st is None else
                           tuple(t[:2].cpu() for t in st)
                           for st in pipe.voice_state()]
                k2_carry = pipe.voice_state()[0]
            if fmt == "f16" and blk == 1:
                k2_frames, k2_steps = pipe.last_frames, pipe.last_steps
    launches = {fn.__name__: fn.launches for fn in counted}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"launches during the main path: {launches}; peak device memory "
        f"{peak_gb:.2f} GB")
    for name, n in launches.items():
        if n < 1:
            raise RuntimeError(f"kernel {name} was not launched on the "
                               "main path")
    no_reference_modules()

    # ADPCM against the f16 PCM it encodes (clip(pcm · 0.02)).  The test
    # voice is 27 equal-weight harmonics up to 3.6 kHz, hard for a 4-bit
    # IMA coder: the port's plain path measures ~8.4 dB on it, a signal
    # unrelated to the f16 PCM ≤ 0 dB; the check asks for 6 dB
    for blk in range(2):
        ref = np.clip(outputs["f16", blk] * 0.02, -1.0, 1.0)
        d = outputs["adpcm", blk] - ref
        snr = 10 * np.log10(np.sum(ref ** 2, 1) / np.maximum(
            np.sum(d ** 2, 1), 1e-20))
        log(f"adpcm vs f16 block {blk}: SNR {snr.min():.1f}.."
            f"{snr.max():.1f} dB (min 6)")
        if not (snr > 6.0).all():
            raise RuntimeError("ADPCM PCM does not follow the f16 PCM")

    # channels 0-1 against the port's plain path on the CPU (the path the
    # CPU tests hold to the JAX package): block 0 from a fresh state,
    # block 1 from the card's carry after block 0
    cpu_tables = params.load("cpu")
    ref = BatchedP25VoicePipeline(2, FS, pcm_fmt="f16", device="cpu",
                                  tables=cpu_tables)
    for blk, xb in enumerate(blocks):
        if blk == 1:
            ref.set_voice_state(*carry01)
        want = ref.decode_block(xb[:2].cpu())
        got = outputs["f16", blk][:2]
        peak = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        log(f"card vs CPU plain path, channels 0-1 block {blk}: max abs "
            f"err {err:.3e}, peak {peak:.3f} (tol 2e-3 * peak)")
        if not (got.shape == want.shape and err <= 2e-3 * peak):
            raise RuntimeError("card and CPU paths disagree")

    # -- 4. timing ----------------------------------------------------------
    # K3 on the main path's own PCM: what the wire encoder of the f16 run
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

    # K2 on the main path's own grids (f16 block 1: its decoded frames,
    # scattered as the decoder does, and the carry block 0 left) against
    # the random grids of phase 2
    bits, errs, fch, forder = k2_frames
    grids = vdev.prediction_inputs(
        bits, errs, torch.as_tensor(fch, device=dev),
        torch.as_tensor(forder, device=dev), C, k2_steps, tables)
    k2_in = {"random": k2_rand, "pipeline": (*grids, *k2_carry)}
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
    del k2_in, k2_rand, got, want

    # the pipelined loop of the JAX package's bench
    pipe = BatchedP25VoicePipeline(C, FS, pcm_fmt="adpcm", tables=tables)
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
    log(f"pipelined step ({ident}): {step_s * 1e3:.1f} ms per {BLOCK_S} s "
        f"block of {C} channels = {C * BLOCK_S / step_s:.1f}x realtime")

    # stage split of one block, each stage synchronized
    stages = {}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fe = pipe.frontend_dispatch(blocks[1])
    torch.cuda.synchronize()
    stages["front end + sync + NID"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    fe6 = pipe.frontend_finish(fe)
    stages["candidates to host"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    pipe.pick_ldus(*fe6[1:5], fe6[5], dibits_dev=fe6[0])
    stages["LDU pick (host)"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    h = pipe.decode_from_frontend(fe6)
    torch.cuda.synchronize()
    stages["LDU pick + voice decode"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    pipe.fetch_pcm(h)
    stages["PCM to host + expand"] = time.perf_counter() - t1
    log("stages (ms): " + ", ".join(f"{k} {v * 1e3:.1f}"
                                    for k, v in stages.items()))

    # device time by kernel and busy share over two pipelined blocks
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for i in range(2):
            pipe.fetch_pcm(pipe.decode_block_async(blocks[i]))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    from torch.autograd import DeviceType
    ours = ("fir_disc", "imbe_pred", "adpcm_enc")
    dev_us, dev_n = {}, {}
    for e in prof.key_averages():            # device-side events only
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            key = next((k for k in ours if f"{k}_kernel" in e.key), e.key)
            dev_us[key] = dev_us.get(key, 0.0) + e.self_device_time_total
            dev_n[key] = dev_n.get(key, 0) + e.count
    busy_ms = sum(dev_us.values()) / 2e3                    # per block
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    log(f"profile, 2 blocks: device busy {busy_ms:.1f} ms per block = "
        f"{100 * busy_ms / (step_s * 1e3):.1f}% of the unprofiled "
        f"pipelined step ({step_s * 1e3:.1f} ms); profiled wall "
        f"{wall_ms / 2:.1f} ms per block (the profiler's overhead "
        f"included); per block: "
        + ", ".join(f"{k[:40]} {v / 2e3:.3f} ms" for k, v in top))
    # the port's kernels by name, top 12 or not: device time per launch
    # on the path itself, a reading that does not depend on cuda_ms
    log("profile, 2 blocks, the port's kernels: " + ", ".join(
        f"{k} {dev_n[k]} launches, {dev_us[k] / dev_n[k] / 1e3:.4f} ms "
        f"per launch" if dev_n.get(k) else f"{k} not in the profile"
        for k in ours))

    rows = [("fir_disc", "dsdneo_tpu_torch/csrc/fir_disc.cu",
             "dsdneo_tpu/ops/pallas_frontend.py:123", "fir_discriminate"),
            ("imbe_pred", "dsdneo_tpu_torch/csrc/imbe_pred.cu",
             "dsdneo_tpu/vocoder/device.py:101", "prediction_scan"),
            ("adpcm_enc", "dsdneo_tpu_torch/csrc/adpcm_enc.cu",
             "dsdneo_tpu/ops/audio_wire.py:47", "adpcm_compress")]
    # no single PyTorch call computes any of the three functions
    log(ident)
    log(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[fn], **report[n], "library_ms": None}
        for n, src, rep, fn in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
