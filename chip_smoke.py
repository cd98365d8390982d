#!/usr/bin/env python3
"""Drive the PyTorch port's P25p1 voice main path once on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. set-up: the card (name and power limit), no JAX in the process,
     the CUDA kernels built from ``dsdneo_tpu_torch/csrc``;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (C=320 channels, 3 s blocks);
  3. the main path, ``BatchedP25VoicePipeline(320)`` for ``pcm_fmt``
     f16 and adpcm over two consecutive blocks with the carry kept:
     320 distinct channels (own noise seed and leading offset each) built
     from the test vector in ``dsdneo_tpu_torch/data/p25p1_tables.npz``;
     every channel must accept every LDU and decode the vector's IMBE
     bits, the PCM must be finite and non-silent, and channels 0-1 must
     agree with the port's plain CPU path on the same input; every
     kernel's launch counter must have risen;
  4. timing: the pipelined loop (dispatch N+1, finish N, fetch N-1's
     PCM last) over 6 blocks at C=320 with adpcm.

The last two lines of standard output are a JSON object describing the
kernels and the contract line ``{"ok": true, "device": {...}}``.
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


def log(*a) -> None:
    print(*a, flush=True)


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean milliseconds per call on the card (CUDA events)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
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
    x = blocks[0]
    xr, xi = x[..., 0].contiguous(), x[..., 1].contiguous()
    got = k1mod.fir_discriminate(xr, xi, tables.taps)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = k1mod.fir_discriminate_plain(xr, xi, tables.taps)
        plain_ms = cuda_ms(lambda: k1mod.fir_discriminate_plain(
            xr, xi, tables.taps), 5)
    err = float((got - want).abs().max())
    k_ms = cuda_ms(lambda: k1mod.fir_discriminate(xr, xi, tables.taps), 20)
    log(f"K1 fir_disc [{C},{B}]: max_abs_err {err:.3e} (tol 2e-4) "
        f"kernel {k_ms:.4f} ms plain {plain_ms:.4f} ms")
    if not err <= 2e-4:
        raise RuntimeError(f"K1 disagrees with its plain version: {err}")
    report["fir_disc"] = (err, k_ms, plain_ms)
    del got, want

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
        f"(tol rtol 1e-5, atol 1e-5) kernel {k_ms:.4f} ms "
        f"plain {plain_ms:.4f} ms")
    report["imbe_pred"] = (err, k_ms, plain_ms)

    S, T = C, Tn * 160
    tt = torch.arange(T, dtype=torch.float32) / 8000.0
    f = 200.0 + 1500.0 * torch.rand((S, 3, 1), generator=g)
    a = 0.3 * torch.rand((S, 3, 1), generator=g)
    pcm = torch.clamp((a * torch.sin(2 * np.pi * f * tt)).sum(1)
                      + 0.01 * torch.randn((S, T), generator=g), -1.0, 1.0)
    pcm = pcm.contiguous().to(dev)
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
        pcm, tables.adpcm_step, tables.adpcm_index), 10)
    log(f"K3 adpcm_enc [{S},{T}]: {n_diff} bytes differ (tol 0: "
        f"bit-identical) kernel {k_ms:.4f} ms plain {plain_ms:.1f} ms")
    if n_diff:
        raise RuntimeError("K3 is not bit-identical to its plain version")
    report["adpcm_enc"] = (err, k_ms, plain_ms)
    del args, got, want, pcm

    # -- 3. the main path at C=320 ------------------------------------------
    counted = (k1mod.fir_discriminate, vdev.prediction_scan,
               audio_wire.adpcm_compress)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outputs = {}
    for fmt in ("f16", "adpcm"):
        pipe = BatchedP25VoicePipeline(C, FS, pcm_fmt=fmt, device=dev,
                                       tables=tables)
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
    launches = {fn.__name__: fn.launches for fn in counted}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"launches during the main path: {launches}; peak device memory "
        f"{peak_gb:.2f} GB")
    for name, n in launches.items():
        if n < 1:
            raise RuntimeError(f"kernel {name} was not launched on the "
                               "main path")

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

    # -- 4. timing: the pipelined loop of the JAX package's bench ----------
    pipe = BatchedP25VoicePipeline(C, FS, pcm_fmt="adpcm", device=dev,
                                   tables=tables)
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

    rows = [("fir_disc", "dsdneo_tpu_torch/csrc/fir_disc.cu",
             "dsdneo_tpu/ops/pallas_frontend.py:123", "fir_discriminate"),
            ("imbe_pred", "dsdneo_tpu_torch/csrc/imbe_pred.cu",
             "dsdneo_tpu/vocoder/device.py:101", "prediction_scan"),
            ("adpcm_enc", "dsdneo_tpu_torch/csrc/adpcm_enc.cu",
             "dsdneo_tpu/ops/audio_wire.py:47", "adpcm_compress")]
    log(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[fn], "max_abs_err": report[n][0],
         "ms": report[n][1], "plain_ms": report[n][2]}
        for n, src, rep, fn in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
