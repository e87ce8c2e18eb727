#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from orca_tpu_torch/csrc with nvcc, and print
     each kernel's registers, spills and static shared memory (ptxas); the
     tensor-core kernels must not spill or have their wgmmas serialized;
  3. each kernel at the encoder's production shapes (4 Mb blocks + 112 kb
     halo, fwd + RC rows), bf16 and fp32: held against its plain PyTorch
     version, then timed with CUDA events beside the plain version and the
     least time the card could take, with the tile, the blocks launched, the
     achieved TFLOP/s and the share of the bound;
  4. `genomepredict` on one random 32 Mb window with a random full-width
     bundle: the unfolded bundle is refused on the card before any launch;
     the folded one runs 3 bf16 zoom targets, then 1 fp32, with the launch
     counters set to 0 just before and read just after, the zoom starts
     checked against a host float32 recomputation and the maps checked
     finite and symmetric;
     then the encoder alone, for the encoder/decoder split; then the whole
     cascade on the card against the CPU plain path on a small window;
  5. one JSON line with every kernel, then the device line.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
HALO_BP = 112_000
BLOCK_BP = 4_000_000
ZOOM_TARGETS = (16_000_000, 9_123_000, 27_500_000)  # bp, in a 32 Mb window

# Published dense peaks (NVIDIA data sheets): (bf16 FLOP/s, fp32 FLOP/s on
# the CUDA cores, memory bytes/s), keyed by a substring of the card's name.
PEAKS = {
    "PCIe": (756e12, 51e12, 2.0e12),
    "NVL": (835e12, 60e12, 3.9e12),
    "": (989e12, 67e12, 3.35e12),  # H100 SXM
}
KERNEL_INFO = {
    "fused_first_stage": (
        "orca_tpu_torch/csrc/conv_chain.cu",
        "orca_tpu/ops/pallas/conv1d.py:396",
    ),
    "fused_conv_chain": (
        "orca_tpu_torch/csrc/conv_chain.cu",
        "orca_tpu/ops/pallas/conv1d.py:281",
    ),
}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def time_ms(torch, fn, reps):
    """Median milliseconds of `reps` calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ptxas_report(log, demangle):
    """Per compiled kernel in an `nvcc -Xptxas -v` log: its name, registers,
    (spill store, spill load) bytes, static shared bytes, and the kernels
    whose wgmmas ptxas serialized ("Potential Performance Loss")."""
    out, cur, serialized = [], None, set()
    for line in log.splitlines():
        m = re.search(r"Potential Performance Loss: wgmma.*function '(\S+)'",
                      line)
        if m:
            serialized.add(demangle(m.group(1)))
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"name": demangle(m.group(1)), "regs": None, "spill": (0, 0),
                   "smem": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    for k in out:
        k["serialized"] = k["name"] in serialized
    return out


def demangler(nvcc):
    """A function from a mangled kernel name to a readable one (cu++filt
    beside nvcc), or the identity where there is none."""
    tool = os.path.join(os.path.dirname(nvcc), "cu++filt")
    if not os.path.exists(tool):
        return lambda name: name

    def run(name):
        res = subprocess.run([tool, name], capture_output=True, text=True,
                             timeout=30)
        return res.stdout.strip() or name
    return run


def stage_shapes():
    """Per stage: (input length, cin, c, out_pool, resolution) of one
    production group (a 4 Mb block with its 112 kb halos)."""
    from orca_tpu_torch.nn.encoders import STAGES

    pools = [p for _, _, p in STAGES] + [1]
    length, res, out = BLOCK_BP + 2 * HALO_BP, 1, []
    for i, (cin, c, pool) in enumerate(STAGES):
        res *= pool or 1
        out.append((length // res, cin, c, pools[i + 1], res))
    return out


def kernel_phase(torch, enc_params, dtype, peaks, sms):
    """Each kernel at production shapes against its plain version; returns
    {kernel: {ms, plain_ms, bound_ms, bound_by, max_abs_err}} summed over the
    kernel's launches in one group."""
    from orca_tpu_torch.ops.kernels import conv_chain as cc

    lp, cp = enc_params["lconv"], enc_params["conv"]

    def wb(u):
        return u["w"], u["b"]

    flops_peak = peaks[0] if dtype == torch.bfloat16 else peaks[1]
    esize = torch.finfo(dtype).bits // 8
    rng = np.random.RandomState(SEED)
    seg = BLOCK_BP + 2 * HALO_BP
    codes = rng.randint(0, 4, size=(2, seg))
    x = torch.from_numpy(np.eye(4, dtype=np.uint8)[codes] * 4).cuda()
    totals = {}
    for i, (length, cin, c, pool, res) in enumerate(stage_shapes()):
        # row 0 valid everywhere; row 1 is the window's last block, whose
        # valid range ends 112 kb early, and starts after a masked halo
        vs = torch.tensor([0, HALO_BP // res], dtype=torch.int32, device="cuda")
        ve = torch.tensor([length, (seg - 2 * HALO_BP) // res],
                          dtype=torch.int32, device="cuda")
        if i == 0:
            name = "fused_first_stage"
            convs = [wb(lp[0][0]), wb(lp[0][1]), wb(cp[0][0]), wb(cp[0][1])]
            kw = dict(relus=(False, True, True), residual_idx=0, out_pool=pool)
            args = (x, convs[0], convs[1:], vs, ve)
            kern, plain = cc.fused_first_stage, cc.fused_first_stage_plain
        else:
            name = "fused_conv_chain"
            convs = [wb(lp[i][0]), wb(lp[i][1]), wb(cp[i][0]), wb(cp[i][1])]
            kw = dict(relus=(False, False, True, True),
                      residual_idx=1 if i < 6 else -1, out_pool=pool)
            args = (x, convs, vs, ve)
            kern, plain = cc.fused_conv_chain, cc.fused_conv_chain_plain
        got = kern(*args, **kw)
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"stage {i}: shape/dtype {got.shape} {got.dtype} vs "
              f"{ref.shape} {ref.dtype}")
        d = (got.float() - ref.float()).abs().max().item()
        m = ref.float().abs().max().item()
        check(np.isfinite(d) and np.isfinite(m), f"stage {i}: non-finite")
        tol = 1e-4 * max(1.0, m) if dtype == torch.float32 else 2e-2 * m
        reps = 5 if length > 100_000 else 20
        ms = time_ms(torch, lambda: kern(*args, **kw), reps)
        plain_ms = time_ms(torch, lambda: plain(*args, **kw), reps)
        ops = 2 * 9 * sum(w.shape[1] * w.shape[2] for w, _ in convs) * 2 * length
        nbytes = (x.numel() * x.element_size() + got.numel() * esize
                  + sum((w.numel() + b.numel()) * esize for w, b in convs)
                  + 4 * vs.numel() * 2)
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / peaks[2] * 1e3
        tile = cc.plan_tile(x.shape[0], length, pool, cin, c, dtype, i == 0,
                            sms)
        blocks = x.shape[0] * -(-length // tile)
        print(f"  stage {i} {name} {str(dtype)[6:]}: in {tuple(x.shape)} "
              f"out {tuple(got.shape)} max|d| {d:.3e} max|ref| {m:.3e} "
              f"(tol {tol:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
              f"bound {max(t_ops, t_bytes):.4f} ms "
              f"({ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) tile {tile} "
              f"blocks {blocks} {ops / ms / 1e9:.1f} TFLOP/s "
              f"{max(t_ops, t_bytes) / ms:.1%} of bound", flush=True)
        check(d <= tol, f"stage {i} {name}: max|d| {d} > {tol}")
        t = totals.setdefault(name, dict(ms=0.0, plain_ms=0.0, t_ops=0.0,
                                         t_bytes=0.0, max_abs_err=0.0))
        t["ms"] += ms
        t["plain_ms"] += plain_ms
        t["t_ops"] += t_ops
        t["t_bytes"] += t_bytes
        t["max_abs_err"] = max(t["max_abs_err"], d)
        x = got
    for t in totals.values():
        t["bound_ms"] = max(t["t_ops"], t["t_bytes"])
        t["bound_by"] = "operations" if t["t_ops"] >= t["t_bytes"] else "bytes"
    return totals


def host_starts(geom, mpos, wpos):
    """Forward zoom starts (finest bins) recomputed on the host in float32."""
    f32 = np.float32
    sb, out = 0, []
    for level in (32, 16, 8, 4, 2, 1):
        out.append(sb)
        span4 = f32(geom.span_bp(level) / 4.0)
        num = (f32(mpos) - span4) - (
            (f32(wpos) - f32(geom.window_bp / 2.0)) + f32(sb) * f32(geom.bin_bp))
        raw = np.floor(num / f32(geom.bin_bp * level))
        sb += int(np.clip(raw, 0, geom.half)) * level
    return out


def cascade_phase(torch, bundle, seq, targets, geom):
    """genomepredict per zoom target; returns (outputs, seconds each)."""
    from orca_tpu_torch.predict.multiscale import genomepredict

    wpos = geom.window_bp // 2
    outs, secs = [], []
    for mpos in targets:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = genomepredict(seq, "chrSynthetic", mpos, wpos, [bundle],
                            geometry=geom)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        want = [int(wpos - geom.window_bp // 2 + s * geom.bin_bp)
                for s in host_starts(geom, mpos, wpos)]
        check(out["start_coords"] == want,
              f"zoom starts {out['start_coords']} != host float32 {want}")
        for j, p in enumerate(out["predictions"][0]):
            check(p.shape == (geom.crop, geom.crop), f"level {j}: {p.shape}")
            check(np.isfinite(p).all(), f"level {j}: non-finite map")
            check(np.array_equal(p, p.T), f"level {j}: map not symmetric")
        outs.append(out)
    return outs, secs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from orca_tpu_torch.models import zoo
        from orca_tpu_torch.nn import encoders
        from orca_tpu_torch.ops.kernels import build, conv_chain as cc
        from orca_tpu_torch.predict import multiscale as ms
    except ImportError as e:
        print(f"chip_smoke: the port is missing next to this script: {e}",
              file=sys.stderr)
        return 1

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    peaks = next(v for k, v in PEAKS.items() if k in kind or k in smi)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    reports = build.build(["conv_chain"])
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    demangle = demangler(build.nvcc_path())
    for name, log in reports.items():
        for k in ptxas_report(log, demangle):
            print(f"  {name}: {k['name']}: {k['regs']} registers, spill "
                  f"stores {k['spill'][0]} B loads {k['spill'][1]} B, static "
                  f"smem {k['smem']} B"
                  f"{', wgmma serialized' if k['serialized'] else ''}",
                  flush=True)
            # the tensor-core kernels hold their accumulators in registers
            # and keep their wgmmas asynchronous
            check("mma" not in k["name"]
                  or (k["spill"] == (0, 0) and not k["serialized"]),
                  f"{k['name']} spills registers or serializes wgmma")

    # weights: a random full-width bundle, folded (fp32) and cast (bf16)
    t0 = time.perf_counter()
    raw_bundle = zoo.random_32m_bundle(SEED)
    fp32_bundle = zoo.fold_bundle(raw_bundle)
    bf16_bundle = zoo.cast_bundle(fp32_bundle, "bfloat16")
    print(f"bundle: {time.perf_counter() - t0:.1f} s", flush=True)

    # 3. kernels at production shapes
    kernel_rows = {}
    for dtype, bundle in ((torch.bfloat16, bf16_bundle),
                          (torch.float32, fp32_bundle)):
        print(f"kernels {dtype}:", flush=True)
        kernel_rows[dtype] = kernel_phase(torch, bundle.encoder, dtype, peaks,
                                          sms)

    # 4. the main path: genomepredict on a random 32 Mb window
    geom = ms.GEOM_32M
    codes = np.random.RandomState(SEED + 1).randint(0, 4, geom.window_bp)
    seq = (np.eye(4, dtype=np.uint8)[codes] * 4)[None]
    expected = encoders.fused_group_count(2, geom.window_bp)
    # an unfolded bundle has no plain fallback on the card: it is refused
    # before any kernel launches
    before = (cc.fused_first_stage.launches, cc.fused_conv_chain.launches)
    try:
        ms.genomepredict(seq, "chrSynthetic", ZOOM_TARGETS[0],
                         geom.window_bp // 2, [raw_bundle], geometry=geom)
    except ValueError as e:
        print(f"unfolded bundle on the card: refused ({e})", flush=True)
    else:
        raise PhaseError("an unfolded bundle ran on the card")
    check((cc.fused_first_stage.launches, cc.fused_conv_chain.launches)
          == before, "the refused request launched a kernel")
    del raw_bundle
    launches = {}
    for dtype, bundle, targets in (
        (torch.bfloat16, bf16_bundle, ZOOM_TARGETS),
        (torch.float32, fp32_bundle, ZOOM_TARGETS[:1]),
    ):
        torch.cuda.reset_peak_memory_stats()
        cc.fused_first_stage.launches = 0
        cc.fused_conv_chain.launches = 0
        outs, secs = cascade_phase(torch, bundle, seq, targets, geom)
        counts = {"fused_first_stage": cc.fused_first_stage.launches,
                  "fused_conv_chain": cc.fused_conv_chain.launches}
        launches[dtype] = counts
        want = {"fused_first_stage": expected * len(targets),
                "fused_conv_chain": 6 * expected * len(targets)}
        print(f"cascade {dtype}: {len(targets)} requests, seconds "
              f"{[round(s, 4) for s in secs]}, launches {counts} "
              f"(expected {want}), starts {outs[-1]['start_coords']}, "
              f"peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        check(counts == want, f"launch counts {counts} != {want}")
        if dtype == torch.bfloat16:
            bf16_first, bf16_secs = outs[0], secs
        else:
            d = max(np.abs(a - b).max() for a, b in zip(
                outs[0]["predictions"][0], bf16_first["predictions"][0]))
            m = max(np.abs(a).max() for a in outs[0]["predictions"][0])
            print(f"  fp32 vs bf16 request at {targets[0]}: max|d| {d:.3e} "
                  f"max|fp32| {m:.3e}", flush=True)
            fp32_secs = secs

    # encoder alone (bf16 and fp32), for the encoder/decoder split
    seq2 = torch.from_numpy(seq).cuda()
    seq2 = torch.cat([seq2, torch.flip(seq2, dims=(1, 2))])
    split = {}
    with torch.inference_mode():
        for dtype, bundle, secs in ((torch.bfloat16, bf16_bundle, bf16_secs),
                                    (torch.float32, fp32_bundle, fp32_secs)):
            enc_s = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ms._encode_32mb(bundle, seq2)
                torch.cuda.synchronize()
                enc_s.append(time.perf_counter() - t0)
            req = statistics.median(secs[1:] if len(secs) > 1 else secs)
            enc = min(enc_s)
            split[dtype] = (req, enc)
            print(f"split {dtype}: request {req:.4f} s = encoder+pyramid "
                  f"{enc:.4f} s + decoders/crops/host {req - enc:.4f} s",
                  flush=True)

    # the whole cascade on the card against the CPU plain path, small window
    small = ms.CascadeGeometry(1_024_000, 4000, 8)
    cpu_b = zoo.fold_bundle(zoo.random_32m_bundle(SEED + 2, "cpu", nbins=256,
                                                  crop=8))
    gpu_b = zoo._map_params(cpu_b, lambda t: t.cuda())
    sseq = (np.eye(4, dtype=np.uint8)[codes[: small.window_bp]] * 4)[None]
    a = ms.genomepredict(sseq, "c", 400_000, 512_000, [gpu_b], geometry=small)
    b = ms.genomepredict(sseq, "c", 400_000, 512_000, [cpu_b], geometry=small,
                         device="cpu")
    check(a["start_coords"] == b["start_coords"], "small window: starts differ")
    d = max(np.abs(p - q).max() for p, q in zip(a["predictions"][0],
                                                b["predictions"][0]))
    m = max(np.abs(q).max() for q in b["predictions"][0])
    print(f"small window fp32 card vs CPU plain: max|d| {d:.3e} "
          f"max|ref| {m:.3e}", flush=True)
    check(d <= 1e-4 * max(1.0, m), f"small window: max|d| {d}")

    # 5. the kernel line and the device line
    rows = []
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        for name, t in kernel_rows[dtype].items():
            source, replaces = KERNEL_INFO[name]
            rows.append({
                "name": f"{name}[{tag}]", "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[dtype][name],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["plain_ms"],
            })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
