#!/usr/bin/env python3
"""Time the bf16 fused conv-chain kernel at the encoder's production shapes on
one CUDA card: as built, and with parts of its work taken out (ablations).

    python3 scripts/bench_conv_chain.py [VARIANT ...]

A VARIANT is `base` (the kernel as built) or ablations joined by `+`, e.g.
`no_mma+no_epilogue` (names: see ABLATIONS). Default: `base` and each single
ablation. Each variant is orca_tpu_torch/csrc/conv_chain.cu with the
ablations' text substitutions applied, built with build.py's flags (all
builds in parallel) into a temporary directory. All variants then run the 7
encoder stages of one production group (a 4 Mb block + 2 x 112 kb halo,
forward and reverse-complement rows) on the same random inputs, timed with
CUDA events, in turns: in the order given, then in reverse. Only `base` is
held to the plain PyTorch version (bf16 tolerance 2e-2 * max|ref|); an
ablated kernel computes wrong values by design and is only timed.

Prints the card's name and power limit, one line per variant and turn, and a
final JSON line {variant: [[ms per stage] per turn]}.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# name -> [(text in conv_chain.cu, replacement)]; each text must occur once
ABLATIONS = {
    # the tensor-core work (descriptors are still built)
    "no_mma": [(
        "        wgmma_k16<C>(acc[mt], desc_a, desc_b, (first_tap && j == 0) ? 0 : 1);",
        "        if (desc_a == 7) acc[mt][0] += 1.f;",
    )],
    # the accumulator write-back after each conv (the accumulators stay live)
    "no_epilogue": [(
        "    mma_epilogue<C>(acc, out, group_bytes, n_out, pos0, lo, hi, wts.b[k],",
        "    float sum = 0.f;\n"
        "    for (int mt = 0; mt < P::MT; ++mt)\n"
        "      for (int i = 0; i < C / 2; ++i) sum += acc[mt][i];\n"
        "    if (sum == 1.2345f) out[threadIdx.x] = 1;\n"
        "    if (false) mma_epilogue<C>(acc, out, group_bytes, n_out, pos0, lo, hi, wts.b[k],",
    )],
    # the weight copies after the first tap
    "no_copy": [(
        "      if (q + 1 < nstages) ws.issue(q + 1);",
        "",
    )],
    # the input tile (im2col at stage 0)
    "no_load": [
        ("for (int e = threadIdx.x; e < n_im * (kIm2colK / 4); e += kThreads)",
         "for (int e = threadIdx.x; e < 0; e += kThreads)"),
        ("for (int e = threadIdx.x; e < n0 * cv; e += kThreads)",
         "for (int e = threadIdx.x; e < 0; e += kThreads)"),
    ],
    # the per-tap wait for the weights and the block barrier
    "no_sync": [(
        "      cp_async_wait_all();  // stage q's weights (and, first, the input) are in\n"
        "      fence_proxy_async();  // ... visible to the wgmmas, as are the stores\n"
        "      __syncthreads();      // ... of every thread; slot (q + 1) & 1 is free\n",
        "",
    )],
    # the max-pool epilogue and the output store
    "no_pool": [(
        "for (int e = threadIdx.x; e < nq * cv; e += kThreads)",
        "for (int e = threadIdx.x; e < 0; e += kThreads)",
    )],
}


def variant_source(src: str, variant: str) -> str:
    if variant == "base":
        return src
    for name in variant.split("+"):
        for old, new in ABLATIONS[name]:
            if src.count(old) != 1:
                raise SystemExit(f"ablation {name}: anchor not found once: {old!r}")
            src = src.replace(old, new)
    return src


def build_variants(variants, workdir):
    """{variant: ctypes library}, every nvcc started at once."""
    from orca_tpu_torch.ops.kernels import build, conv_chain as cc

    src = (build.CSRC_DIR / "conv_chain.cu").read_text()
    procs = {}
    for i, v in enumerate(variants):
        cu = os.path.join(workdir, f"v{i}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, v))
        so = os.path.join(workdir, f"v{i}.so")
        procs[v] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for v, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {v}:\n{log[-4000:]}")
        libs[v] = cc.declare(ctypes.CDLL(so))
    return libs


def stage_cases(torch, cc):
    """Per encoder stage: (function, args, kwargs) on random bf16 weights."""
    import chip_smoke

    rng = np.random.RandomState(0)
    shapes = chip_smoke.stage_shapes()
    seg = shapes[0][0]
    cases = []
    for i, (length, cin, c, pool, res) in enumerate(shapes):
        ws = []
        for k in range(4):
            ci = (4 if i == 0 else cin) if k == 0 else c
            lim = 1 / np.sqrt(9 * ci)
            ws.append(tuple(
                torch.from_numpy(rng.uniform(-lim, lim, shape).astype(np.float32))
                .to(torch.bfloat16).cuda() for shape in ((9, ci, c), (c,))))
        # as chip_smoke: row 1 starts after a masked halo, ends 112 kb early
        halo = chip_smoke.HALO_BP
        vs = torch.tensor([0, halo // res], dtype=torch.int32, device="cuda")
        ve = torch.tensor([length, (seg - 2 * halo) // res], dtype=torch.int32,
                          device="cuda")
        if i == 0:
            x = torch.from_numpy(
                np.eye(4, dtype=np.uint8)[rng.randint(0, 4, (2, length))] * 4).cuda()
            cases.append((cc.fused_first_stage, cc.fused_first_stage_plain,
                          (x, ws[0], ws[1:], vs, ve),
                          dict(relus=(False, True, True), residual_idx=0,
                               out_pool=pool)))
        else:
            x = torch.randn(2, length, cin, device="cuda").to(torch.bfloat16)
            cases.append((cc.fused_conv_chain, cc.fused_conv_chain_plain,
                          (x, ws, vs, ve),
                          dict(relus=(False, False, True, True),
                               residual_idx=1 if i < 6 else -1, out_pool=pool)))
    return cases


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_conv_chain: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from orca_tpu_torch.ops.kernels import conv_chain as cc

    variants = sys.argv[1:] or ["base", *ABLATIONS]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        libs = build_variants(variants, workdir)
        cases = stage_cases(torch, cc)
        refs = [plain(*args, **kw) for _, plain, args, kw in cases]
        times = {v: [] for v in variants}
        for v in variants + variants[::-1]:
            cc._lib = libs[v]
            row, bad = [], []
            for i, ((kern, _, args, kw), ref) in enumerate(zip(cases, refs)):
                got = kern(*args, **kw)
                torch.cuda.synchronize()
                d = (got.float() - ref.float()).abs().max().item()
                if v == "base" and not d <= 2e-2 * ref.float().abs().max().item():
                    bad.append(f"stage {i}: max|d| {d:.3e}")
                row.append(chip_smoke.time_ms(torch, lambda: kern(*args, **kw),
                                              15))
            times[v].append(row)
            print(f"{v:40s} " + " ".join(f"s{i} {ms:.3f}" for i, ms in
                                         enumerate(row)), flush=True)
            if bad:
                print(f"bench_conv_chain: base kernel wrong: {bad}",
                      file=sys.stderr)
                return 1
        cc._lib = None
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
