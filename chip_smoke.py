#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from orca_tpu_torch/csrc with nvcc, and print
     each kernel's registers, spills and static shared memory (ptxas); the
     tensor-core kernels and the fp32 FFMA kernel must not spill, and the
     tensor-core kernels must not have their wgmmas serialized;
 2b. the host codec ("codec" lines): csrc/orca_native.cpp built with the
     host's C++ compiler (timed; the phase fails unless it loads), then
     `codes_to_onehot` on a 32 Mb window of codes (N among them), + and -
     strand, against the numpy path it replaces, median of 3 each: bit-equal,
     ms and GB/s of one-hot written;
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
     cascade on the card against the CPU plain path on a small window (held
     to 1e-4, and printed beside the port's fp32 bar of 2.0e-6 against the
     JAX package, BAR_FP32);
 4b. sequence-sharded inference ("sharded"): `genomepredict` at the first
     zoom target with `make_mesh((1, 2))` and `make_mesh((2, 2))` over
     cuda:0 named 2 and 4 times (one card: the shards run one after another,
     so this holds their results, not a multi-card speed), bf16 and fp32,
     the launch counters set to 0 before each request and checked against
     the shards' group plan, starts equal to the unsharded request's and
     the maps within FP32_BAR (fp32) or twice the unsharded request's
     bf16-vs-fp32 difference (bf16); each kernel against its plain version
     at the bounds of an edge shard's blocks; the fp32 tower alone sharded
     (under CUDA's sync debug mode "error": the host never waits between
     shards) and unsharded, its max|d|; every sharded call must leave the
     current CUDA device as it found it;
 4c. the profile ("profile" JSON line): one warm bf16 32 Mb request traced
     with `utils.profiling.trace` inside a `request` region, the program's
     spans on (`profiling.enable`); from the Chrome trace the device's idle
     share in the request's window (1 - the union of kernel, memcpy and
     memset intervals / the window), the top 5 device operations by summed
     time with their counts, the 5 longest idle gaps with the host op or
     annotation active when each began, per `orca.*` span its calls, host
     and self ms, launches and the idle ms put down to it (the innermost
     span open; `idle_in_spans_share` is what no span left to `-`), the
     request's `h2d_bytes` (the window's), and `device_time` of the
     request beside the smoke's own timer;
  5. `genomepredict_256mb` on a whole synthetic chromosome: an in-memory
     genome of a 145.1 Mb chromosome and a padding chromosome, the region
     list of a whole-chromosome request, `retrieve_multi` for the sequence
     and the region mosaic's background (both timed on the host, with the
     codec's calls and seconds inside it; then again on the numpy path, the
     codec switched off, its sequence bit-equal), packed to uint8 once; the
     unfolded random 256 Mb bundle is refused on the card before any
     launch; the folded one runs 2 bf16 zoom targets (the second
     near the chromosome's end, where the zoom is clamped), then 1 fp32, with
     the launch counters set to 0 before each request and checked (64 and
     384 per request), the zoom starts checked against a host float32
     recomputation with the clamp, the maps checked finite, symmetric and
     250x250 and the end coordinates inside the chromosome; then the
     encoder alone, for the split (phase 5c holds this path to orca_tpu
     at full geometry, which replaced the 256 Mb cascade against the CPU
     plain path on an 8.192 Mb window: ~75 s of host CPU);
 5b. one bf16 `genomepredict_256mb` with a (1, 2) mesh of cuda:0 on the
     same window (`sharded256` line): launches checked against the shards'
     group plan, starts equal to the unsharded request's, maps within twice
     its bf16-vs-fp32 difference;
 5c. the certificate against orca_tpu at full geometry ("certify_card"
     lines): tests/data/certify_card_ref.npz holds orca_tpu's outputs,
     computed on the CPU (tests/test_torch_certify_card.py); the weights
     (phase 4's and 5's folded fp32 bundles, the 1 Mb one drawn on this
     host's CPU) and the inputs (`orca_tpu_torch.certify_card`) have their
     SHA-256 digests checked against the file's, and the card runs one fp32
     `predict_1m` with tracks, 32 Mb `genomepredict` at both zooms in fp32
     and bf16, and 256 Mb `genomepredict_256mb` at both zooms in fp32
     (TF32 off), the launch
     counters set to 0 before each request and checked just after (1/6,
     8/48, 64/384). One line a request: each level's max|d| and max|ref|,
     starts equal, the bar (fp32 BAR_FP32; bf16 twice orca_tpu's own
     bf16-vs-fp32 max|d| at the level); then one `{"certify_card": ...}`
     JSON line with every figure, pass for each bar, the card and the
     phase's seconds. Different digests or starts, a non-finite map, wrong
     launches, an fp32 figure over 1e-4 * max(1, max|ref|) or a bf16 figure
     over twice its bar fail the phase; a figure over its bar but under
     that only reads pass: false;
  6. the variant screens, through the entry points a user calls: random
     folded bundles (two 32 Mb, two 256 Mb) pickled by `zoo.save_bundle`
     and loaded by `load_resources` in bf16 onto the card (checked bf16,
     folded, no genome or targets); then `process_dup` (a 0.8 Mb tandem
     duplication, both 32 Mb models: 3 windows) and `process_del` (a 2 Mb
     deletion with the 256 Mb models: 3 whole-chromosome requests) on the
     phase-5 genome, the launch counters set to 0 just before each screen and
     checked just after (48/288 and 384/2304), the maps checked finite,
     symmetric and 250x250, the dup's ref.l held to a direct `genomepredict`
     on the same window, the del's end coordinates inside each chromosome;
     one `screen` line each (host seconds, the codec's calls and seconds
     and the other callees', launches, peak device memory, peak host RSS).
     No plots: matplotlib is never imported;
  7. the standalone 1 Mb family on 1 Mb windows of the phase-5 genome with a
     random bundle (32 tracks): each kernel at the 1 Mb stage shapes (8 rows
     of one 1 Mb piece, valid everywhere), held against its plain version
     and timed; the unfolded bundle refused before any launch; then, folded,
     `screen_windows` over 8 windows in batches of 4 and `predict_1m` with
     tracks and the reverse complement on 4 (bf16), and one fp32 call, the
     launch counters set to 0 just before each call and checked (1 and 6 per
     call), the maps checked finite, symmetric and 250x250 and the tracks in
     [0, 1]; then one window on the card against the CPU plain path;
  8. the warm server through the command line: `build-genome` on a
     synthetic FASTA (two 34 Mb chromosomes) into a temporary `_smoke_*`
     resource dir, two random folded 32 Mb bundles pickled into its model
     dir, then `cli.main(["serve", ..., "--prewarm", "32M"])` in this
     process in bf16, reading one command of each prediction mode with
     --no-target, a malformed line and `quit`. The drawing functions are
     replaced by a recorder of the file names (the card's machine has no
     matplotlib). Checked: WARM, READY, 5 OK and 1 ERR; each .pkl's maps;
     the region .pkl against a direct `process_region`; each command's
     launches against its windows x 2 models x 8 groups;
  9. the released checkpoints' path ("checkpoints"): seeded random port
     bundles of every family (h1esc, hff, hctnoc; h1esc_1m, hff_1m sharing
     the 32 Mb models' stage-a Net; h1esc_256m, hff_256m sharing their tower
     and pyramid; leukemiaA, leukemiaB), BatchNorm statistics randomized,
     written as reference-format statedicts (DataParallel 'module.' prefix,
     `num_batches_tracked`, net0 the whole stage-a Net with its 1D head) into
     a temporary `_smoke_*` dir, with smooth expectation .npy files under
     every name the loaders read; then `load_resources(models=["32M", "1M",
     "256M", "leukemia"])` onto the card in float32 and in bf16 (each
     timed, with the peak host RSS of the load, sampled): every folded
     parameter equal to folding the source bundle on the card (max|d| 0 in
     float32, and in bf16 after the same cast), every background equal; then
     full-geometry 32 Mb requests (zoom 16 Mb) for h1esc, HCTnoc, leukemiaA
     and leukemiaB in bf16 and leukemiaB in fp32, in turns, six rounds,
     launches checked (8/48 a request), maps (250, 250) or (num_2d, 250,
     250), finite and symmetric, the medians of the last five rounds split
     into encoder + pyramid, decoder levels and the rest on the host;
     leukemiaB's fp32 cascade on the card against the CPU plain path on a
     1.024 Mb window; `cli.main(["convert", "leukemia", "leukemiaB", ...])`
     in this process, its pickle equal to the bundle load_resources loaded;
 10. training ("training"), through the command line a user runs: both
     kernels in fp32 at the training steps' tower shape (20 rows of 1.024 Mb
     pieces: 800 kb blocks with their 112 kb halos), held against their
     plain versions and timed (`stage1024kb` lines, `kernels1024kb`); one
     stage-b step at CascadeGeometry(1_024_000, 4000, 8), levels (32, 1),
     with pinned draws on the card against the CPU plain path: in float32
     the loss and BatchNorm updates within 1e-4 * max(1, max|ref|), and
     the card's momentum tree within twice the CPU float32 step's distance
     to a float64 CPU step (a control with TF32 allowed must miss that);
     in float64 on shared tower features the loss, BatchNorm updates,
     momentum tree and params within 1e-4 * max(1, max|ref|); then per stage a synthetic
     genome through `build-genome`, a dense store of smooth balanced maps,
     expectations (and a 32-track BED for stage a) in a temporary `_smoke_*`
     dir, and `cli.main(["train", ...])` at full width and geometry (a: the
     1 Mb Net, batch 4, SWA; b: 32 Mb, six levels, 4 windows a step, from
     a's run; c: 256 Mb, four levels, from a's and b's runs): 3 steps
     straight, then 1 step and a resumed run to step 3 in another workdir,
     as the command line runs them (the steps select cuDNN's deterministic
     algorithms). Checked: losses finite, the trainable params moved and
     the frozen ones bit-equal, launches a step and a validation equal to
     the group plan's (a: 0 a step), step 1 equal in two runs, the resumed
     losses within 1e-5 relative of the straight run's. One `training
     <stage>` line each: seconds a step (first and rest), its frozen tower
     and trainable parts, host sampling, validate, save, restore, peak
     device memory, launches;
 10b. data-parallel training ("training_dp"): phase 10's stage-b job (its
     seed, its stage-a run) as a multihost run of two processes started
     here with torchrun's environment, each `cli.main(["train", "b", ...,
     "--mesh", "data=2,seq=2"])` with gloo (nccl refuses two ranks on one
     card) on a mesh row that names cuda:0 twice, so together they drive a
     (2, 2) mesh: 2 steps at full geometry, no validation, a checkpoint at
     step 2. Checked: both kernels at the sharded training rows' edge-shard
     bounds against their plain versions; step 1's loss and per-level
     losses within DP_LOSS_RTOL of phase 10's step 1; each rank's trainable
     params equal after each step (digests, and max|d| 0 at the end);
     launches a rank a step against the shards' group plan (6/36); rank 0
     alone saved ckpt_2.pt and logged (one row), each rank wrote its
     `.p<rank>` sidecar; the checkpoint restored in this process equal to
     the writers' params. One `training_dp` line: seconds a step per rank,
     the frozen tower, host sampling, the all-reduces' host seconds and
     calls, launches, peak device memory per rank;
 11. the benchmark ("bench"), through the command line a user runs:
     `cli.main(["bench"])` in this process at ORCA_BENCH_ITERS=2 with every
     section (32 Mb bf16, two models, fp32 and its two models, 256 Mb bf16
     and fp32, stage-a and stage-b steps), stdout and stderr captured, the
     launch counters set to 0 just before. The JSON line printed on a line
     of its own, each section's seconds and peak device memory on `bench|`
     lines. Checked: exactly one line on stdout; every key of the JAX
     package's benchmark line (bench.py's `result`) and of its stage-a and
     stage-b training fields (scripts/bench_training.py), read from their
     sources, and `power_limit_w`; no `*_error` key; every number finite and
     positive; `device` the card's name; each kernel's launches per dtype
     equal to the sections' requests and steps times the tower's groups;
     the bf16 and fp32 seconds a 32 Mb window within 0.5-2x of phase 4's
     warm request less the sequence's copy to the card (the benchmark's
     sequence is on the card before timing); then the warm-up in the JAX
     package's call forms on the benchmark's two bf16 models:
     `warmup_cascade_32m(model0, GEOM_32M, 1)` and `(model1, GEOM_32M,
     n=2)`, their seconds positive and their launches those of 2 and 4 rows;
 13. the JAX package's drivers ("driver" lines), each through its entry
     point on the card at a reduced count, the counters set to 0 just
     before each in-process driver and its launches per dtype checked
     against its group plan just after, its stdout and stderr echoed on
     `driver|` lines: `bench_serve_screen` (4 dup/del variants through one
     `serve --prewarm 32M` process it starts, `--plots record`; checked:
     READY and every command OK, each kept .pkl's maps finite, symmetric
     and 250x250, plot names recorded; the server's launches are in its
     own process and not counted), `measure_loader` (8 batches a format,
     in a process of its own: its workers fork), `bench_training enc`
     (batch 4 at 1 Mb, 2 iterations; fp32, the kernels on the forward path
     only), `profile_cascade`, `probe_two_model`, `probe_decoder` (n=2;
     bf16; the decoder probe launches none), `smoke_e2e` (`--plots record`)
     and `bench_256m` (ORCA_BENCH_ITERS=1). Checked on each: the JAX
     script's keys or printed labels (read from its source), every number
     finite and positive, the card's name;
 12. last, after phase 13: one JSON line with every kernel (its launches
     summed over every request of phases 4-9, the sharded phases, the
     training phases, the benchmark and the drivers), then the device line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import resource
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
# the 256 Mb request: a chr8-sized chromosome padded by another to 256 Mb,
# the window centred at 128 Mb; zoom targets as in scripts/bench_256m.py and
# near the chromosome's end
CHROM_BP = 145_100_000
PAD_CHROM_BP = 120_000_000
WPOS_256 = 128_000_000
ZOOM_TARGETS_256 = (64_000_000, 143_000_000)
ONE_MB_WINDOW = 1_000_000  # the standalone 1 Mb model's window
CODEC_BP = 32_000_000  # the codec phase's window: one 32 Mb request's
# the port's fp32 bar against the JAX package (ROADMAP's North star),
# printed beside the card-vs-CPU figures, which are held to 1e-4
BAR_FP32 = 2.0e-6

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


def stage_shapes(input_bp=BLOCK_BP + 2 * HALO_BP):
    """Per stage: (input length, cin, c, out_pool, resolution) of an encoder
    input of `input_bp` (default: one production group, a 4 Mb block with its
    112 kb halos)."""
    from orca_tpu_torch.nn.encoders import STAGES

    pools = [p for _, _, p in STAGES] + [1]
    res, out = 1, []
    for i, (cin, c, pool) in enumerate(STAGES):
        res *= pool or 1
        out.append((input_bp // res, cin, c, pools[i + 1], res))
    return out


def kernel_phase(torch, enc_params, dtype, peaks, sms, piece_bp=None,
                 rows=2, tag=None):
    """Each kernel against its plain version, then timed; returns {kernel:
    {ms, plain_ms, bound_ms, bound_by, max_abs_err}} summed over the kernel's
    launches in one tower run. piece_bp None: a production group (2 rows of a
    4 Mb block with its halos, row 1 masked as the window's last block); else
    `rows` rows of one `piece_bp` piece, valid everywhere (the 1 Mb model)."""
    from orca_tpu_torch.ops.kernels import conv_chain as cc

    lp, cp = enc_params["lconv"], enc_params["conv"]

    def wb(u):
        return u["w"], u["b"]

    flops_peak = peaks[0] if dtype == torch.bfloat16 else peaks[1]
    esize = torch.finfo(dtype).bits // 8
    rng = np.random.RandomState(SEED)
    seg = piece_bp or BLOCK_BP + 2 * HALO_BP
    tag = tag or ("stage" if piece_bp is None
                  else f"stage{piece_bp // 1_000_000}mb")
    codes = rng.randint(0, 4, size=(rows, seg))
    x = torch.from_numpy(np.eye(4, dtype=np.uint8)[codes] * 4).cuda()
    totals = {}
    for i, (length, cin, c, pool, res) in enumerate(stage_shapes(seg)):
        if piece_bp is None:
            # row 0 valid everywhere; row 1 is the window's last block, whose
            # valid range ends 112 kb early, and starts after a masked halo
            vs = [0, HALO_BP // res]
            ve = [length, (seg - 2 * HALO_BP) // res]
        else:
            vs, ve = [0] * rows, [length] * rows
        vs = torch.tensor(vs, dtype=torch.int32, device="cuda")
        ve = torch.tensor(ve, dtype=torch.int32, device="cuda")
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
              f"{tag} {i}: shape/dtype {got.shape} {got.dtype} vs "
              f"{ref.shape} {ref.dtype}")
        d = (got.float() - ref.float()).abs().max().item()
        m = ref.float().abs().max().item()
        check(np.isfinite(d) and np.isfinite(m), f"{tag} {i}: non-finite")
        tol = 1e-4 * max(1.0, m) if dtype == torch.float32 else 2e-2 * m
        reps = 5 if length > 100_000 else 20
        ms = time_ms(torch, lambda: kern(*args, **kw), reps)
        plain_ms = time_ms(torch, lambda: plain(*args, **kw), reps)
        ops = (2 * 9 * sum(w.shape[1] * w.shape[2] for w, _ in convs) * rows
               * length)
        nbytes = (x.numel() * x.element_size() + got.numel() * esize
                  + sum((w.numel() + b.numel()) * esize for w, b in convs)
                  + 4 * vs.numel() * 2)
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / peaks[2] * 1e3
        tile = cc.plan_tile(x.shape[0], length, pool, cin, c, dtype, i == 0,
                            sms)
        blocks = x.shape[0] * -(-length // tile)
        print(f"  {tag} {i} {name} {str(dtype)[6:]}: in {tuple(x.shape)} "
              f"out {tuple(got.shape)} max|d| {d:.3e} max|ref| {m:.3e} "
              f"(tol {tol:.3e}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
              f"bound {max(t_ops, t_bytes):.4f} ms "
              f"({ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB) tile {tile} "
              f"blocks {blocks} {ops / ms / 1e9:.1f} TFLOP/s "
              f"{max(t_ops, t_bytes) / ms:.1%} of bound", flush=True)
        check(d <= tol, f"{tag} {i} {name}: max|d| {d} > {tol}")
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


def host_starts_256(geom, mpos, wpos, chrlen):
    """Forward zoom starts (finest bins) of the 256 Mb cascade recomputed on
    the host in float32, proposals clamped to [0, chrlen - span/2]."""
    f32 = np.float32
    halfwin, binw = f32(geom.window_bp / 2.0), f32(geom.bin_bp)
    mpos, wpos, chrlen = f32(mpos), f32(wpos), f32(chrlen)
    sb, out = 0, []
    for j in range(4):
        out.append(sb)
        factor = geom.bins // (geom.crop * 2**j)
        span = f32(geom.crop * geom.bin_bp) * f32(factor)
        prop = (mpos - span / f32(4)) - ((wpos - halfwin) + f32(sb) * binw)
        b0 = f32(0.0) - (wpos - halfwin)
        b1 = (chrlen - span / f32(2)) - (wpos - halfwin)
        prop = min(max(prop, b0), b1) if b0 < b1 else b0
        sb += int(np.clip(np.floor(prop / (binw * f32(factor))), 0,
                          geom.half)) * factor
    return out


def cascade256_phase(torch, cc, bundle, seq, normmat, chrlen, targets, geom):
    """genomepredict_256mb per zoom target, the launch counters set to 0
    before each request and checked after it; returns (outputs, seconds
    each, launches summed over the requests)."""
    from orca_tpu_torch.nn.encoders import fused_group_count
    from orca_tpu_torch.predict.multiscale import genomepredict_256mb

    groups = fused_group_count(2, geom.window_bp)
    want = {"fused_first_stage": groups, "fused_conv_chain": 6 * groups}
    outs, secs = [], []
    total = dict.fromkeys(want, 0)
    for mpos in targets:
        cc.fused_first_stage.launches = 0
        cc.fused_conv_chain.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = genomepredict_256mb(seq, "chrM", [normmat], chrlen, mpos,
                                  WPOS_256, [bundle], padding_chr="chr1",
                                  geometry=geom)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        counts = {"fused_first_stage": cc.fused_first_stage.launches,
                  "fused_conv_chain": cc.fused_conv_chain.launches}
        check(counts == want, f"256 Mb request at {mpos}: launches {counts} "
              f"!= {want}")
        for k in total:
            total[k] += counts[k]
        starts = [int(WPOS_256 - geom.window_bp // 2 + s * geom.bin_bp)
                  for s in host_starts_256(geom, mpos, WPOS_256, chrlen)]
        check(out["start_coords"] == starts,
              f"256 Mb zoom starts {out['start_coords']} != host float32 "
              f"{starts}")
        check(max(out["end_coords"]) <= chrlen,
              f"end coordinates {out['end_coords']} past {chrlen}")
        for j, p in enumerate(out["predictions"][0]):
            check(p.shape == (geom.crop, geom.crop), f"level {j}: {p.shape}")
            check(np.isfinite(p).all(), f"256 Mb level {j}: non-finite map")
            check(np.array_equal(p, p.T), f"256 Mb level {j}: not symmetric")
        outs.append(out)
    return outs, secs, total


FP32_BAR = 2.0e-6  # the port's fp32 parity bar (max|d| of the maps)
# the phase-4b meshes: cuda:0 named 2 and 4 times; each computes what a mesh
# of distinct cards computes, one shard after another
SHARD_MESHES = ((1, 2), (2, 2))


def shard_groups(geom, shape, rows=2):
    """Tower groups (so each fused kernel's launches) of a sharded request:
    each of the seq shards runs the tower on its rows with its halos."""
    from orca_tpu_torch.nn.encoders import fused_group_count

    n_data = shape[0] if rows % shape[0] == 0 else 1
    local = geom.window_bp // shape[1]
    return n_data * shape[1] * fused_group_count(rows // n_data,
                                                 local + 2 * HALO_BP)


def counters(cc):
    return {"fused_first_stage": cc.fused_first_stage.launches,
            "fused_conv_chain": cc.fused_conv_chain.launches}


def reset_counters(cc):
    cc.fused_first_stage.launches = 0
    cc.fused_conv_chain.launches = 0


def max_map_diff(got, want):
    return max(float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
               for a, b in zip(got["predictions"][0], want["predictions"][0]))


def shard_bound_kernels(torch, cc, enc_params, dtype,
                        seg=BLOCK_BP + 2 * HALO_BP):
    """Each kernel against its plain version on one tower group at the
    bounds only a sharded tower gives it: row 0 is shard 0's first block
    (valid from 224 kb: the shard's halo and the block's are both past the
    sequence's start), row 1 the last shard's last block at (1, 2) of a
    32 Mb window (valid up to 224 kb); `seg` is a block with its halos
    (4.224 Mb inference pieces, 1.024 Mb training ones). Returns the
    largest max|d|."""
    lp, cp = enc_params["lconv"], enc_params["conv"]

    def wb(u):
        return u["w"], u["b"]

    codes = np.random.RandomState(SEED + 7).randint(0, 4, size=(2, seg))
    x = torch.from_numpy(np.eye(4, dtype=np.uint8)[codes] * 4).cuda()
    worst = 0.0
    for i, (length, _, _, pool, res) in enumerate(stage_shapes(seg)):
        vs = torch.tensor([2 * HALO_BP // res, 0], dtype=torch.int32,
                          device="cuda")
        ve = torch.tensor([length, 2 * HALO_BP // res], dtype=torch.int32,
                          device="cuda")
        convs = [wb(lp[i][0]), wb(lp[i][1]), wb(cp[i][0]), wb(cp[i][1])]
        if i == 0:
            kw = dict(relus=(False, True, True), residual_idx=0, out_pool=pool)
            args = (x, convs[0], convs[1:], vs, ve)
            kern, plain = cc.fused_first_stage, cc.fused_first_stage_plain
        else:
            kw = dict(relus=(False, False, True, True),
                      residual_idx=1 if i < 6 else -1, out_pool=pool)
            args = (x, convs, vs, ve)
            kern, plain = cc.fused_conv_chain, cc.fused_conv_chain_plain
        got, ref = kern(*args, **kw), plain(*args, **kw)
        d = (got.float() - ref.float()).abs().max().item()
        m = ref.float().abs().max().item()
        tol = 1e-4 * max(1.0, m) if dtype == torch.float32 else 2e-2 * m
        check(d <= tol, f"shard bounds stage {i} {dtype}: max|d| {d} > {tol}")
        worst = max(worst, d)
        x = got
    return worst


def same_current_device(torch, before, tag):
    """A sharded call launches on each shard's card and must give the
    caller's current device back: an unindexed "cuda" later resolves to
    it."""
    after = torch.cuda.current_device()
    check(after == before, f"{tag}: the current CUDA device went from "
          f"{before} to {after}")


def sharded_phase(torch, cc, bundles, seq, geom, refs, noise):
    """Phase 4b: `genomepredict` with a (1, 2) and a (2, 2) mesh of cuda:0,
    bf16 and fp32, each held to the unsharded request (`refs`) at the same
    zoom target: starts equal, fp32 max|d| <= FP32_BAR, bf16 within twice
    the unsharded request's own bf16-vs-fp32 difference (`noise`); the
    launch counters set to 0 before each request and checked against the
    shards' group plan. Then each kernel at the edge shards' bounds, and the
    fp32 tower alone sharded and unsharded, the sharded one under CUDA's
    sync debug mode "error" (no host wait between shards). Each sharded
    call must leave the thread's current CUDA device as it found it.
    Returns the launches per dtype."""
    from orca_tpu_torch.nn.encoders import apply_encoder_tower
    from orca_tpu_torch.parallel import make_mesh, sharded_encoder_tower
    from orca_tpu_torch.predict.multiscale import genomepredict

    card = torch.device("cuda", 0)
    wpos = geom.window_bp // 2
    totals = {dtype: dict.fromkeys(KERNEL_INFO, 0) for dtype in bundles}
    for shape in SHARD_MESHES:
        mesh = make_mesh(shape, devices=[card] * (shape[0] * shape[1]))
        groups = shard_groups(geom, shape)
        want = {"fused_first_stage": groups, "fused_conv_chain": 6 * groups}
        for dtype, bundle in bundles.items():
            reset_counters(cc)
            torch.cuda.synchronize()
            current = torch.cuda.current_device()
            t0 = time.perf_counter()
            out = genomepredict(seq, "chrSynthetic", ZOOM_TARGETS[0], wpos,
                                [bundle], geometry=geom, mesh=mesh)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            same_current_device(torch, current, f"sharded {shape} {dtype}")
            counts = counters(cc)
            for k, v in counts.items():
                totals[dtype][k] += v
            d = max_map_diff(out, refs[dtype])
            bar = FP32_BAR if dtype == torch.float32 else 2 * noise
            print(f"sharded {shape} {dtype}: {secs:.4f} s (unsharded "
                  f"{refs[dtype]['seconds']:.4f} s), launches {counts} "
                  f"(expected {want}), max|d| vs unsharded {d:.3e} (bar "
                  f"{bar:.3e}), starts {out['start_coords']}", flush=True)
            check(counts == want, f"sharded {shape} {dtype}: launches "
                  f"{counts} != {want}")
            check(out["start_coords"] == refs[dtype]["start_coords"],
                  f"sharded {shape} {dtype}: starts {out['start_coords']} != "
                  f"{refs[dtype]['start_coords']}")
            check(d <= bar, f"sharded {shape} {dtype}: max|d| {d} > {bar}")
    for dtype, bundle in bundles.items():
        worst = shard_bound_kernels(torch, cc, bundle.encoder, dtype)
        print(f"shard-bound kernels {dtype}: max|d| vs plain {worst:.3e}",
              flush=True)
    bundle = bundles[torch.float32]
    seq2 = torch.from_numpy(seq).cuda()
    seq2 = torch.cat([seq2, torch.flip(seq2, dims=(1, 2))])
    mesh = make_mesh((1, 2), devices=[card] * 2)
    with torch.inference_mode():
        want = apply_encoder_tower(bundle.encoder, seq2, halo_bp=HALO_BP)
        torch.cuda.synchronize()
        current = torch.cuda.current_device()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t0 = time.perf_counter()
            got = sharded_encoder_tower(bundle.encoder, seq2, mesh,
                                        halo_bp=HALO_BP)
            queued = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        same_current_device(torch, current, "sharded tower")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        t0 = time.perf_counter()
        apply_encoder_tower(bundle.encoder, seq2, halo_bp=HALO_BP)
        torch.cuda.synchronize()
        one = time.perf_counter() - t0
        d = (got - want).abs().max().item()
        m = want.abs().max().item()
    print(f"sharded tower fp32 (1, 2): {tuple(got.shape)} max|d| vs "
          f"unsharded {d:.3e} (max|ref| {m:.3e}); host queued the shards in "
          f"{queued:.4f} s with no sync, done at {total:.4f} s; unsharded "
          f"{one:.4f} s", flush=True)
    check(got.shape == want.shape and d <= FP32_BAR * max(1.0, m),
          f"sharded tower: max|d| {d}")
    return totals


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def read_trace(path, window_name="request"):
    """From a Chrome trace: the window of the `window_name` annotation, the
    device's busy time inside it (the union of kernel, memcpy and memset
    intervals), the top 5 device operations by summed time with their
    counts, the 5 longest idle gaps, each with the innermost host op or
    annotation active when it began (`during`), the annotations around it
    (`in`) and the first host ops that began inside it (`then`), and the
    idle time by gap length. Times in ms."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e["name"] == window_name
           and e.get("cat") == "user_annotation"]
    check(len(win) == 1, f"trace: {len(win)} '{window_name}' windows")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    check(dev, "trace: no device operation inside the request")
    busy = _merged((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in dev)
    busy_us = sum(b - a for a, b in busy)
    ops = {}
    for e in dev:
        o = ops.setdefault(e["name"][:90], [0, 0.0])
        o[0] += 1
        o[1] += e["dur"]
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:5]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    out_gaps = []
    for dur, start in sorted(gaps, reverse=True)[:5]:
        active = [e for e in host if e["ts"] <= start < e["ts"] + e["dur"]]
        inner = min(active, key=lambda e: e["dur"])["name"] if active else "-"
        outer = [e["name"] for e in sorted(active, key=lambda e: -e["dur"])
                 if e.get("cat") == "user_annotation"]
        then = sorted((e for e in host if start < e["ts"] < start + dur),
                      key=lambda e: e["ts"])
        out_gaps.append({"ms": round(dur / 1e3, 4),
                         "at_ms": round((start - w0) / 1e3, 4),
                         "during": inner, "in": outer[:4],
                         "then": [e["name"][:60] for e in then[:4]]})
    by_length = {"under_0.05ms": [0, 0.0], "0.05_1ms": [0, 0.0],
                 "over_1ms": [0, 0.0]}
    for dur, _ in gaps:
        key = ("under_0.05ms" if dur < 50 else "0.05_1ms" if dur <= 1000
               else "over_1ms")
        by_length[key][0] += 1
        by_length[key][1] += dur / 1e3
    return {
        "window_ms": (w1 - w0) / 1e3, "device_busy_ms": busy_us / 1e3,
        "idle_share": 1 - busy_us / (w1 - w0),
        "device_ops": len(dev),
        "top_ops": [{"name": k, "count": v[0], "ms": v[1] / 1e3}
                    for k, v in top],
        "gaps": out_gaps,
        "idle_by_gap_length": {k: {"count": v[0], "ms": v[1]}
                               for k, v in by_length.items()},
    }


def profile_phase(torch, ms, bundle, seq, geom, smoke_s, smi):
    """Phase 4c: one warm bf16 32 Mb request traced (`utils.profiling.trace`
    inside a `request` region) with the program's spans on, the device's
    idle share in the request's window read from the Chrome trace, per
    `orca.*` span (`steps`) its calls, host and self ms, launches and the
    device idle ms put down to it as the innermost span open
    (`portbench.program_trace`), the bytes the request copied to the card
    (`h2d_bytes`), and `device_time` of the same request beside the
    smoke's own timer. Prints one JSON line."""
    import tempfile

    from orca_tpu_torch.utils import profiling
    from portbench import program_trace

    wpos = geom.window_bp // 2

    def request():
        return ms.genomepredict(seq, "chrSynthetic", ZOOM_TARGETS[0], wpos,
                                [bundle], geometry=geom)

    request()
    torch.cuda.synchronize()
    previous = profiling.enable(True)
    profiling.take()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_") as tmp:
        try:
            with profiling.trace(tmp) as path:
                t0 = time.perf_counter()
                with torch.profiler.record_function("request"):
                    request()
                torch.cuda.synchronize()
                traced_s = time.perf_counter() - t0
                t0 = time.perf_counter()
            export_s = time.perf_counter() - t0
            took = profiling.take()
        finally:
            profiling.enable(previous)
        found = read_trace(path)
        spans = program_trace.read(path)
        trace_mb = os.path.getsize(path) / 1e6
    timed = profiling.device_time(request, iters=3, warmup=1)
    check({n: s["calls"] for n, s in spans["spans"].items()}
          == {n: s["calls"] for n, s in took["spans"].items()},
          "profile: the trace's spans and the host clock's differ")
    found["steps"] = {
        name: {"calls": s["calls"], "host_ms": 1e3 * s["host_s"],
               "self_ms": 1e3 * took["spans"][name]["self_s"],
               "launches": s["launches"],
               "device_idle_ms": 1e3 * s["idle_s"]}
        for name, s in sorted(spans["spans"].items())}
    found["idle_by_span_ms"] = {k: 1e3 * v
                                for k, v in sorted(spans["idle"].items())}
    found["idle_in_spans_share"] = 1 - (
        spans["idle"].get(program_trace.NONE, 0.0) / spans["idle_s"])
    found["h2d_bytes"] = took["counters"].get("h2d_bytes")
    found.update({"card": smi, "request": "bf16 32 Mb genomepredict, zoom "
                  f"{ZOOM_TARGETS[0]}", "device_time_s": timed,
                  "smoke_request_s": smoke_s, "traced_s": traced_s,
                  "export_s": export_s, "trace_mb": trace_mb})
    check(0.0 < found["idle_share"] < 1.0,
          f"idle share {found['idle_share']} outside (0, 1)")
    check(found["top_ops"] and found["gaps"], "profile: no ops or no gaps")
    check(found["h2d_bytes"] == seq.nbytes,
          f"profile: h2d_bytes {found['h2d_bytes']}, not {seq.nbytes}")
    levels = {f"orca.decode.{lv}" for lv in bundle.decoders}
    check(levels <= set(found["steps"]),
          f"profile: decoder levels {sorted(levels - set(found['steps']))} "
          "have no span in the trace")
    print(json.dumps({"profile": found}), flush=True)
    return found


def peak_rss_gib():
    """The process's peak resident host memory so far (Linux: KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


class Timed:
    """Accumulates the host seconds of the calls to `module.name` while
    installed (the pipelines and cascades look their callees up at call
    time); `_device_sequence` is the one-hot's packing and copy to the
    card. With `sync` False (host code) the clock stops without waiting for
    the card."""

    def __init__(self, torch, module, name, sync=True):
        self.torch, self.module, self.name = torch, module, name
        self.fn, self.seconds, self.calls = getattr(module, name), 0.0, 0
        self.sync = sync

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        if self.sync:
            self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def load_phase(torch, zoo, resources, tmp):
    """Random folded bundles pickled by the port's save_bundle into a model
    dir, then `load_resources` in bf16 onto the card; returns the
    resources."""
    model_dir = os.path.join(tmp, "models")
    resource_dir = os.path.join(tmp, "resources")
    os.makedirs(model_dir)
    os.makedirs(resource_dir)
    t0 = time.perf_counter()
    for name, seed in (("h1esc", SEED), ("hff", SEED + 1)):
        zoo.save_bundle(zoo.fold_bundle(zoo.random_32m_bundle(seed)),
                        os.path.join(model_dir, f"orca_{name}.bundle"))
    for name, seed in (("h1esc_256m", SEED), ("hff_256m", SEED + 1)):
        zoo.save_bundle(zoo.fold_256m_bundle(zoo.random_256m_bundle(seed)),
                        os.path.join(model_dir, f"orca_{name}.bundle"))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = resources.load_resources(models=("32M", "256M"),
                                   model_dir=model_dir,
                                   resource_dir=resource_dir,
                                   dtype="bfloat16")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    names = ["h1esc", "hff", "h1esc_256m", "hff_256m"]
    check(list(res.models) == names, f"load_resources: {list(res.models)}")
    for name in names:
        tensors, keys = tree_leaves(res.models[name], torch)
        check(tensors and all(t.dtype == torch.bfloat16 and t.is_cuda
                              for t in tensors),
              f"{name}: parameters not all bf16 on the card")
        check("bn" not in keys, f"{name}: BatchNorm left in the parameters")
    check(res.genome is None and res.target_available is False,
          "load_resources: a genome or targets without resource files")
    print(f"load_resources: 4 bundles (2 x 32 Mb, 2 x 256 Mb) pickled in "
          f"{save_s:.3f} s, loaded, folded and cast to bf16 on the card in "
          f"{load_s:.3f} s; genome None, target_available False", flush=True)
    return res


def tree_leaves(bundle, torch):
    """(tensors, dict keys) of all of a bundle's fields, nested trees
    walked."""
    tensors, keys = [], set()

    def walk(tree):
        if isinstance(tree, dict):
            keys.update(tree)
            for v in tree.values():
                walk(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                walk(v)
        elif isinstance(tree, torch.Tensor):
            tensors.append(tree)

    for field in dataclasses.fields(bundle):
        walk(getattr(bundle, field.name))
    return tensors, keys


def check_maps(outs, n_levels, tag):
    for i, out in enumerate(outs):
        for m, preds in enumerate(out["predictions"]):
            check(len(preds) == n_levels, f"{tag} output {i}: {len(preds)} maps")
            for j, p in enumerate(preds):
                check(p.shape == (250, 250), f"{tag} {i}/{m}/{j}: {p.shape}")
                check(np.isfinite(p).all(), f"{tag} {i}/{m}/{j}: non-finite")
                check(np.array_equal(p, p.T), f"{tag} {i}/{m}/{j}: asymmetric")


def screens_phase(torch, cc, zoo, genome):
    """`load_resources`, then `process_dup` on a 32 Mb window and
    `process_del` on a whole chromosome with both models of each family, the
    launch counters set to 0 just before each screen and read just after;
    returns the launches summed over both screens."""
    import tempfile

    from orca_tpu_torch.data import native
    from orca_tpu_torch.predict import (multiscale as ms, pipelines,
                                        resources, retrieval)
    from orca_tpu_torch.utils.coords import coord_clip

    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_") as tmp:
        res = load_phase(torch, zoo, resources, tmp)
    total = {"fused_first_stage": 0, "fused_conv_chain": 0}

    def run(tag, fn, want, timers=()):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cc.fused_first_stage.launches = 0
        cc.fused_conv_chain.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {"fused_first_stage": cc.fused_first_stage.launches,
                  "fused_conv_chain": cc.fused_conv_chain.launches}
        parts = "".join(f", {t.name} {t.calls} calls {t.seconds:.3f} s"
                        for t in timers)
        print(f"screen {tag}: seconds {secs:.3f}{parts}, launches {counts} "
              f"(expected {want}), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, peak "
              f"host RSS {peak_rss_gib():.2f} GiB", flush=True)
        check(counts == want, f"screen {tag}: launches {counts} != {want}")
        for k in total:
            total[k] += counts[k]
        return outs

    # 32 Mb: a 0.8 Mb tandem duplication, both models: 3 windows x 2 models
    models32 = res.bundles(["h1esc", "hff"])
    mstart, mend = 60_000_000, 60_800_000
    groups = 3 * 2 * 8
    with Timed(torch, pipelines, "genomepredict") as t_pred, \
            Timed(torch, ms, "_device_sequence") as t_seq, \
            Timed(torch, native, "codes_to_onehot", sync=False) as t_codec:
        outs = run("dup32", lambda: pipelines.process_dup(
            "chrM", mstart, mend, genome, models32),
            {"fused_first_stage": groups, "fused_conv_chain": 6 * groups},
            (t_codec, t_pred, t_seq))
    check(t_codec.calls > 0, "dup32: the genome never ran the codec")
    check(len(outs) == 3, f"process_dup: {len(outs)} outputs")
    check_maps(outs, 6, "dup32")
    # ref.l against a direct genomepredict on the same window (not counted)
    wpos = coord_clip(mstart, genome.chr_len("chrM"))
    direct = ms.genomepredict(
        genome.get_encoding_from_coords("chrM", wpos - 16_000_000,
                                        wpos + 16_000_000)[None],
        "chrM", mstart, wpos, models32)
    check(outs[0]["start_coords"] == direct["start_coords"],
          "dup32 ref.l: zoom starts differ from a direct genomepredict")
    d = max(np.abs(a - b).max() for pa, pb in zip(outs[0]["predictions"],
                                                  direct["predictions"])
            for a, b in zip(pa, pb))
    m = max(np.abs(b).max() for pb in direct["predictions"] for b in pb)
    print(f"  dup32 ref.l vs a direct genomepredict: max|d| {d:.3e} "
          f"max|ref| {m:.3e}", flush=True)
    check(d <= 1e-4 * max(1.0, m), f"dup32 ref.l: max|d| {d}")
    del outs, direct

    # 256 Mb: a 2 Mb deletion, both models: 3 requests x 2 models
    models256 = res.bundles(["h1esc_256m", "hff_256m"])
    mstart, mend = 60_000_000, 62_000_000
    groups = 3 * 2 * 64
    with Timed(torch, retrieval, "retrieve_multi") as t_ret, \
            Timed(torch, pipelines, "genomepredict_256mb") as t_pred, \
            Timed(torch, ms, "_device_sequence") as t_seq, \
            Timed(torch, native, "codes_to_onehot", sync=False) as t_codec:
        t0 = time.perf_counter()
        outs = run("del256", lambda: pipelines.process_del(
            "chrM", mstart, mend, genome, models256,
            window_radius=128_000_000, padding_chr="chr1"),
            {"fused_first_stage": groups, "fused_conv_chain": 6 * groups},
            (t_codec, t_ret, t_pred, t_seq))
        secs = time.perf_counter() - t0
    check(t_codec.calls > 0 and t_ret.calls > 0,
          "del256: the genome never ran the codec or retrieve_multi")
    print(f"  del256 codec: {t_codec.seconds:.3f} s, "
          f"{t_codec.seconds / t_ret.seconds:.1%} of retrieve_multi's "
          f"{t_ret.seconds:.3f} s, {t_codec.seconds / secs:.1%} of the "
          f"screen's {secs:.3f} s", flush=True)
    chrlen = genome.chr_len("chrM")
    alt = chrlen - (mend - mstart)
    limits = [chrlen - chrlen % 32000] * 2 + [alt - alt % 32000]
    check(len(outs) == 3, f"process_del: {len(outs)} outputs")
    check_maps(outs, 4, "del256")
    for out, limit in zip(outs, limits):
        check(max(out["end_coords"]) <= limit,
              f"del256: end coordinates {out['end_coords']} past {limit}")
        check(out["padding_chr"] == "chr1", f"del256: {out['padding_chr']}")
    print(f"  del256 end coordinates {[o['end_coords'] for o in outs]} "
          f"(chromosome {limits}), padding_chr chr1", flush=True)
    return total


def check_1m(pred, tracks, n, num_1d, tag):
    bins = ONE_MB_WINDOW // 4000
    check(pred.shape == (n, bins, bins, 1), f"{tag}: map {pred.shape}")
    check(np.isfinite(pred).all(), f"{tag}: non-finite map")
    check(np.array_equal(pred, pred.transpose(0, 2, 1, 3)),
          f"{tag}: map not symmetric")
    if tracks is not None:
        check(tracks.shape == (n, bins, num_1d),
              f"{tag}: tracks {tracks.shape}")
        check(((tracks >= 0) & (tracks <= 1)).all(),
              f"{tag}: tracks outside [0, 1]")


def onemb_phase(torch, cc, zoo, genome, peaks, sms):
    """The standalone 1 Mb family on windows of the phase-5 genome: the
    kernels at its stage shapes, the unfolded bundle refused, then
    `screen_windows` (bf16), `predict_1m` with tracks and the reverse
    complement (bf16) and one fp32 call, the launch counters set to 0 just
    before each call and read just after; then one window on the card
    against the CPU plain path. Returns {dtype: launches}."""
    from orca_tpu_torch.nn import encoders
    from orca_tpu_torch.predict import multiscale, onemb

    num_1d, window = 32, ONE_MB_WINDOW
    starts = [10_000_000 + 7_000_000 * k for k in range(8)]
    seqs = np.stack([genome.get_encoding_from_coords("chrM", s, s + window)
                     for s in starts])
    raw = zoo.random_1m_bundle(SEED, num_1d=num_1d)
    fp32 = zoo.fold_1m_bundle(raw)
    bf16 = zoo.cast_bundle(fp32, "bfloat16")

    # each kernel at the 1 Mb stage shapes: 4 windows and their reverse
    # complements, one piece per row
    for dtype, bundle in ((torch.bfloat16, bf16), (torch.float32, fp32)):
        print(f"kernels {dtype} at the 1 Mb stage shapes:", flush=True)
        rows = kernel_phase(torch, bundle.net["encoder"], dtype, peaks, sms,
                            piece_bp=window, rows=8)
        print(f"kernels1m {str(dtype)[6:]}: " + "; ".join(
            f"{name} kernel {t['ms']:.3f} ms plain {t['plain_ms']:.3f} ms "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) max|d| "
            f"{t['max_abs_err']:.3e}" for name, t in rows.items()), flush=True)

    def counts():
        return {"fused_first_stage": cc.fused_first_stage.launches,
                "fused_conv_chain": cc.fused_conv_chain.launches}

    before = counts()
    try:
        onemb.predict_1m(raw, seqs[:4])
    except ValueError as e:
        print(f"unfolded 1 Mb bundle on the card: refused ({e})", flush=True)
    else:
        raise PhaseError("an unfolded 1 Mb bundle ran on the card")
    check(counts() == before, "the refused 1 Mb call launched a kernel")
    del raw

    launches = {torch.bfloat16: dict.fromkeys(before, 0),
                torch.float32: dict.fromkeys(before, 0)}

    def run(tag, dtype, calls, fn):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cc.fused_first_stage.launches = 0
        cc.fused_conv_chain.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = counts()
        want = {"fused_first_stage": calls, "fused_conv_chain": 6 * calls}
        print(f"onemb {tag}: seconds {secs:.3f}, launches {got} (expected "
              f"{want}), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        check(got == want, f"onemb {tag}: launches {got} != {want}")
        for k in got:
            launches[dtype][k] += got[k]
        return out, secs

    screen, secs = run("screen_windows bf16 (8 windows, batch 4)",
                       torch.bfloat16, 2,
                       lambda: onemb.screen_windows(bf16, seqs, batch_size=4))
    check_1m(screen, None, 8, num_1d, "screen_windows")
    print(f"  screen_windows: {secs / len(seqs):.4f} s per window", flush=True)
    with Timed(torch, multiscale, "_device_sequence") as t_seq:
        (pred, tracks), secs = run(
            "predict_1m bf16 (4 windows, tracks, RC average)", torch.bfloat16,
            1, lambda: onemb.predict_1m(bf16, seqs[:4], with_1d=True,
                                        rc_average=True))
    check_1m(pred, tracks, 4, num_1d, "predict_1m bf16")
    # the split of that call: the tower alone on the same 8 rows (not
    # counted); the rest is the decoder, the track head and the RC average
    x = multiscale._device_sequence(seqs[:4], "cuda")
    x = torch.cat([x, torch.flip(x, dims=(1, 2))])
    tower_s = []
    with torch.inference_mode():
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            encoders.apply_encoder_tower(bf16.net["encoder"], x)
            torch.cuda.synchronize()
            tower_s.append(time.perf_counter() - t0)
    del x
    print(f"  predict_1m bf16: {secs / 4:.4f} s per window; split: call "
          f"{secs:.4f} s = one-hot checks, packing and copy "
          f"{t_seq.seconds:.4f} s + tower {min(tower_s):.4f} s + decoder, "
          f"head, RC average and outputs "
          f"{secs - t_seq.seconds - min(tower_s):.4f} s", flush=True)
    pred32, secs = run("predict_1m fp32 (4 windows)", torch.float32, 1,
                       lambda: onemb.predict_1m(fp32, seqs[:4]))
    check_1m(pred32, None, 4, num_1d, "predict_1m fp32")
    d = np.abs(pred32 - screen[:4]).max()
    print(f"  predict_1m fp32: {secs / 4:.4f} s per window; fp32 vs bf16 "
          f"max|d| {d:.3e} max|fp32| {np.abs(pred32).max():.3e}", flush=True)

    # one full window on the card against the CPU plain path (not counted)
    cpu_b = zoo._map_params(fp32, lambda t: t.cpu())
    a = onemb.predict_1m(fp32, seqs[:1], with_1d=True, rc_average=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(len(os.sched_getaffinity(0)))
    t0 = time.perf_counter()
    b = onemb.predict_1m(cpu_b, seqs[:1], with_1d=True, rc_average=True,
                         device="cpu")
    cpu_s = time.perf_counter() - t0
    torch.set_num_threads(threads)
    for got, ref, what in zip(a, b, ("map", "tracks")):
        d = np.abs(got - ref).max()
        m = np.abs(ref).max()
        print(f"1 Mb window fp32 card vs CPU plain ({what}): max|d| {d:.3e} "
              f"max|ref| {m:.3e} (CPU {cpu_s:.1f} s)", flush=True)
        check(d <= 1e-4 * max(1.0, m), f"1 Mb window {what}: max|d| {d}")
    return launches


SERVE_GENOME = (("chr8", 34_000_000), ("chr9", 34_000_000))
GENOME_STEM = "Homo_sapiens.GRCh38.dna.primary_assembly"
# command, coordinate, windows of the pipeline (each runs both models)
SERVE_COMMANDS = (
    ("region", "chr9:10,000,000-11,000,000", 1),
    ("dup", "chr8:10,000,000-10,800,000", 3),
    ("del", "chr8:20,000,000-21,000,000", 3),
    ("inv", "chr9:15,000,000-16,000,000", 4),
    ("break", "chr8:20,000,000|chr9:14,000,000|+-", 3),
)


def write_fasta(path, chroms, seed):
    """A FASTA of random ACGT chromosomes with an N run and a lowercase run
    each, in 60-letter lines."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGTacgtN", dtype=np.uint8)
    with open(path, "wb") as f:
        for name, n in chroms:
            codes = rng.integers(0, 4, n, dtype=np.uint8)
            codes[1_000_000:1_100_000] = 8
            codes[2_000_000:2_100_000] += 4
            body = letters[codes]
            rows = -(-n // 60)
            text = np.full((rows, 61), ord("\n"), dtype=np.uint8)
            letters_60 = np.zeros(rows * 60, dtype=np.uint8)
            letters_60[:n] = body
            text[:, :60] = letters_60.reshape(rows, 60)
            # the last line holds the remaining letters
            cut = (rows - 1) * 61 + (n - (rows - 1) * 60)
            f.write(f">{name}\n".encode())
            f.write(text.reshape(-1)[:cut].tobytes() + b"\n")


def serve_phase(torch, cc, zoo):
    """The warm server through the command line a user runs: `build-genome`
    on a synthetic FASTA, two random folded 32 Mb bundles pickled, then
    `serve --prewarm 32M` in bf16 in this process, reading the five
    prediction modes, a malformed line and `quit`; each command's launch
    counts set to 0 just before it and read just after. Returns the
    launches summed over the commands."""
    import io
    import pickle
    import tempfile

    from orca_tpu_torch import cli, viz
    from orca_tpu_torch.nn.encoders import fused_group_count
    from orca_tpu_torch.predict import multiscale as ms, pipelines, resources
    from orca_tpu_torch.utils.config import get_config

    groups = fused_group_count(2, 32_000_000)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_") as tmp:
        model_dir = os.path.join(tmp, "models")
        resource_dir = os.path.join(tmp, "resources")
        out_dir = os.path.join(tmp, "out")
        for d in (model_dir, resource_dir, out_dir):
            os.makedirs(d)
        fasta = os.path.join(tmp, "genome.fa")
        t0 = time.perf_counter()
        write_fasta(fasta, SERVE_GENOME, SEED + 5)
        write_s = time.perf_counter() - t0
        memmap = os.path.join(resource_dir, f"{GENOME_STEM}.codes.mmap")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            check(cli.main(["build-genome", fasta, memmap]) == 0,
                  "build-genome failed")
        build_s = time.perf_counter() - t0
        os.remove(fasta)
        print(f"build-genome: {sum(n for _, n in SERVE_GENOME) / 1e6:.0f} Mb "
              f"FASTA written in {write_s:.3f} s, converted in {build_s:.3f} "
              f"s ({said.getvalue().strip()!r})", flush=True)
        for name, seed in (("h1esc", SEED), ("hff", SEED + 1)):
            zoo.save_bundle(zoo.fold_bundle(zoo.random_32m_bundle(seed)),
                            os.path.join(model_dir, f"orca_{name}.bundle"))

        lines = [f"{mode} {coord} {os.path.join(out_dir, mode)} --no-target"
                 for mode, coord, _ in SERVE_COMMANDS]
        lines.insert(2, f"region chr9:10000000 {out_dir}/bad --no-target")
        stdin = io.StringIO("\n".join(lines + ["quit", ""]))

        # the card's machine has no matplotlib: the two drawing functions
        # are replaced by a recorder of the files they would write
        plots = []

        def record_plot(output, file=None, **kw):
            plots.append(os.path.relpath(file, out_dir))

        loaded, commands = [], []
        real_load, real_run = resources.load_resources, cli._run_prediction

        def load(**kw):
            loaded.append(real_load(**kw))
            return loaded[-1]

        def run(args, parser, res=None):
            cc.fused_first_stage.launches = 0
            cc.fused_conv_chain.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real_run(args, parser, res=res)  # the malformed line raises
            torch.cuda.synchronize()
            commands.append((args.command, time.perf_counter() - t0, {
                "fused_first_stage": cc.fused_first_stage.launches,
                "fused_conv_chain": cc.fused_conv_chain.launches}))
            return out

        class Stamped(io.StringIO):
            """Stdout that keeps the time of each line's arrival."""

            def __init__(self):
                super().__init__()
                self.stamps = []

            def write(self, s):
                self.stamps += [(time.perf_counter(), x)
                                for x in s.splitlines() if x]
                return super().write(s)

        cfg = get_config()
        saved = (cfg.param_dtype, viz.genomeplot, viz.genomeplot_256mb,
                 resources.load_resources, cli._run_prediction, sys.stdin)
        print("serve: viz.genomeplot and viz.genomeplot_256mb replaced by a "
              "recorder of file names (no matplotlib on this machine)",
              flush=True)
        out = Stamped()
        try:
            cfg.param_dtype = "bfloat16"  # the serving precision
            viz.genomeplot = viz.genomeplot_256mb = record_plot
            resources.load_resources, cli._run_prediction = load, run
            sys.stdin = stdin
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    Timed(torch, pipelines, "genomepredict") as t_pred, \
                    Timed(torch, ms, "_device_sequence") as t_seq:
                rc = cli.main(["serve", "--model-dir", model_dir,
                               "--resource-dir", resource_dir,
                               "--prewarm", "32M"])
        finally:
            (cfg.param_dtype, viz.genomeplot, viz.genomeplot_256mb,
             resources.load_resources, cli._run_prediction,
             sys.stdin) = saved
        said = [x for _, x in out.stamps]
        for x in said:
            print(f"  serve| {x}", flush=True)
        check(rc == 0, f"serve returned {rc}")
        status = [x.split()[0] for x in said
                  if x.split()[0] in ("WARM", "READY", "OK", "ERR")]
        check(status == ["WARM", "READY", "OK", "OK", "ERR", "OK", "OK", "OK"],
              f"serve status lines {status}")
        ready_s = next(t for t, x in out.stamps if x == "READY") - t0
        warm_s = float(next(x for x in said if x.startswith("WARM"))
                       .split()[2].rstrip("s"))
        check(len(loaded) == 1, f"{len(loaded)} resource loads")
        res = loaded[0]
        for name in ("h1esc", "hff"):
            tensors, keys = tree_leaves(res.models[name], torch)
            check(all(t.dtype == torch.bfloat16 and t.is_cuda
                      for t in tensors) and "bn" not in keys,
                  f"served {name}: not folded bf16 on the card")
        check(plots, "no plot was asked for")
        print(f"  plots recorded ({len(plots)}): {plots}", flush=True)

        total = {"fused_first_stage": 0, "fused_conv_chain": 0}
        check([c[0] for c in commands] == [m for m, _, _ in SERVE_COMMANDS],
              f"commands run {[c[0] for c in commands]}")
        for (mode, _, got), (_, _, windows) in zip(commands, SERVE_COMMANDS):
            n = windows * 2 * groups
            want = {"fused_first_stage": n, "fused_conv_chain": 6 * n}
            check(got == want, f"serve {mode}: launches {got} != {want}")
            for k in total:
                total[k] += got[k]
        outs = {}
        for mode, _, windows in SERVE_COMMANDS:
            with open(os.path.join(out_dir, mode, "orca_pred.pkl"), "rb") as f:
                outs[mode] = pickle.load(f)
            got = outs[mode] if mode != "region" else [outs[mode]]
            check(len(got) == windows, f"{mode}.pkl: {len(got)} outputs")
            check_maps(got, 6, f"serve {mode}")

        # the region .pkl against a direct process_region on the same
        # bundles (not counted)
        direct = pipelines.process_region(
            "chr9", 10_000_000, 11_000_000, res.genome,
            res.bundles(["h1esc", "hff"]))
        check(outs["region"]["start_coords"] == direct["start_coords"],
              "served region: zoom starts differ from process_region")
        d = max(np.abs(a - b).max()
                for pa, pb in zip(outs["region"]["predictions"],
                                  direct["predictions"])
                for a, b in zip(pa, pb))
        m = max(np.abs(b).max() for pb in direct["predictions"] for b in pb)
        print(f"  served region .pkl vs a direct process_region: max|d| "
              f"{d:.3e} max|ref| {m:.3e}", flush=True)
        check(d <= 1e-4 * max(1.0, m), f"served region: max|d| {d}")
    secs = {mode: round(s, 4) for mode, s, _ in commands}
    print(f"serve: READY after {ready_s:.3f} s (WARM 32M {warm_s} s), "
          f"commands {secs} seconds (first {commands[0][1]:.3f} s, the rest "
          f"{statistics.mean(s for _, s, _ in commands[1:]):.3f} s on "
          f"average; in all: genomepredict {t_pred.calls} calls "
          f"{t_pred.seconds:.3f} s, of which _device_sequence {t_seq.calls} "
          f"calls {t_seq.seconds:.3f} s), launches {total}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, peak host RSS "
          f"{peak_rss_gib():.2f} GiB", flush=True)
    return total


CHECKPOINT_MODELS = ("h1esc", "hff", "hctnoc", "h1esc_1m", "hff_1m",
                     "h1esc_256m", "hff_256m", "leukemiaA", "leukemiaB")
CHECKPOINT_ROUNDS = 5  # timed requests of each family after the first


def random_bn(torch, tree, gen):
    """A parameter tree with every BatchNorm's statistics drawn from `gen`
    (so folding is not the identity)."""
    if isinstance(tree, dict):
        out = {k: random_bn(torch, v, gen) for k, v in tree.items()}
        if "bn" in tree:
            c, dev = tree["b"].numel(), tree["b"].device

            def u(lo, hi):
                return (torch.rand(c, generator=gen) * (hi - lo) + lo).to(dev)

            out["bn"] = {"scale": u(0.8, 1.2), "bias": u(-0.1, 0.1),
                         "mean": u(-0.1, 0.1), "var": u(0.8, 1.2)}
        return out
    if isinstance(tree, list):
        return [random_bn(torch, v, gen) for v in tree]
    return tree


def checkpoint_sources(torch, zoo):
    """Seeded random port bundles (unfolded, float32, on the card) of every
    family, laid out as the released models are: each 1 Mb model is its
    32 Mb model's stage-a Net (tower and `Decoder_1m`) with a 1D head, each
    256 Mb model takes its 32 Mb model's tower and pyramid."""
    gen = torch.Generator().manual_seed(SEED + 9)

    def bn(bundle):
        return dataclasses.replace(bundle, **{
            f.name: random_bn(torch, getattr(bundle, f.name), gen)
            for f in dataclasses.fields(bundle)
            if isinstance(getattr(bundle, f.name), dict)})

    src = {}
    for k, (name, num_1d) in enumerate((("h1esc", 32), ("hff", 22))):
        b32 = bn(zoo.random_32m_bundle(SEED + k, name=name))
        head = bn(zoo.random_1m_bundle(SEED + k, num_1d=num_1d,
                                       name=f"{name}_1m"))
        src[name] = b32
        src[f"{name}_1m"] = dataclasses.replace(head, net=dict(
            head.net, encoder=b32.encoder, decoder=b32.decoder_1pt))
        src[f"{name}_256m"] = dataclasses.replace(
            bn(zoo.random_256m_bundle(SEED + k, name=f"{name}_256m")),
            encoder=b32.encoder, pyramid1=b32.pyramid)
    src["hctnoc"] = bn(zoo.random_32m_bundle(
        SEED + 2, name="hctnoc", upsample_mode="nearest", up_pass=False))
    src["leukemiaA"] = bn(zoo.random_leukemia_bundle(SEED + 3, 2,
                                                     name="leukemiaA"))
    src["leukemiaB"] = bn(zoo.random_leukemia_bundle(SEED + 4, 6,
                                                     name="leukemiaB"))
    return src


def write_checkpoints(torch, zoo, src, model_dir, resource_dir):
    """The sources as reference-format statedicts, and expectation files
    from which the loaders rebuild the sources' backgrounds exactly."""
    from orca_tpu_torch.models import convert

    def save(sd, stem):
        torch.save({f"module.{k}": v for k, v in sd.items()},
                   os.path.join(model_dir, f"orca_{stem}.statedict"))

    for name in ("h1esc", "hff", "hctnoc", "leukemiaA", "leukemiaB"):
        b = src[name]
        save(convert.pyramid_statedict(b.pyramid, 5, b.pyramid_up_pass),
             f"{name}.net")
        # net0 is the whole stage-a Net: HCTnoc's `Decoder_1m` and the 1D
        # heads of the models without a 1 Mb family are written, not read
        head = src.get(f"{name}_1m", src["h1esc_1m"])
        net = dict(head.net, encoder=b.encoder)
        if b.decoder_1pt is not None:
            net["decoder"] = b.decoder_1pt
        save(convert.net_statedict(net, head.num_1d, b.num_2d),
             f"{name}.net0")
        for lv, p in b.decoders.items():
            save(convert.decoder_statedict(p, b.num_2d), f"{name}.d{lv}")
    for name in ("h1esc_256m", "hff_256m"):
        b = src[name]
        save(convert.pyramid_statedict(b.pyramid, 3, True), f"{name}.net")
        for lv, p in b.decoders.items():
            save(convert.decoder_statedict(p), f"{name}.d{lv}")

    # the random bundles' expectations (models/zoo.py)
    d = np.arange(8000, dtype=np.float64)
    files = {f: -1.5 * np.log1p(d) - 2.0 for f in zoo._EXPECTED_FILES.values()}
    for name in ("leukemiaA", "leukemiaB"):
        for i, f in enumerate(zoo._LEUKEMIA_NORMMAT_FILES[name]):
            files[f] = -1.5 * np.log1p(d) - 2.0 - 0.1 * i
    for stem in zoo._STEMS.values():
        prefix = f"{stem}.rebinned.mcool.expected"
        files[f"{prefix}.res1000.npy"] = -1.0 * np.log1p(d[:1000]) - 2.0
        files[f"{prefix}.res32000.mono.npy"] = -1.2 * np.log1p(d) - 3.0
        files[f"{prefix}.res32000.trans.npy"] = np.array(-9.0)
    for f, v in files.items():
        np.save(os.path.join(resource_dir, f), v)


PARAM_FIELDS = ("encoder", "pyramid1", "pyramid", "decoders", "decoder_1pt",
                "net")


def max_param_diff(torch, got, want):
    """max|d| over two bundles' parameter tensors, walked in parallel; a
    structure, shape, dtype or device mismatch fails the phase."""
    worst = 0.0

    def walk(g, w, where):
        nonlocal worst
        if isinstance(w, dict):
            check(isinstance(g, dict) and sorted(g, key=str)
                  == sorted(w, key=str), f"{where}: keys differ")
            for k in w:
                walk(g[k], w[k], f"{where}.{k}")
        elif isinstance(w, (list, tuple)):
            check(isinstance(g, (list, tuple)) and len(g) == len(w),
                  f"{where}: lengths differ")
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{where}[{i}]")
        elif isinstance(w, torch.Tensor):
            check(isinstance(g, torch.Tensor) and g.shape == w.shape
                  and g.dtype == w.dtype and g.device == w.device,
                  f"{where}: tensor {getattr(g, 'shape', g)} vs {w.shape}")
            worst = max(worst, (g.float() - w.float()).abs().max().item())
        else:
            check((g is None) == (w is None), f"{where}: {g!r} vs {w!r}")

    for field in PARAM_FIELDS:
        if hasattr(want, field):
            walk(getattr(got, field), getattr(want, field), field)
    return worst


def backgrounds_equal(got, want):
    if hasattr(want, "normmats"):
        return (sorted(got.normmats) == sorted(want.normmats)
                and all(np.array_equal(got.normmats[lv], want.normmats[lv])
                        for lv in want.normmats)
                and got.epss == want.epss)
    return (np.array_equal(got.background_cis, want.background_cis,
                           equal_nan=True)
            and got.background_trans == want.background_trans)


class PeakRss:
    """The highest resident set size this process reaches while installed,
    sampled from /proc/self/statm every 10 ms (the kernel's own peak mark
    covers the whole process and cannot be reset on every machine)."""

    def __enter__(self):
        import threading

        self.peak, self._stop = 0, threading.Event()
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._sample()
        self.start = self.peak
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        with open("/proc/self/statm") as f:
            self.peak = max(self.peak, int(f.read().split()[1]) * self._page)

    def _run(self):
        while not self._stop.wait(0.01):
            self._sample()

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()

    def __str__(self):
        return (f"{self.peak / 2**30:.2f} GiB ({self.start / 2**30:.2f} GiB "
                f"at the start; sampled every 10 ms)")


def checkpoints_phase(torch, cc, zoo, seq):
    """The released-checkpoint path: reference-format statedicts of every
    family written from seeded random bundles, loaded by `load_resources`
    onto the card, checked against the sources, driven through
    `genomepredict` at full geometry (the launch counters set to 0 just
    before each request and read just after), leukemiaB held to the CPU on
    a small window, and the command line's `convert`. Returns {dtype:
    launches}."""
    import io
    import tempfile

    from orca_tpu_torch import cli
    from orca_tpu_torch.nn.encoders import fused_group_count
    from orca_tpu_torch.predict import multiscale as ms, resources

    geom = ms.GEOM_32M
    groups = fused_group_count(2, geom.window_bp)
    launches = {torch.bfloat16: {"fused_first_stage": 0, "fused_conv_chain": 0},
                torch.float32: {"fused_first_stage": 0, "fused_conv_chain": 0}}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_") as tmp:
        model_dir = os.path.join(tmp, "models")
        resource_dir = os.path.join(tmp, "resources")
        os.makedirs(model_dir)
        os.makedirs(resource_dir)
        t0 = time.perf_counter()
        src = checkpoint_sources(torch, zoo)
        write_checkpoints(torch, zoo, src, model_dir, resource_dir)
        nbytes = sum(os.path.getsize(os.path.join(model_dir, f))
                     for f in os.listdir(model_dir))
        print(f"checkpoints: {len(os.listdir(model_dir))} statedicts "
              f"({nbytes / 1e6:.1f} MB) and {len(os.listdir(resource_dir))} "
              f"expectation files written in {time.perf_counter() - t0:.3f} "
              f"s", flush=True)

        loaded = {}
        for dtype in ("float32", "bfloat16"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with PeakRss() as rss:
                res = resources.load_resources(
                    models=["32M", "1M", "256M", "leukemia"],
                    model_dir=model_dir, resource_dir=resource_dir,
                    dtype=dtype, device="cuda")
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(list(res.models) == list(CHECKPOINT_MODELS),
                  f"load_resources: {list(res.models)}")
            print(f"checkpoints load_resources {dtype}: {len(res.models)} "
                  f"models from statedicts in {secs:.3f} s, peak host RSS "
                  f"during the load {rss}", flush=True)
            loaded[dtype] = res.models
        worst = {}
        for name in CHECKPOINT_MODELS:
            want = resources._fold(src[name])
            for dtype in ("float32", "bfloat16"):
                got = loaded[dtype][name]
                check(type(got) is type(want) and got.name == want.name,
                      f"{name}: {type(got).__name__} {got.name}")
                d = max_param_diff(torch, got, zoo.cast_bundle(want, dtype))
                worst[(name, dtype)] = d
                check(d == 0.0, f"{name} {dtype}: loaded parameters differ "
                      f"from the folded source by {d}")
                check(backgrounds_equal(got, want),
                      f"{name} {dtype}: backgrounds differ")
                _, keys = tree_leaves(got, torch)
                check("bn" not in keys, f"{name}: BatchNorm left")
        print(f"checkpoints round trip: {len(worst)} bundles, every folded "
              f"parameter equal to folding its source on the card (max|d| "
              f"{max(worst.values())} in float32 and bf16), backgrounds "
              f"equal", flush=True)
        del src

        # full-geometry requests, the families in turns: a first round, then
        # CHECKPOINT_ROUNDS more whose medians give the split
        mpos = wpos = geom.window_bp // 2
        want_starts = [int(wpos - geom.window_bp // 2 + s * geom.bin_bp)
                       for s in host_starts(geom, mpos, wpos)]
        want = {"fused_first_stage": groups, "fused_conv_chain": 6 * groups}
        configs = (("h1esc", "bfloat16"), ("hctnoc", "bfloat16"),
                   ("leukemiaA", "bfloat16"), ("leukemiaB", "bfloat16"),
                   ("leukemiaB", "float32"))
        times = {c: [] for c in configs}  # (request, encoder, decoders) s
        for _ in range(1 + CHECKPOINT_ROUNDS):
            for name, dtype in configs:
                bundle = loaded[dtype][name]
                cc.fused_first_stage.launches = 0
                cc.fused_conv_chain.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with Timed(torch, ms, "_encode_32mb") as t_enc, \
                        Timed(torch, ms, "_decode_level") as t_dec:
                    out = ms.genomepredict(seq, "chrSynthetic", mpos, wpos,
                                           [bundle])
                torch.cuda.synchronize()
                times[(name, dtype)].append(
                    (time.perf_counter() - t0, t_enc.seconds, t_dec.seconds))
                counts = {"fused_first_stage": cc.fused_first_stage.launches,
                          "fused_conv_chain": cc.fused_conv_chain.launches}
                check(counts == want, f"{name} {dtype}: launches {counts} != "
                      f"{want}")
                for k, v in counts.items():
                    launches[getattr(torch, dtype)][k] += v
                check(out["start_coords"] == want_starts,
                      f"{name}: starts {out['start_coords']} != "
                      f"{want_starts}")
                shape = ((geom.crop,) * 2 if bundle.num_2d == 1
                         else (bundle.num_2d, geom.crop, geom.crop))
                for j, p in enumerate(out["predictions"][0]):
                    check(p.shape == shape, f"{name} level {j}: {p.shape}")
                    check(np.isfinite(p).all(),
                          f"{name} level {j}: non-finite")
                    check(np.array_equal(p, np.swapaxes(p, -1, -2)),
                          f"{name} level {j}: not symmetric")
        dec = {}
        for (name, dtype), rows in times.items():
            # each part's median over the timed rounds; the rest is the
            # request less its encoder and decoder levels, round by round
            req, enc, dec[(name, dtype)], rest = (
                statistics.median(col) for col in
                zip(*[(r, e, d, r - e - d) for r, e, d in rows[1:]]))
            print(f"checkpoints request {name} {dtype}: {len(rows)} "
                  f"requests, {want} launches each, maps "
                  f"{loaded[dtype][name].num_2d} x {geom.crop}^2; first "
                  f"{rows[0][0]:.4f} s, then medians: request {req:.4f} s, "
                  f"encoder+pyramid {enc:.4f} s, decoder levels "
                  f"{dec[(name, dtype)]:.4f} s (range "
                  f"{min(r[2] for r in rows[1:]):.4f}-"
                  f"{max(r[2] for r in rows[1:]):.4f}), host and the rest "
                  f"{rest:.4f} s", flush=True)
        ratio = dec[("leukemiaB", "bfloat16")] / dec[("h1esc", "bfloat16")]
        print(f"checkpoints decoders bf16, medians of {CHECKPOINT_ROUNDS} "
              f"requests in turns: leukemiaB (134/70 channels into the "
              f"combiners) / h1esc (129/65) = {ratio:.3f}", flush=True)

        # leukemiaB's fp32 cascade on the card against the CPU plain path,
        # with its parameters and backgrounds rebuilt at a 1.024 Mb window
        small = ms.CascadeGeometry(1_024_000, 4000, 8)
        logs = [np.load(os.path.join(resource_dir, f))
                for f in zoo._LEUKEMIA_NORMMAT_FILES["leukemiaB"]]
        nm, eps = zoo.multi_normmats_from_expectations(
            logs, nbins=small.bins, crop=small.crop)
        gpu_b = dataclasses.replace(loaded["float32"]["leukemiaB"],
                                    normmats=nm, epss=eps)
        cpu_b = zoo._map_params(gpu_b, lambda t: t.cpu())
        sseq = seq[:, : small.window_bp]
        a = ms.genomepredict(sseq, "c", 400_000, 512_000, [gpu_b],
                             geometry=small)
        threads = torch.get_num_threads()
        torch.set_num_threads(len(os.sched_getaffinity(0)))
        t0 = time.perf_counter()
        b = ms.genomepredict(sseq, "c", 400_000, 512_000, [cpu_b],
                             geometry=small, device="cpu")
        cpu_s = time.perf_counter() - t0
        torch.set_num_threads(threads)
        check(a["start_coords"] == b["start_coords"],
              "leukemiaB small window: starts differ")
        d = max(np.abs(p - q).max() for p, q in zip(a["predictions"][0],
                                                    b["predictions"][0]))
        m = max(np.abs(q).max() for q in b["predictions"][0])
        print(f"checkpoints leukemiaB fp32 card vs CPU plain (1.024 Mb "
              f"window, 6 heads): max|d| {d:.3e} max|ref| {m:.3e} (CPU "
              f"{cpu_s:.1f} s)", flush=True)
        check(d <= 1e-4 * max(1.0, m), f"leukemiaB small window: max|d| {d}")
        del gpu_b, cpu_b

        # the command line's convert, in this process
        out_path = os.path.join(tmp, "orca_leukemiaB.bundle")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            rc = cli.main(["convert", "leukemia", "leukemiaB", out_path,
                           "--model-dir", model_dir,
                           "--resource-dir", resource_dir])
        convert_s = time.perf_counter() - t0
        check(rc == 0 and said.getvalue() == f"wrote {out_path}\n",
              f"convert: rc {rc}, said {said.getvalue()!r}")
        conv = zoo.load_bundle(out_path, device="cuda", dtype="float32")
        d = max_param_diff(torch, conv, loaded["float32"]["leukemiaB"])
        check(d == 0.0 and backgrounds_equal(conv,
                                             loaded["float32"]["leukemiaB"]),
              f"converted leukemiaB differs from the loaded one: max|d| {d}")
        print(f"checkpoints convert leukemia leukemiaB: {convert_s:.3f} s on "
              f"the host ({os.path.getsize(out_path) / 1e6:.1f} MB pickle), "
              f"load_bundle equal to the load_resources bundle (max|d| {d}, "
              f"backgrounds equal)", flush=True)
    return launches


# --------------------------------------------------------------------------
# 10. training
# --------------------------------------------------------------------------

TRAIN_BLOCK_BP = 800_000  # the stage steps' encoder_block_bp
TRAIN_PIECE_BP = TRAIN_BLOCK_BP + 2 * HALO_BP  # 1.024 Mb pieces
TRAIN_GROUP_ROWS = 20  # rows of a tower group at 800 kb blocks (16 Mb)
# per stage: chromosomes (name, bp), the target resolution, the validation
# holdout; a stage-c window never has more than ~34% trans (NaN) entries
TRAIN_GENOMES = {
    "a": ([("chrA1", 4_000_000), ("chrA2", 4_000_000)], 1000, "chrA2"),
    "b": ([("chrB1", 40_000_000), ("chrB2", 33_000_000)], 4000, "chrB2"),
    "c": ([("chrC1", 200_000_000), ("chrC2", 60_000_000),
           ("chrC3", 60_000_000)], 32000, "chrC3"),
}


def smooth_contacts(n, seed):
    """A smooth symmetric balanced contact map of n bins: distance decay
    times a slow checkerboard, a few filtered (NaN) rows and columns."""
    rng = np.random.default_rng(seed)
    idx = np.arange(n, dtype=np.float32)
    comp = np.sign(np.sin(idx / 37.0 + rng.uniform(0, 6))).astype(np.float32)
    m = np.abs(idx[:, None] - idx[None, :])
    np.log1p(m, out=m)
    m *= -1.2
    m -= 3.0
    np.exp(m, out=m)
    m *= 1.0 + 0.3 * comp[:, None] * comp[None, :]
    bad = rng.choice(n, max(1, n // 100), replace=False)
    m[bad] = np.nan
    m[:, bad] = np.nan
    return m


def write_training_resources(torch, cli, tmp):
    """Per stage: a FASTA through `build-genome`, a dense store of smooth
    balanced maps (.npz), expectations; stage a also a 32-track BED. Returns
    {stage: job fields}."""
    import io

    jobs = {}
    for stage, (chroms, res, holdout) in TRAIN_GENOMES.items():
        fasta = os.path.join(tmp, f"genome_{stage}.fa")
        memmap = os.path.join(tmp, f"genome_{stage}.mmap")
        write_fasta(fasta, chroms, SEED + ord(stage))
        with contextlib.redirect_stdout(io.StringIO()):
            check(cli.main(["build-genome", fasta, memmap]) == 0,
                  f"build-genome {stage}")
        os.remove(fasta)
        store = os.path.join(tmp, f"contacts_{stage}.npz")
        np.savez(store, **{name: smooth_contacts(bp // res, SEED + i)
                           for i, (name, bp) in enumerate(chroms)})
        d = np.arange(10_000, dtype=np.float64)
        job = dict(genome_memmap=memmap, dense_store=store,
                   validation_holdout=[holdout], test_holdout=[],
                   checkpoint_every=1, validate_every=2, val_batches=1)
        if stage == "c":
            np.save(os.path.join(tmp, "bg.mono.npy"),
                    -1.2 * np.log1p(d) - 3.0)
            np.save(os.path.join(tmp, "bg.trans.npy"), np.float64(-9.0))
            job.update(
                background_cis_npy=os.path.join(tmp, "bg.mono.npy"),
                background_trans_npy=os.path.join(tmp, "bg.trans.npy"),
                accumulate=1)
        else:
            exp = os.path.join(tmp, f"expected.res{res}.npy")
            np.save(exp, -1.2 * np.log1p(d) - 3.0)
            job["expectation_npy"] = exp
        if stage == "a":
            rng = np.random.default_rng(SEED + 9)
            names = [f"track{i}" for i in range(32)]
            with open(os.path.join(tmp, "tracks.bed"), "w") as f:
                for name, bp in chroms:
                    for s in np.sort(rng.integers(0, bp - 5000, 400)):
                        f.write(f"{name}\t{s}\t{s + int(rng.integers(200, 5000))}"
                                f"\t{names[int(rng.integers(0, 32))]}\n")
            with open(os.path.join(tmp, "tracks.features"), "w") as f:
                f.write("\n".join(names) + "\n")
            job.update(bed_path=os.path.join(tmp, "tracks.bed"),
                       bed_features=os.path.join(tmp, "tracks.features"),
                       batch_size=4, use_swa=True)
        if stage == "b":
            job["accumulate"] = 4
        jobs[stage] = job
    return jobs


class TrainProbe:
    """Times the training path's pieces and counts kernel launches, by
    wrapping them in place for the phase (restored by `remove`): each step
    (synchronized before and after: seconds, launches, loss), the frozen
    tower inside it, the host sampling, validation, save and restore; and
    the trainer each `make_trainer` builds, with a copy of its params."""

    def __init__(self, torch, cc):
        from orca_tpu_torch.data import sampler
        from orca_tpu_torch.training import launch, loop, stages

        self.torch, self.cc = torch, cc
        self.saved = []
        self.reset()

        def launches():
            return (cc.fused_first_stage.launches,
                    cc.fused_conv_chain.launches)

        def timed(kind, fn, sync=True):
            def run(*a, **k):
                if sync:
                    torch.cuda.synchronize()
                l0, t0 = launches(), time.perf_counter()
                out = fn(*a, **k)
                if sync:
                    torch.cuda.synchronize()
                self.events.append((kind, time.perf_counter() - t0,
                                    tuple(b - a for a, b in zip(l0, launches())),
                                    out))
                return out
            return run

        def step_maker(make):
            def wrapped(*a, **k):
                opt, step = make(*a, **k)
                return opt, timed("step", step)
            return wrapped

        def capture(make):
            def wrapped(*a, **k):
                tr = make(*a, **k)
                params = getattr(tr, "params", None) or tr.trainable
                self.trainer = tr
                self.initial = self._clone(params)
                self.frozen0 = self._clone(getattr(tr, "frozen", {}))
                return tr
            return wrapped

        def patch(obj, name, new):
            self.saved.append((obj, name, getattr(obj, name)))
            setattr(obj, name, new)

        for n in ("make_stage_a_step", "make_stage_b_step",
                  "make_stage_c_step"):
            patch(loop, n, step_maker(getattr(loop, n)))
        patch(stages, "_frozen_features",
              timed("frozen", stages._frozen_features))
        patch(sampler.RandomWindowSampler, "sample",
              timed("sample", sampler.RandomWindowSampler.sample, sync=False))
        for cls in (loop.StageATrainer, loop.StageBTrainer):
            patch(cls, "validate", timed("validate", cls.validate))
        patch(loop._Trainer, "save", timed("save", loop._Trainer.save))
        patch(loop._Trainer, "_restore",
              timed("restore", loop._Trainer._restore))
        patch(launch, "make_trainer", capture(launch.make_trainer))

    def _clone(self, tree):
        from orca_tpu_torch.utils.tree import tree_map

        return tree_map(lambda t: t.detach().clone(), tree)

    def reset(self):
        self.events = []
        self.trainer = self.initial = self.frozen0 = None

    def remove(self):
        for obj, name, old in reversed(self.saved):
            setattr(obj, name, old)


def _split_steps(events):
    """Per step: (seconds, frozen-tower seconds, host sampling seconds before
    it, launches, loss, metrics); and the other events by kind."""
    steps, other = [], {}
    frozen = sample = 0.0
    for kind, secs, launched, out in events:
        if kind == "frozen":
            frozen += secs
        elif kind == "sample":
            sample += secs
        elif kind == "step":
            steps.append((secs, frozen, sample, launched,
                          float(out[2]["loss"]),
                          {k: float(v) for k, v in out[2].items()}))
            frozen = sample = 0.0
        else:
            other.setdefault(kind, []).append((secs, launched))
            frozen = sample = 0.0
    return steps, other


def train_stage(torch, cli, probe, stage, job, tmp, runs):
    """One stage through the command line: 3 steps straight (timed), then 1
    step, then a resumed run to step 3 in another workdir. Returns the
    launches of the three runs and the straight run's step-1 metrics."""
    from orca_tpu_torch.nn.encoders import fused_group_count
    from orca_tpu_torch.utils.tree import tree_leaves

    window = job.get("window_bp") or {"a": 1_000_000, "b": 32_000_000,
                                      "c": 256_000_000}[stage]
    rows = 0 if stage == "a" else job["accumulate"]
    block_bp = TRAIN_BLOCK_BP if window > 2_000_000 else None
    groups = fused_group_count(rows, window, block_bp) if rows else 0
    step_launch = (groups, 6 * groups)
    eval_launch = ((fused_group_count(job["batch_size"], window), 6 *
                    fused_group_count(job["batch_size"], window))
                   if stage == "a" else step_launch)
    total = [0, 0]
    losses = {}
    for run, (workdir, max_steps) in runs.items():
        cfg = os.path.join(tmp, f"job_{stage}_{run}.json")
        with open(cfg, "w") as f:
            json.dump(dict(job, workdir=workdir), f)
        probe.reset()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        check(cli.main(["train", stage, "--config", cfg, "--max-steps",
                        str(max_steps)]) == 0, f"train {stage} {run}")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        steps, other = _split_steps(probe.events)
        for kind, events in other.items():
            for _, launched in events:
                total[0] += launched[0]
                total[1] += launched[1]
        for s in steps:
            total[0] += s[3][0]
            total[1] += s[3][1]
        first = 1 if run == "resumed" else 0
        losses[run] = {first + i + 1: s[4] for i, s in enumerate(steps)}
        check(all(np.isfinite(s[4]) for s in steps), f"{stage} {run}: loss")
        check(all(s[3] == step_launch for s in steps),
              f"{stage} {run}: launches a step {[s[3] for s in steps]} != "
              f"{step_launch}")
        check(all(v[1] == eval_launch for v in other.get("validate", [])),
              f"{stage} {run}: launches a validation "
              f"{other.get('validate')} != {eval_launch}")
        if run == "straight":
            step1 = steps[0][5]
            tr = probe.trainer
            params = getattr(tr, "params", None) or tr.trainable
            moved = any(not torch.equal(a, b) for a, b in zip(
                tree_leaves(probe.initial), tree_leaves(params)))
            frozen_equal = all(torch.equal(a, b) for a, b in zip(
                tree_leaves(probe.frozen0), tree_leaves(getattr(tr, "frozen",
                                                                {}))))
            check(moved, f"{stage}: the trainable params did not move")
            check(frozen_equal, f"{stage}: the frozen params changed")
            check(len(steps) == 3 and len(other.get("validate", [])) == 1,
                  f"{stage}: {len(steps)} steps, validations "
                  f"{other.get('validate')}")
            secs = [round(s[0], 3) for s in steps]
            print(f"training {stage}: steps {len(steps)}, seconds a step "
                  f"first {secs[0]} rest {secs[1:]}; of the rest, frozen "
                  f"tower {[round(s[1], 3) for s in steps[1:]]}, trainable "
                  f"forward+backward+update "
                  f"{[round(s[0] - s[1], 3) for s in steps[1:]]}; host "
                  f"sampling a step {[round(s[2], 3) for s in steps]}; "
                  f"validate {[round(v[0], 3) for v in other['validate']]} s;"
                  f" save {[round(v[0], 3) for v in other['save']]} s; "
                  f"launches a step {steps[0][3]} (expected {step_launch}), "
                  f"a validation {other['validate'][0][1]} (expected "
                  f"{eval_launch}); peak device memory {peak:.2f} GiB; run "
                  f"{wall:.1f} s; trainable moved, frozen bit-equal; losses "
                  f"{[round(s[4], 6) for s in steps]}", flush=True)
        elif run == "resumed":
            print(f"training {stage} resumed: restore "
                  f"{[round(v[0], 3) for v in other['restore']]} s, steps "
                  f"{sorted(losses[run])}, run {wall:.1f} s, peak device "
                  f"memory {peak:.2f} GiB", flush=True)
    check(set(losses["resumed"]) == {2, 3}, f"{stage}: resumed steps "
          f"{sorted(losses['resumed'])}")
    check(losses["first"][1] == losses["straight"][1],
          f"{stage}: step 1 differs between two runs")
    d = max(abs(losses["resumed"][k] - losses["straight"][k])
            / max(1e-30, abs(losses["straight"][k]))
            for k in losses["resumed"])
    print(f"training {stage} resume: steps 2-3 resumed vs straight, max "
          f"relative loss difference {d:.3e}", flush=True)
    check(d <= 1e-5, f"{stage}: resumed losses differ by {d}")
    return total, step1


class PinnedDraws:
    """Pins the port's draws (utils.rng) for a card-vs-CPU comparison: the
    flip true, zoom offsets 3, 1, ... in call order, dropout masks from a
    seed and the mask's shape."""

    def __init__(self, torch):
        from orca_tpu_torch.utils import rng

        self.rng, self.torch, self.calls = rng, torch, 0
        self.saved = (rng.coin, rng.randint, rng.bernoulli)

    def __enter__(self):
        import zlib

        def bernoulli(k, p, shape, device):
            seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
            mask = np.random.RandomState(seed).rand(*shape) < p
            return self.torch.from_numpy(mask).to(device)

        def randint(k, low, high):
            self.calls += 1
            return (3, 1)[(self.calls - 1) % 2] % high

        self.rng.coin = lambda k: True
        self.rng.randint = randint
        self.rng.bernoulli = bernoulli
        return self

    def __exit__(self, *exc):
        self.rng.coin, self.rng.randint, self.rng.bernoulli = self.saved


def _tree_err(torch, want, got, select=lambda path: True, path=""):
    """max over leaves of max|d| / max(1, max|want|), over the leaves whose
    path `select` keeps."""
    if isinstance(want, dict):
        return max([_tree_err(torch, want[k], got[k], select, f"{path}/{k}")
                    for k in want] or [0.0])
    if isinstance(want, list):
        return max([_tree_err(torch, w, g, select, f"{path}/{i}")
                    for i, (w, g) in enumerate(zip(want, got))] or [0.0])
    if not select(path):
        return 0.0
    w = want.detach().double().cpu()
    return ((got.detach().double().cpu() - w).abs().max()
            / max(1.0, w.abs().max().item())).item()


class Tf32Allowed:
    """The training steps with TF32 allowed for cuDNN and cuBLAS, in place
    of `nn_ops.full_fp32` (which also selects deterministic algorithms): a
    control that the float32 check below sees a backward left in TF32."""

    def __init__(self, torch):
        from orca_tpu_torch.ops import nn_ops

        self.nn_ops, self.b = nn_ops, torch.backends

    def __enter__(self):
        self.saved = (self.nn_ops.full_fp32, self.b.cudnn.allow_tf32,
                      self.b.cuda.matmul.allow_tf32)
        self.nn_ops.full_fp32 = contextlib.nullcontext
        self.b.cudnn.allow_tf32 = self.b.cuda.matmul.allow_tf32 = True
        return self

    def __exit__(self, *exc):
        (self.nn_ops.full_fp32, self.b.cudnn.allow_tf32,
         self.b.cuda.matmul.allow_tf32) = self.saved


def _tree_rel_l2(torch, want, got):
    """||got - want|| / ||want|| over every leaf of two trees of one
    structure."""
    from orca_tpu_torch.utils.tree import tree_leaves

    num = den = 0.0
    for w, g in zip(tree_leaves(want), tree_leaves(got)):
        w = w.detach().double().cpu()
        num += (g.detach().double().cpu() - w).square().sum().item()
        den += w.square().sum().item()
    return (num / den) ** 0.5


# The card's float32 momentum may lie at most this many times as far from a
# float64 step as the CPU's float32 momentum does (relative L2 over the
# tree). A float32 step's gradient at 1.024 Mb is ill-conditioned: the
# CPU's float32 step lies 7.0e-3 from the float64 one, the card's 1.1e-2,
# the card's with TF32 allowed 3.3e-1 (probe on an H100 80GB HBM3, 700 W).
TRAIN_F32_MOMENTUM_FACTOR = 3.0


def training_card_vs_cpu(torch):
    """One stage-b step at CascadeGeometry(1_024_000, 4000, 8), levels
    (32, 1), pinned draws. Float32 as the trainers run it, on the card (the
    frozen tower through the kernels, TF32 off) and on the CPU plain path,
    and float64 on the CPU as the reference. Checked: the card's loss and
    BatchNorm updates within 1e-4 * max(1, max|ref|) of the CPU float32
    step's; the card's momentum tree no further from the float64 step's
    (relative L2 over the tree) than TRAIN_F32_MOMENTUM_FACTOR times the
    CPU float32 step's own distance to it (a float32 step's gradient is too
    ill-conditioned here to ask 1e-4 of it). A control: the card's step with
    TF32 allowed must miss that limit. Then float64 on the
    same tower features on the card and the CPU: loss, BatchNorm updates,
    momentum tree and params within 1e-4 * max(1, max|ref|)."""
    from orca_tpu_torch.models import zoo
    from orca_tpu_torch.nn import decoders, encoders
    from orca_tpu_torch.nn.core import fold_params
    from orca_tpu_torch.predict.multiscale import CascadeGeometry
    from orca_tpu_torch.training import stages
    from orca_tpu_torch.utils.tree import tree_map

    geom, levels = CascadeGeometry(1_024_000, 4000, 8), (32, 1)
    gen = torch.Generator().manual_seed(SEED + 7)
    trainable = {"pyramid": encoders.init_pyramid(gen, 5, True),
                 "decoders": {lv: decoders.init_decoder(gen) for lv in levels}}
    frozen = {"encoder": fold_params(encoders.init_encoder_tower(gen),
                                     encoders.encoder_tower_spec()),
              "decoder_1pt": fold_params(decoders.init_decoder1m(gen),
                                         decoders.decoder1m_spec(1))}
    d = np.arange(geom.bins, dtype=np.float64)
    nms, epss = zoo.normmats_from_expectation(
        -1.2 * np.log1p(d) - 3.0, levels=sorted(levels), nbins=geom.bins,
        crop=geom.crop)
    nm = torch.tensor(np.stack([nms[lv] for lv in levels]),
                      dtype=torch.float32)
    ep = torch.tensor([epss[lv] for lv in levels], dtype=torch.float32)
    rng = np.random.RandomState(SEED + 8)
    seq = torch.from_numpy(np.eye(4, dtype=np.uint8)[
        rng.randint(0, 4, (1, geom.window_bp))] * 4)
    target = torch.from_numpy(smooth_contacts(geom.bins, SEED + 8)[None])
    cfg = stages.StageBConfig(geometry=geom, levels=levels,
                              encoder_block_bp=None)
    threads = torch.get_num_threads()
    torch.set_num_threads(len(os.sched_getaffinity(0)))

    def run(dev, dtype, feats=None, tf32=False):
        def to(tree):
            return tree_map(lambda t: t.to(dev, dtype)
                            if t.is_floating_point() else t.to(dev), tree)
        feats_fn = None if feats is None else (
            lambda p, s: feats.to(dev, dtype))
        opt, step = stages.make_stage_b_step(cfg, encoder_fn=feats_fn,
                                             device=dev)
        tr, fr = to(trainable), to(frozen)
        with PinnedDraws(torch), (Tf32Allowed(torch) if tf32
                                  else contextlib.nullcontext()):
            return step(tr, fr, opt.init(tr), seq.to(dev),
                        target.to(dev, dtype), 123, 0.002,
                        nm.to(dev, dtype), ep.to(dev, dtype))

    def loss_err(want, got):
        return abs(float(got["loss"]) - float(want["loss"])) / max(
            1.0, abs(float(want["loss"])))

    def is_bn(path):
        return path.endswith(("/mean", "/var"))

    t0 = time.perf_counter()
    ref = run("cpu", torch.float64)
    cpu = run("cpu", torch.float32)
    got = run("cuda", torch.float32)
    tf32 = run("cuda", torch.float32, tf32=True)
    loss_d = loss_err(cpu[2], got[2])
    bn_d = _tree_err(torch, cpu[0], got[0], is_bn)
    mom = {name: (_tree_rel_l2(torch, ref[1]["trace"], out[1]["trace"]),
                  _tree_err(torch, ref[1]["trace"], out[1]["trace"]))
           for name, out in (("cpu", cpu), ("card", got), ("tf32", tf32))}
    limit = TRAIN_F32_MOMENTUM_FACTOR * mom["cpu"][0]
    print(f"training card vs CPU, stage-b step float32 at "
          f"{geom.window_bp / 1e6:g} Mb, levels {levels}: loss "
          f"{float(got[2]['loss']):.6f} vs {float(cpu[2]['loss']):.6f} (|d| "
          f"{loss_d:.3e} of max(1, |loss|)), BatchNorm updates {bn_d:.3e}; "
          f"momentum tree against the float64 step's, relative L2 (max per "
          f"leaf of max(1, max|ref|)): card {mom['card'][0]:.3e} "
          f"({mom['card'][1]:.3e}), CPU float32 {mom['cpu'][0]:.3e} "
          f"({mom['cpu'][1]:.3e}), limit {limit:.3e}; card with TF32 allowed "
          f"{mom['tf32'][0]:.3e} ({mom['tf32'][1]:.3e})", flush=True)
    check(loss_d <= 1e-4 and bn_d <= 1e-4,
          f"float32 step card vs CPU: loss {loss_d}, BN {bn_d}")
    check(mom["card"][0] <= limit, f"float32 step on the card: momentum "
          f"{mom['card'][0]} from the float64 step's, over the limit {limit}")
    check(mom["tf32"][0] > limit, f"the TF32 control is within the float32 "
          f"momentum limit ({mom['tf32'][0]} <= {limit}): it sees no TF32")
    with torch.no_grad():
        feats = encoders.apply_encoder_tower(frozen["encoder"], seq)
    (tc, sc, mc) = run("cpu", torch.float64, feats)
    (tg, sg, mg) = run("cuda", torch.float64, feats)
    loss_d = loss_err(mc, mg)
    bn_d = _tree_err(torch, tc, tg, is_bn)
    mom = _tree_err(torch, sc["trace"], sg["trace"])
    params_d = _tree_err(torch, tc, tg)
    torch.set_num_threads(threads)
    print(f"training card vs CPU, stage-b step float64 on shared tower "
          f"features: loss |d| {loss_d:.3e}, BatchNorm updates {bn_d:.3e}, "
          f"momentum tree {mom:.3e}, params {params_d:.3e} (of max(1, "
          f"max|ref|) per leaf; {time.perf_counter() - t0:.1f} s)",
          flush=True)
    check(max(loss_d, bn_d, mom, params_d) <= 1e-4,
          f"float64 step card vs CPU: {loss_d} {bn_d} {mom} {params_d}")


def training_phase(torch, cc, peaks, sms):
    """Training through the command line a user runs: per stage a synthetic
    genome through `build-genome`, a dense store and expectations; then
    `cli.main(["train", ...])` at full width and geometry (a: the 1 Mb Net,
    batch 4, SWA; b: 32 Mb, all six levels, 4 windows a step, from a's run;
    c: 256 Mb, all four levels, from a's and b's runs): 3 steps straight,
    then 1 step and a resumed run to step 3, all as the command line runs
    them. Before them, both kernels at the
    1.024 Mb piece shape and one stage-b step on the card against the CPU;
    after them, phase 10b (`training_dp_phase`). Returns the fp32 launches
    of the phase (kernel checks aside), phase 10b's ranks' included."""
    import tempfile

    from orca_tpu_torch import cli
    from orca_tpu_torch.nn import encoders
    from orca_tpu_torch.nn.core import fold_params

    raw = encoders.init_encoder_tower(torch.Generator().manual_seed(SEED))
    tower = tree_cuda(torch, fold_params(raw, encoders.encoder_tower_spec()))
    rows = kernel_phase(torch, tower, torch.float32, peaks, sms,
                        piece_bp=TRAIN_PIECE_BP, rows=TRAIN_GROUP_ROWS,
                        tag="stage1024kb")
    print("kernels1024kb " + json.dumps({k: {n: round(v, 4) if isinstance(
        v, float) and n != "max_abs_err" else v for n, v in t.items()}
        for k, t in rows.items()}), flush=True)
    training_card_vs_cpu(torch)
    probe = TrainProbe(torch, cc)
    total = [0, 0]
    try:
        with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_") as tmp:
            t0 = time.perf_counter()
            jobs = write_training_resources(torch, cli, tmp)
            print(f"training resources: 3 genomes through build-genome, dense"
                  f" stores, expectations, BED: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            straight, step1 = {}, {}
            for stage in ("a", "b", "c"):
                job = dict(jobs[stage])
                if stage in ("b", "c"):
                    job["init_workdir_a"] = straight["a"]
                if stage == "c":
                    job["init_workdir_b"] = straight["b"]
                straight[stage] = os.path.join(tmp, f"run_{stage}")
                runs = {"straight": (straight[stage], 3),
                        "first": (os.path.join(tmp, f"resume_{stage}"), 1),
                        "resumed": (os.path.join(tmp, f"resume_{stage}"), 3)}
                got, step1[stage] = train_stage(torch, cli, probe, stage, job,
                                                tmp, runs)
                total[0] += got[0]
                total[1] += got[1]
            probe.reset()
            got = training_dp_phase(torch, tower, tmp, jobs["b"],
                                    straight["a"], step1["b"])
            total[0] += got[0]
            total[1] += got[1]
    finally:
        probe.remove()
    return {"fused_first_stage": total[0], "fused_conv_chain": total[1]}


# --------------------------------------------------------------------------
# 11. the benchmark
# --------------------------------------------------------------------------

BENCH_ITERS = 2  # ORCA_BENCH_ITERS of the phase
BENCH_RATIO = (0.5, 2.0)  # bench s a 32 Mb window / phase 4's, less the copy


def bench_keys():
    """The JAX package's benchmark line's keys (bench.py's `result`, the
    error keys aside) and those its training fields take from
    scripts/bench_training.py's stage-a and stage-b functions, read from
    their sources (parsed, not imported)."""
    import ast

    def parse(*rel):
        with open(os.path.join(ROOT, *rel)) as f:
            return ast.parse(f.read())

    keys = set()
    main_fn = next(n for n in parse("bench.py").body
                   if isinstance(n, ast.FunctionDef) and n.name == "main")
    for node in ast.walk(main_fn):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == "result":
            keys.update(k.value for k in node.value.keys)
        elif (isinstance(target, ast.Subscript)
              and isinstance(target.value, ast.Name)
              and target.value.id == "result"):
            keys.add(target.slice.value)
    for fn in parse("scripts", "bench_training.py").body:
        if (isinstance(fn, ast.FunctionDef)
                and fn.name in ("bench_stage_a", "bench_stage_b")):
            ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
            keys.update(k.value for k in ret.value.keys)
    return {k for k in keys if not k.endswith("_error")}


def bench_launches():
    """Each kernel's launches per dtype in one benchmark run at BENCH_ITERS:
    a section's requests (the warm-up, the first run, then the timed runs;
    a two-model run is two requests) times the tower's groups a request,
    and stage b's three steps times a step's (one 32 Mb row in 800 kb
    blocks). Stage a trains the whole 1 Mb Net on cuDNN: no launch."""
    from orca_tpu_torch.nn.encoders import fused_group_count
    from orca_tpu_torch.training.stages import StageBConfig

    later = max(1, BENCH_ITERS - 1)
    g32 = fused_group_count(2, 32_000_000)
    g256 = fused_group_count(2, 256_000_000)
    gb = fused_group_count(1, 32_000_000, StageBConfig().encoder_block_bp)
    groups = {
        # one model, then two models
        "bfloat16": (2 + BENCH_ITERS + 1 + 2 * (1 + later)) * g32
        + (2 + later) * g256,
        # one model, two models at one timed run, 256 Mb at one, stage b
        "float32": (2 + later + 1 + 2 * 2) * g32 + 3 * g256 + 3 * gb,
    }
    return {dtype: {"fused_first_stage": g, "fused_conv_chain": 6 * g}
            for dtype, g in groups.items()}


@contextlib.contextmanager
def launches_by_dtype(cc):
    """Yields {(dtype name, kernel name): launches} of the block, tallied by
    wrapping the kernels' launch beside their counters (a launch raises or
    counts)."""
    by_dtype = {}
    launch = cc._launch

    def counted_launch(counted, *args):
        before = counted.launches
        out = launch(counted, *args)
        key = (str(args[10]).replace("torch.", ""), counted.__name__)
        by_dtype[key] = by_dtype.get(key, 0) + counted.launches - before
        return out

    cc._launch = counted_launch
    try:
        yield by_dtype
    finally:
        cc._launch = launch


def bench_phase(torch, cc, seq, request_s):
    """Phase 11: `cli.main(["bench"])` in this process (module docstring).
    `seq` is phase 4's packed 32 Mb window, `request_s` phase 4's warm
    request seconds per dtype name. Returns the launches per dtype name."""
    import io

    from orca_tpu_torch import cli
    from orca_tpu_torch.predict import multiscale as ms

    # the sequence's copy to the card: in a request's seconds, not the
    # benchmark's
    copies = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ms._device_sequence(seq, "cuda")
        torch.cuda.synchronize()
        copies.append(time.perf_counter() - t0)
    copy_s = statistics.median(copies)

    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("ORCA_BENCH_")}
    os.environ["ORCA_BENCH_ITERS"] = str(BENCH_ITERS)
    out, err = io.StringIO(), io.StringIO()
    reset_counters(cc)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
                launches_by_dtype(cc) as by_dtype:
            rc = cli.main(["bench"])
    finally:
        secs = time.perf_counter() - t0
        del os.environ["ORCA_BENCH_ITERS"]
        os.environ.update(saved)
        for line in err.getvalue().splitlines():
            print(f"bench| {line}", flush=True)
    counts = counters(cc)
    lines = out.getvalue().splitlines()
    check(rc == 0 and len(lines) == 1,
          f"bench: exit {rc}, {len(lines)} lines on stdout: {lines[-3:]}")
    line = json.loads(lines[0])
    print("bench " + json.dumps(line), flush=True)
    errors = sorted(k for k in line if k.endswith("_error"))
    check(not errors, f"bench: {[(k, line[k]) for k in errors]}")
    missing = sorted(bench_keys() - set(line))
    check(not missing, f"bench: keys missing: {missing}")
    bad = [k for k, v in line.items()
           if isinstance(v, (int, float)) and not isinstance(v, bool)
           and not (np.isfinite(v) and v > 0)]
    check(not bad, f"bench: not finite and positive: "
          f"{[(k, line[k]) for k in bad]}")
    check(isinstance(line.get("power_limit_w"), float),
          f"bench: power_limit_w {line.get('power_limit_w')}")
    check(line["device"] == torch.cuda.get_device_name(0),
          f"bench: device {line['device']!r}")
    want = bench_launches()
    got = {dtype: {name: by_dtype.get((dtype, name), 0) for name in w}
           for dtype, w in want.items()}
    total = {name: sum(g[name] for g in got.values()) for name in counts}
    ratios = {}
    for dtype, key in (("bfloat16", "seconds_per_32Mb_window"),
                       ("float32", "fp32_seconds_per_window")):
        ratios[dtype] = line[key] / (request_s[dtype] - copy_s)
    print(f"bench: phase {secs:.1f} s, launches {got} (expected {want}), "
          f"a 32 Mb window against phase 4's request less the copy "
          f"({copy_s:.4f} s): "
          f"{ {k: round(v, 3) for k, v in ratios.items()} }", flush=True)
    check(got == want and counts == total,
          f"bench: launches {got} (counters {counts}) != {want}")
    for dtype, r in ratios.items():
        check(BENCH_RATIO[0] <= r <= BENCH_RATIO[1],
              f"bench: {dtype} window {r:.3f}x phase 4's request")
    for k, v in warmup_jax_forms(torch, cc).items():
        got["bfloat16"][k] += v
    return got


def warmup_jax_forms(torch, cc):
    """The warm-ups in the JAX package's call forms on the benchmark's two
    bf16 models: n=1 positionally, then n=2 (one request on 2n rows).
    Returns their launches."""
    from orca_tpu_torch import bench
    from orca_tpu_torch.nn.encoders import fused_group_count
    from orca_tpu_torch.predict import multiscale as ms

    models = bench._bundles("bfloat16", range(2), ms.GEOM_32M, "cuda")
    reset_counters(cc)
    secs = [ms.warmup_cascade_32m(models[0], ms.GEOM_32M, 1),
            ms.warmup_cascade_32m(models[1], ms.GEOM_32M, n=2)]
    counts = counters(cc)
    groups = fused_group_count(2, ms.GEOM_32M.window_bp) + fused_group_count(
        4, ms.GEOM_32M.window_bp)
    want = {"fused_first_stage": groups, "fused_conv_chain": 6 * groups}
    print(f"warmup (JAX's call forms): (model0, GEOM_32M, 1) "
          f"{secs[0]:.4f} s, (model1, GEOM_32M, n=2) {secs[1]:.4f} s, "
          f"launches {counts} (expected {want})", flush=True)
    check(all(isinstance(s, float) and s > 0 for s in secs),
          f"warmup: seconds {secs}")
    check(counts == want, f"warmup: launches {counts} != {want}")
    return counts


# Phase 13: the JAX package's drivers, each through its entry point on the
# card at a reduced count
SERVE_VARIANTS = 4  # the serve screen's dup/del commands
LOADER_BATCHES = 8  # the loader's timed batches a format
ENC_BATCH, ENC_ITERS = 4, 2  # bench_training enc
PROBE_N = 2  # the probes' timed runs a step
DRIVER_256M_ITERS = 1  # bench_256m's ORCA_BENCH_ITERS


def _script(*rel):
    import ast

    with open(os.path.join(ROOT, *rel)) as f:
        return ast.parse(f.read())


def dict_keys_with(tree, key):
    """The keys of the first dict literal in `tree` that holds `key`."""
    import ast

    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Dict)
                and any(isinstance(k, ast.Constant) and k.value == key
                        for k in n.keys))
    return {k.value for k in node.keys}


def subscript_keys(tree, function, name):
    """The keys `function` assigns as `name["..."] = ...`."""
    import ast

    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    return {t.slice.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Subscript)
            and isinstance(t.value, ast.Name) and t.value.id == name}


def script_labels(tree):
    """Regexes of the labels a JAX probe prints, in source order: the text
    before the first ': ' of each literal first argument of `timeit(...)`
    and `print(...)`, each formatted value standing for any text."""
    import ast

    found = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("timeit", "print") and node.args):
            continue
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            text = arg.value
        elif (isinstance(arg, ast.JoinedStr)
              and isinstance(arg.values[0], ast.Constant)):
            text = "".join(v.value if isinstance(v, ast.Constant) else "\0"
                           for v in arg.values)
        else:
            continue
        label = text.split(": ")[0].lstrip("\n")
        found.append((node.lineno, node.col_offset, ".+".join(
            re.escape(p) for p in label.split("\0"))))
    return [t for _, _, t in sorted(found)]


def labels_match(printed, templates):
    """Whether the printed labels are the templates in order (a template
    matching one label or several in a row) followed by the card's line."""
    i = 0
    for t in templates:
        n = 0
        while i < len(printed) and re.fullmatch(t, printed[i]):
            i, n = i + 1, n + 1
        if not n:
            return False
    return printed[i:] == ["device"]


def positive_numbers(fields, tag):
    """Every number in `fields` finite and positive (bools aside)."""
    bad = [(k, v) for k, v in fields.items()
           if isinstance(v, (int, float)) and not isinstance(v, bool)
           and not (np.isfinite(v) and v > 0)]
    check(not bad, f"driver {tag}: not finite and positive: {bad}")


def drivers_phase(torch, cc, kind):
    """Phase 13 (module docstring). Returns the in-process drivers' launches
    per dtype name."""
    import glob
    import io
    import pickle
    import tempfile

    from orca_tpu_torch import bench_training
    from orca_tpu_torch.nn.encoders import fused_group_count
    from orca_tpu_torch.scripts import (
        bench_256m,
        bench_serve_screen,
        probe_decoder,
        probe_two_model,
        profile_cascade,
        smoke_e2e,
    )

    g32 = fused_group_count(2, 32_000_000)
    t_phase = time.perf_counter()
    total = {d: {"fused_first_stage": 0, "fused_conv_chain": 0}
             for d in ("bfloat16", "float32")}

    def run(name, fn, groups):
        """`fn()` with the counters at 0 and the launches tallied per dtype,
        its stdout and stderr echoed on `driver|` lines; `groups` is the
        fused-tower runs it must make per dtype name. Returns (its result,
        its stdout, its seconds, the launches)."""
        torch.cuda.empty_cache()
        reset_counters(cc)
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err), \
                    launches_by_dtype(cc) as by_dtype:
                result = fn()
        finally:
            secs = time.perf_counter() - t0
            for line in (out.getvalue() + err.getvalue()).splitlines():
                print(f"driver| {name}: {line}", flush=True)
        got = {d: {k: by_dtype.get((d, k), 0) for k in total[d]}
               for d in total}
        want = {d: {"fused_first_stage": groups.get(d, 0),
                    "fused_conv_chain": 6 * groups.get(d, 0)}
                for d in total}
        check(got == want and counters(cc) == {
            k: sum(g[k] for g in got.values()) for k in counters(cc)},
              f"driver {name}: launches {got} != {want}")
        for d in total:
            for k in total[d]:
                total[d][k] += got[d][k]
        return result, out.getvalue(), secs, got

    def report(name, secs, launches, fields, note=""):
        print(f"driver {name} " + json.dumps(dict(
            fields, driver_s=secs, launches=launches, note=note)), flush=True)

    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_smoke_") as tmp:
        # the warm-server screen: the server is another process, whose
        # launches this process's counters do not see
        root = os.path.join(tmp, "serve")
        line, _, secs, got = run("bench_serve_screen", lambda: (
            bench_serve_screen.main(SERVE_VARIANTS, plots="record",
                                    root=root)), {})
        keys = dict_keys_with(_script("scripts", "bench_serve_screen.py"),
                              "serve_ready_s")
        check(keys <= set(line) and line["serve_plots"] == "record",
              f"driver bench_serve_screen: keys {sorted(line)}")
        check(line["device"] == kind and isinstance(line["serve_prewarm_s"],
                                                    float),
              f"driver bench_serve_screen: {line}")
        positive_numbers(line, "bench_serve_screen")
        out_dir = os.path.join(root, "out")
        pkls = sorted(glob.glob(os.path.join(out_dir, "*.pkl")))
        check(len(pkls) == 1 + SERVE_VARIANTS,
              f"driver bench_serve_screen: {len(pkls)} .pkl files")
        for path in pkls:
            with open(path, "rb") as f:
                outs = pickle.load(f)
            check_maps(outs if isinstance(outs, tuple) else [outs], 6,
                       f"serve screen {os.path.basename(path)}")
        with open(os.path.join(out_dir, bench_serve_screen.RECORDED_PLOTS)) as f:
            plots = f.read().split()
        check(plots and all(p.endswith(".pdf") for p in plots),
              f"driver bench_serve_screen: recorded plots {plots}")
        report("bench_serve_screen", secs, got, dict(
            line, pkls=len(pkls), plots_recorded=len(plots)),
            "READY and every command OK; each .pkl's maps finite, symmetric, "
            "250x250; the server's launches are in its own process, not "
            "counted here")

        # the prefetch loader, host only, in a fresh process
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "orca_tpu_torch.scripts.measure_loader",
             "--batches", str(LOADER_BATCHES)], cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        secs = time.perf_counter() - t0
        for x in (proc.stdout + proc.stderr).splitlines():
            print(f"driver| measure_loader: {x}", flush=True)
        check(proc.returncode == 0,
              f"driver measure_loader: exit {proc.returncode}")
        line = json.loads(proc.stdout.splitlines()[-1])
        keys = dict_keys_with(_script("scripts", "measure_loader.py"),
                              "metric")
        check(keys <= set(line) and line["device"] == kind,
              f"driver measure_loader: {line}")
        positive_numbers(line, "measure_loader")
        report("measure_loader", secs, {}, line,
               f"{LOADER_BATCHES} batches a format, 2 worker processes, in "
               "a process of its own; no kernel")

        # bench_training enc: fp32, the kernels on the forward path only
        tree = _script("scripts", "bench_training.py")
        line, _, secs, got = run("enc", lambda: bench_training.
                                 bench_encoder_paths(batch=ENC_BATCH,
                                                     iters=ENC_ITERS),
                                 {"float32": (1 + ENC_ITERS) * fused_group_count(
                                     ENC_BATCH, 1_000_000)})
        check(set(line) == subscript_keys(tree, "bench_encoder_paths", "out"),
              f"driver enc: keys {sorted(line)}")
        positive_numbers(line, "enc")
        report("enc", secs, got, dict(line, device=kind),
               f"batch {ENC_BATCH} at 1 Mb, {ENC_ITERS} iterations")

        # the probes, bf16 32 Mb: each step runs 2 + n times (profile:
        # warm, single, n queued) or 1 + n times (two-model), and the
        # profile factory runs the tower and the encoder once each
        probes = (
            ("profile_cascade", lambda: profile_cascade.main(n=PROBE_N),
             {"bfloat16": (2 + 3 * (2 + PROBE_N)) * g32}),
            ("probe_two_model", lambda: probe_two_model.main(iters=PROBE_N),
             {"bfloat16": (1 + PROBE_N) * (4 * g32 + fused_group_count(
                 4, 32_000_000))}),
            ("probe_decoder", lambda: probe_decoder.main(n=PROBE_N), {}),
        )
        for name, fn, groups in probes:
            result, printed, secs, got = run(name, fn, groups)
            labels = [x.split(": ")[0] for x in printed.splitlines()
                      if x.strip()]
            check(labels_match(labels, script_labels(_script(
                "scripts", f"{name}.py"))),
                  f"driver {name}: labels {labels}")
            check(result["device"] == kind, f"driver {name}: {result}")
            positive_numbers(result, name)
            report(name, secs, got, result, f"n={PROBE_N}")

        # the product smoke, plots recorded
        line, _, secs, got = run("smoke_e2e", lambda: smoke_e2e.main(
            os.path.join(tmp, "smoke"), plots="record"),
            {"bfloat16": 4 * g32})
        keys = dict_keys_with(_script("scripts", "smoke_e2e.py"),
                              "smoke_pdfs")
        check(keys <= set(line) and line["smoke_device"] == kind
              and line["smoke_pdfs"] == smoke_e2e.PDFS,
              f"driver smoke_e2e: {line}")
        positive_numbers(line, "smoke_e2e")
        report("smoke_e2e", secs, got, line,
               "process_region (1 window) + process_dup (3), one bf16 model")

        # the 256 Mb throughput line
        os.environ["ORCA_BENCH_ITERS"] = str(DRIVER_256M_ITERS)
        try:
            line, _, secs, got = run("bench_256m", bench_256m.main, {
                "bfloat16": (2 + DRIVER_256M_ITERS) * fused_group_count(
                    2, 256_000_000)})
        finally:
            del os.environ["ORCA_BENCH_ITERS"]
        keys = dict_keys_with(_script("scripts", "bench_256m.py"), "metric")
        check(set(line) == keys | {"power_limit_w"} and line["device"] == kind
              and line["dtype"] == "bfloat16",
              f"driver bench_256m: {line}")
        positive_numbers(line, "bench_256m")
        report("bench_256m", secs, got, line,
               f"ORCA_BENCH_ITERS={DRIVER_256M_ITERS}")
    print(f"drivers: phase {time.perf_counter() - t_phase:.1f} s, launches "
          f"{total}", flush=True)
    return total


# Phase 10b: data-parallel training. Two processes share the one card, each
# a (data, seq) mesh row that names cuda:0 twice, so together they drive a
# (2, 2) mesh. nccl refuses two ranks on one card; gloo takes CUDA tensors.
DP_WORLD = 2
DP_SEQ = 2
# step 1's loss and per-level losses against phase 10's one-process step 1,
# relative: the parameters and the batch are the same, the BatchNorm
# statistics are summed per rank, then over the ranks (fp32)
DP_LOSS_RTOL = 1e-3


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _digest(tree):
    import hashlib

    from orca_tpu_torch.utils.tree import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def training_dp_rank(rank, cfg, outdir):
    """One process of phase 10b (`chip_smoke.py --training-dp-rank ...`,
    torchrun's environment set by the phase): `cli.main(["train", "b",
    ...])` of a multihost job with mesh data=2,seq=2. Both processes are
    local rank 0 of a one-card host whose local devices name cuda:0 twice.
    Writes what it measured to <outdir>/rank<rank>.json and its final
    trainable params to <outdir>/params<rank>.pt."""
    import torch
    import torch.distributed as dist

    from orca_tpu_torch import cli
    from orca_tpu_torch.ops.kernels import conv_chain as cc
    from orca_tpu_torch.parallel import mesh as mesh_lib
    from orca_tpu_torch.parallel import multihost
    from orca_tpu_torch.training import loop

    mesh_lib.local_devices = lambda device_type="cuda": (
        [torch.device("cuda", 0)] * DP_SEQ)
    multihost.initialize(backend="gloo")
    probe = TrainProbe(torch, cc)
    allreduce = [0.0, 0]
    saves, rows = [], []
    all_reduce, save_state = dist.all_reduce, loop.save_state
    log = loop.MetricsLogger.log

    def timed_all_reduce(*a, **k):
        t0 = time.perf_counter()
        out = all_reduce(*a, **k)
        allreduce[0] += time.perf_counter() - t0
        allreduce[1] += 1
        return out

    def counted_save(*a, **k):
        saves.append(a[1])
        return save_state(*a, **k)

    def counted_log(self, step, **metrics):
        rec = log(self, step, **metrics)
        if rec is not None:
            rows.append(step)
        return rec

    dist.all_reduce, loop.save_state = timed_all_reduce, counted_save
    loop.MetricsLogger.log = counted_log
    reset_counters(cc)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    check(cli.main(["train", "b", "--config", cfg, "--max-steps", "2",
                    "--mesh", f"data={DP_WORLD},seq={DP_SEQ}"]) == 0,
          f"rank {rank}: train b")
    wall = time.perf_counter() - t0
    steps, other = _split_steps(probe.events)
    events = [e for e in probe.events if e[0] == "step"]
    torch.save(events[-1][3][0], os.path.join(outdir, f"params{rank}.pt"))
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump({
            "rank": rank, "wall": wall,
            "steps": [{"s": st[0], "frozen": st[1], "sample": st[2],
                       "launches": list(st[3]), "metrics": st[5]}
                      for st in steps],
            "digests": [_digest(e[3][0]) for e in events],
            "save_s": [v[0] for v in other.get("save", [])],
            "allreduce_s": allreduce[0], "allreduce_n": allreduce[1],
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": list(counters(cc).values()),
            "saves": saves, "rows": rows,
        }, f)
    dist.destroy_process_group()


def training_dp_phase(torch, tower, tmp, job_b, workdir_a, want1):
    """Phase 10b: phase 10's stage-b job (same seed and initial state) as a
    two-process data-parallel run at full geometry, each process's rows
    through the frozen tower sharded over its row (800 kb blocks, 112 kb
    halos), 2 steps, no validation, a checkpoint at step 2. Checked: both
    kernels at the sharded training rows' edge-shard bounds against their
    plain versions; step 1's losses against phase 10's (DP_LOSS_RTOL); every
    rank's trainable params equal after each step; launches a rank a step
    against the shards' group plan; rank 0 alone saved ckpt_2.pt and logged
    (one row, step 2), each rank its sidecar; the checkpoint restored in
    this process equal to the writers' params. Returns the ranks' launches
    (the path's, not the kernel checks')."""
    from orca_tpu_torch.nn.encoders import fused_group_count
    from orca_tpu_torch.ops.kernels import conv_chain as cc
    from orca_tpu_torch.training import launch
    from orca_tpu_torch.utils.tree import tree_leaves

    t_phase = time.perf_counter()
    worst = shard_bound_kernels(torch, cc, tower, torch.float32,
                                seg=TRAIN_PIECE_BP)
    rows = job_b["accumulate"] // DP_WORLD
    shard_bp = 32_000_000 // DP_SEQ + 2 * HALO_BP
    groups = DP_SEQ * fused_group_count(rows, shard_bp, TRAIN_BLOCK_BP)
    plan = [groups, 6 * groups]
    workdir = os.path.join(tmp, "run_b_dp")
    cfg = os.path.join(tmp, "job_b_dp.json")
    with open(cfg, "w") as f:
        json.dump(dict(job_b, workdir=workdir, init_workdir_a=workdir_a,
                       checkpoint_every=2, validate_every=1000,
                       multihost=True), f)
    outdir = os.path.join(tmp, "dp_out")
    os.makedirs(outdir)
    torch.cuda.empty_cache()
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--training-dp-rank",
         str(r), cfg, outdir],
        env=dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=port,
                 WORLD_SIZE=str(DP_WORLD), RANK=str(r), LOCAL_RANK="0"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(DP_WORLD)]
    try:
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"training_dp rank {r} exited "
              f"{p.returncode}: {out[-3000:]}")
    got = []
    for r in range(DP_WORLD):
        with open(os.path.join(outdir, f"rank{r}.json")) as f:
            got.append(json.load(f))
    rel = {k: abs(got[0]["steps"][0]["metrics"][k] - v) / abs(v)
           for k, v in want1.items()}
    check(max(rel.values()) <= DP_LOSS_RTOL,
          f"training_dp: step 1 against phase 10's: {rel}")
    check(all(g["steps"][0]["metrics"] == got[0]["steps"][0]["metrics"]
              for g in got), "training_dp: the ranks' step-1 metrics differ")
    check(all(g["digests"] == got[0]["digests"] for g in got)
          and len(got[0]["digests"]) == 2,
          "training_dp: the ranks' params differ after a step")
    params = [torch.load(os.path.join(outdir, f"params{r}.pt"),
                         map_location="cuda", weights_only=True)
              for r in range(DP_WORLD)]
    d_ranks = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(params[0]), tree_leaves(params[1])))
    check(d_ranks == 0, f"training_dp: params max|d| {d_ranks} across ranks")
    for g in got:
        check(all(st["launches"] == plan for st in g["steps"]),
              f"training_dp rank {g['rank']}: launches a step "
              f"{[st['launches'] for st in g['steps']]} != {plan}")
    files = sorted(os.listdir(workdir))
    want_files = sorted(["ckpt_2.pt", "stage_b.metrics.jsonl"]
                        + [f"ckpt_2.host.p{r}.json" for r in range(DP_WORLD)])
    check(files == want_files, f"training_dp: files {files}")
    check(got[0]["saves"] == [2] and got[0]["rows"] == [2]
          and all(g["saves"] == [] and g["rows"] == [] for g in got[1:]),
          f"training_dp: saves {[g['saves'] for g in got]}, rows logged "
          f"{[g['rows'] for g in got]}")
    with open(os.path.join(workdir, "stage_b.metrics.jsonl")) as f:
        logged = [json.loads(line)["step"] for line in f]
    check(logged == [2], f"training_dp: metrics rows {logged}")
    tr = launch.make_trainer(launch.TrainJob.from_json(cfg, stage="b",
                                                       multihost=False))
    check(tr.try_restore() and tr.step == 2, "training_dp: no restore")
    d_restore = max((a - b).abs().max().item() for a, b in zip(
        tree_leaves(tr.trainable), tree_leaves(params[0])))
    check(d_restore == 0, f"training_dp: restored params max|d| {d_restore}")
    del tr, params
    secs = time.perf_counter() - t_phase
    print(f"training_dp: {DP_WORLD} processes (gloo) on one card, a "
          f"({DP_WORLD}, {DP_SEQ}) mesh naming cuda:0 {DP_WORLD * DP_SEQ} "
          f"times, stage b at 32 Mb, {job_b['accumulate']} windows a step; "
          "seconds a step per rank "
          f"{[[round(st['s'], 3) for st in g['steps']] for g in got]}, "
          "frozen tower "
          f"{[[round(st['frozen'], 3) for st in g['steps']] for g in got]},"
          " host sampling "
          f"{[[round(st['sample'], 3) for st in g['steps']] for g in got]};"
          " all-reduce host s (calls) "
          f"{[(round(g['allreduce_s'], 3), g['allreduce_n']) for g in got]};"
          f" save {[round(x, 3) for x in got[0]['save_s']]} s; launches a "
          f"step per rank {[g['steps'][0]['launches'] for g in got]} "
          f"(plan {plan}), in all {[g['launches'] for g in got]}; peak "
          f"device memory per rank "
          f"{[round(g['peak_gib'], 2) for g in got]} GiB; step 1 vs phase "
          f"10 relative {max(rel.values()):.3e} (loss "
          f"{got[0]['steps'][0]['metrics']['loss']:.6f} vs "
          f"{want1['loss']:.6f}); params across ranks max|d| {d_ranks}; "
          f"restored max|d| {d_restore}; kernels at the edge-shard bounds "
          f"max|d| {worst:.3e}; ranks' wall "
          f"{[round(g['wall'], 1) for g in got]} s; phase {secs:.1f} s",
          flush=True)
    return [sum(g["launches"][i] for g in got) for i in range(2)]


CERTIFY_REFERENCE = os.path.join(ROOT, "tests", "data",
                                 "certify_card_ref.npz")


def certify_card_phase(torch, cc, encoders, smi, bundles):
    """Phase 5c: the card's outputs against orca_tpu's, committed in
    CERTIFY_REFERENCE (see `orca_tpu_torch.certify_card`); `bundles` are the
    earlier phases' folded float32 bundles on the card by family (their
    digests are checked like a bundle drawn here). Returns the phase's
    launches by dtype."""
    from orca_tpu_torch import certify_card as cert
    from orca_tpu_torch.ops import nn_ops

    t_phase = time.perf_counter()
    ref = cert.load_reference(CERTIFY_REFERENCE)
    groups = {name: 1 if name == "1m" else
              encoders.fused_group_count(2, fam.window_bp)
              for name, fam in cert.FULL.items()}
    launches = {torch.bfloat16: {"fused_first_stage": 0,
                                 "fused_conv_chain": 0},
                torch.float32: {"fused_first_stage": 0,
                                "fused_conv_chain": 0}}
    requests = {}

    @contextlib.contextmanager
    def request(family, dtype, zoom):
        reset_counters(cc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        got = counters(cc)
        want = {"fused_first_stage": groups[family],
                "fused_conv_chain": 6 * groups[family]}
        check(got == want, f"certify_card {family} {dtype} {zoom}: launches "
              f"{got} != {want}")
        requests[(family, dtype, zoom)] = {
            "launches": got, "seconds": time.perf_counter() - t0}
        for k, v in got.items():
            launches[getattr(torch, dtype)][k] += v

    report = {}
    with nn_ops.full_fp32():
        for name, fam in cert.FULL.items():
            try:
                report[name] = cert.certify_family(
                    ref, fam, "cuda", bundle=bundles.get(name),
                    request=request,
                    log=lambda line: print(line, flush=True))
            except cert.CertifyError as e:
                raise PhaseError(f"certify_card: {e}") from e
            torch.cuda.empty_cache()
    for (family, dtype, zoom), r in requests.items():
        report[family][dtype][zoom].update(r)
    figures = [z for fam in report.values() for zooms in fam.values()
               for z in zooms.values() if "levels" in z]
    secs = time.perf_counter() - t_phase
    print(json.dumps({"certify_card": {
        "card": smi, "torch": torch.__version__, "numpy": np.__version__,
        "reference": os.path.relpath(CERTIFY_REFERENCE, ROOT),
        "bar_fp32": cert.BAR_FP32, "limit_rel": cert.LIMIT_REL,
        "limit_bf16": cert.LIMIT_BF16,
        "digests_equal": True, "starts_equal": True,
        "families": report, "seconds": secs,
        "pass": all(z["pass"] for z in figures)}}), flush=True)
    print(f"certify_card: phase {secs:.1f} s, {len(figures)} requests, "
          f"launches {launches}", flush=True)
    return launches


def tree_cuda(torch, tree):
    from orca_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.cuda(), tree)


def codec_phase(native, genome_mod):
    """Phase 2b: build and load the host codec, then `codes_to_onehot` on a
    32 Mb window of codes, each strand against the numpy path it replaces
    (host clock, median of 3 calls each: every call allocates its output,
    as a request's does)."""
    t_phase = time.perf_counter()
    check(native.available(), "codec: no C++ compiler on PATH")
    print(f"codec: built and loaded in {time.perf_counter() - t_phase:.3f} s",
          flush=True)
    codes = np.random.RandomState(SEED + 5).randint(0, 5, CODEC_BP).astype(
        np.uint8)

    def numpy_path(rc):
        enc = genome_mod.codes_to_encoding(codes)
        return np.ascontiguousarray(enc[::-1, ::-1] if rc else enc)

    def median_s(fn):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times), out

    for rc, strand in ((False, "+"), (True, "-")):
        nat_s, got = median_s(lambda: native.codes_to_onehot(codes, rc=rc))
        ref_s, want = median_s(lambda: numpy_path(rc))
        check(got.dtype == want.dtype and got.shape == want.shape
              and np.array_equal(got, want),
              f"codec {strand}: the C++ one-hot differs from numpy's")
        gb = got.nbytes / 1e9
        print(f"codec {strand}: {CODEC_BP // 10**6} Mb window, native "
              f"{nat_s * 1e3:.3f} ms ({gb / nat_s:.3f} GB/s written), numpy "
              f"{ref_s * 1e3:.3f} ms ({gb / ref_s:.3f} GB/s), "
              f"{ref_s / nat_s:.2f}x, bit-equal", flush=True)
        del got, want
    print(f"codec: phase {time.perf_counter() - t_phase:.3f} s", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from orca_tpu_torch.models import zoo
        from orca_tpu_torch.nn import encoders
        from orca_tpu_torch.data import genome as genome_mod, native
        from orca_tpu_torch.data.genome import CodeGenome
        from orca_tpu_torch.ops.kernels import build, conv_chain as cc
        from orca_tpu_torch.predict import multiscale as ms, retrieval
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
            # the tensor-core and FFMA kernels hold their accumulators in
            # registers; the tensor-core kernels keep their wgmmas
            # asynchronous
            check(not re.search(r"mma|ffma", k["name"])
                  or (k["spill"] == (0, 0) and not k["serialized"]),
                  f"{k['name']} spills registers or serializes wgmma")

    # 2b. the host codec
    codec_phase(native, genome_mod)

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
            fp32_first, fp32_secs, noise32 = outs[0], secs, d

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
    cpu_b = zoo.fold_bundle(zoo.random_32m_bundle(SEED + 2, nbins=256, crop=8,
                                                  device="cpu"))
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
          f"max|ref| {m:.3e}; bar {BAR_FP32:.1e}: "
          f"{'under' if d <= BAR_FP32 else 'over'}", flush=True)
    check(d <= 1e-4 * max(1.0, m), f"small window: max|d| {d}")

    # 4b. the sequence-sharded path, on meshes that name cuda:0 2 and 4
    # times (one card: this checks the shards' results, not a multi-card
    # speed)
    refs = {
        torch.bfloat16: dict(bf16_first,
                             seconds=statistics.median(bf16_secs[1:])),
        torch.float32: dict(fp32_first, seconds=statistics.median(fp32_secs)),
    }
    counts = sharded_phase(
        torch, cc, {torch.bfloat16: bf16_bundle, torch.float32: fp32_bundle},
        seq, ms.GEOM_32M, refs, noise32)
    for dtype, c in counts.items():
        for k, v in c.items():
            launches[dtype][k] += v

    # 4c. one warm bf16 request traced: the device's idle share
    profile_phase(torch, ms, bf16_bundle, seq, ms.GEOM_32M,
                  refs[torch.bfloat16]["seconds"], smi)

    # 5. the 256 Mb path: a whole chromosome plus padding from a genome
    del bf16_bundle, seq2
    rng = np.random.default_rng(SEED + 4)
    genome = CodeGenome({
        "chrM": rng.integers(0, 4, CHROM_BP, dtype=np.uint8),
        "chr1": rng.integers(0, 4, PAD_CHROM_BP, dtype=np.uint8),
    })
    geom = ms.GEOM_256M
    chrlen = CHROM_BP - CHROM_BP % geom.bin_bp
    regions = [["chrM", 0, chrlen, "+"],
               ["chr1", 0, geom.window_bp - chrlen, "+"]]
    raw_256 = zoo.random_256m_bundle(SEED)
    fp32_256 = zoo.fold_256m_bundle(raw_256)
    bf16_256 = zoo.cast_bundle(fp32_256, "bfloat16")
    t0 = time.perf_counter()
    with Timed(torch, native, "codes_to_onehot", sync=False) as t_codec:
        sequence, normmats = retrieval.retrieve_multi(regions, genome,
                                                      models_256m=[fp32_256])
    retrieve_s = time.perf_counter() - t0
    check(t_codec.calls > 0, "retrieval256: the genome never ran the codec")
    t0 = time.perf_counter()
    seq256 = encoders.pack_onehot(sequence)
    pack_s = time.perf_counter() - t0
    check(sequence.shape == (1, geom.window_bp, 4)
          and normmats[0].shape == (geom.bins, geom.bins),
          f"retrieval: {sequence.shape} {normmats[0].shape}")
    # the same retrieval on the numpy path (the codec switched off, as on a
    # host with no C++ compiler): equal bytes, and the codec's gain
    available = native.available
    native.available = lambda: False
    try:
        t0 = time.perf_counter()
        numpy_sequence, _ = retrieval.retrieve_multi(regions, genome,
                                                     models_256m=[fp32_256])
        numpy_s = time.perf_counter() - t0
    finally:
        native.available = available
    check(np.array_equal(sequence, numpy_sequence),
          "retrieval256: the codec's sequence differs from the numpy path's")
    del sequence, numpy_sequence
    print(f"retrieval256: retrieve_multi {retrieve_s:.3f} s (sequence and "
          f"background of {regions}; the codec {t_codec.calls} calls "
          f"{t_codec.seconds:.3f} s, {t_codec.seconds / retrieve_s:.1%}), "
          f"pack to uint8 {pack_s:.3f} s; on the numpy path retrieve_multi "
          f"{numpy_s:.3f} s, sequence bit-equal", flush=True)
    before = (cc.fused_first_stage.launches, cc.fused_conv_chain.launches)
    try:
        ms.genomepredict_256mb(seq256, "chrM", normmats, chrlen,
                               ZOOM_TARGETS_256[0], WPOS_256, [raw_256])
    except ValueError as e:
        print(f"unfolded 256 Mb bundle on the card: refused ({e})", flush=True)
    else:
        raise PhaseError("an unfolded 256 Mb bundle ran on the card")
    check((cc.fused_first_stage.launches, cc.fused_conv_chain.launches)
          == before, "the refused 256 Mb request launched a kernel")
    del raw_256
    secs256 = {}
    for dtype, bundle, targets in (
        (torch.bfloat16, bf16_256, ZOOM_TARGETS_256),
        (torch.float32, fp32_256, ZOOM_TARGETS_256[:1]),
    ):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        outs, secs, counts = cascade256_phase(
            torch, cc, bundle, seq256, normmats[0], chrlen, targets, geom)
        for k, v in counts.items():
            launches[dtype][k] += v
        secs256[dtype] = secs
        print(f"cascade256 {dtype}: {len(targets)} requests, seconds "
              f"{[round(s, 4) for s in secs]}, launches {counts} over the "
              f"requests, starts {[o['start_coords'] for o in outs]}, end "
              f"coords {[o['end_coords'] for o in outs]}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        if dtype == torch.bfloat16:
            bf16_first, bf16_256_secs = outs[0], secs
        else:
            d = max(np.abs(a - b).max() for a, b in zip(
                outs[0]["predictions"][0], bf16_first["predictions"][0]))
            m = max(np.abs(a).max() for a in outs[0]["predictions"][0])
            print(f"  fp32 vs bf16 256 Mb request at {targets[0]}: max|d| "
                  f"{d:.3e} max|fp32| {m:.3e}", flush=True)
            noise256 = d

    # 5b. one bf16 256 Mb request with a (1, 2) mesh of cuda:0, held to the
    # unsharded request at the same zoom target
    from orca_tpu_torch.parallel import make_mesh

    card = torch.device("cuda", 0)
    groups = shard_groups(geom, (1, 2))
    want = {"fused_first_stage": groups, "fused_conv_chain": 6 * groups}
    torch.cuda.reset_peak_memory_stats()
    reset_counters(cc)
    torch.cuda.synchronize()
    current = torch.cuda.current_device()
    t0 = time.perf_counter()
    out = ms.genomepredict_256mb(
        seq256, "chrM", [normmats[0]], chrlen, ZOOM_TARGETS_256[0], WPOS_256,
        [bf16_256], padding_chr="chr1", geometry=geom,
        mesh=make_mesh((1, 2), devices=[card] * 2))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    same_current_device(torch, current, "sharded 256 Mb")
    counts = counters(cc)
    d = max_map_diff(out, bf16_first)
    print(f"sharded256 (1, 2) bf16: {secs:.4f} s (unsharded "
          f"{[round(s, 4) for s in bf16_256_secs]}), launches {counts} "
          f"(expected {want}), max|d| vs unsharded {d:.3e} (bar "
          f"{2 * noise256:.3e}), starts {out['start_coords']}, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    check(counts == want, f"sharded 256 Mb: launches {counts} != {want}")
    check(out["start_coords"] == bf16_first["start_coords"],
          f"sharded 256 Mb: starts {out['start_coords']} != "
          f"{bf16_first['start_coords']}")
    check(d <= 2 * noise256, f"sharded 256 Mb: max|d| {d} > {2 * noise256}")
    for k, v in counts.items():
        launches[torch.bfloat16][k] += v

    # the split of a 256 Mb request: the background's NaN fill on the host,
    # the sequence's copy to the card, encoder + both pyramids alone; the
    # rest is the decoders, the crops and per-row backgrounds, the outputs
    t0 = time.perf_counter()
    ms._filled_background(normmats[0])
    fill_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dev_seq = ms._device_sequence(seq256, "cuda")
    torch.cuda.synchronize()
    copy_s = time.perf_counter() - t0
    parts = []
    with torch.inference_mode():
        for dtype, bundle, reps in ((torch.bfloat16, bf16_256, 2),
                                    (torch.float32, fp32_256, 1)):
            enc_s = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ms._encode_256mb_fwd_rc(bundle, dev_seq)
                torch.cuda.synchronize()
                enc_s.append(time.perf_counter() - t0)
            secs = secs256[dtype]
            req = statistics.median(secs[1:] if len(secs) > 1 else secs)
            rest = req - min(enc_s) - fill_s - copy_s
            parts.append(f"{dtype}: request {req:.4f} s = background fill "
                         f"(host) {fill_s:.4f} s + sequence to the card "
                         f"{copy_s:.4f} s + encoder+pyramids {min(enc_s):.4f} "
                         f"s + decoders/crops/outputs {rest:.4f} s")
    print("split256 " + "; ".join(parts), flush=True)
    del dev_seq, bf16_256, seq256, normmats

    # 5c. the card path against orca_tpu's outputs at full geometry, on
    # phase 4's and 5's weights
    for dtype, counts in certify_card_phase(
            torch, cc, encoders, smi,
            {"32m": fp32_bundle, "256m": fp32_256}).items():
        for k, v in counts.items():
            launches[dtype][k] += v
    del fp32_bundle, fp32_256

    # 6. the variant screens, through the entry points a user calls
    for k, v in screens_phase(torch, cc, zoo, genome).items():
        launches[torch.bfloat16][k] += v

    # 7. the standalone 1 Mb family on windows of the same genome
    for dtype, counts in onemb_phase(torch, cc, zoo, genome, peaks,
                                     sms).items():
        for k, v in counts.items():
            launches[dtype][k] += v
    del genome

    # 8. the warm server, through the command line
    for k, v in serve_phase(torch, cc, zoo).items():
        launches[torch.bfloat16][k] += v

    # 9. the released checkpoints' path, through the same entry points
    for dtype, counts in checkpoints_phase(torch, cc, zoo, seq).items():
        for k, v in counts.items():
            launches[dtype][k] += v

    # 10. training, through the command line
    counts = training_phase(torch, cc, peaks, sms)
    for k, v in counts.items():
        launches[torch.float32][k] += v
    print(f"training launches: {counts}", flush=True)

    # 11. the benchmark, through the command line
    got = bench_phase(torch, cc, seq, {
        "bfloat16": refs[torch.bfloat16]["seconds"],
        "float32": refs[torch.float32]["seconds"],
    })
    for dtype, name in ((torch.bfloat16, "bfloat16"),
                        (torch.float32, "float32")):
        for k, v in got[name].items():
            launches[dtype][k] += v

    # 13. the JAX package's drivers, through their entry points
    for name, c in drivers_phase(torch, cc, kind).items():
        dtype = getattr(torch, name)
        for k, v in c.items():
            launches[dtype][k] += v

    # 12. the kernel line and the device line, last
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
        if sys.argv[1:2] == ["--training-dp-rank"]:
            training_dp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
            sys.exit(0)
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
