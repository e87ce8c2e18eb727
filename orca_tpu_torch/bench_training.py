"""Training-step benchmark on the CUDA card (counterpart of the JAX
package's scripts/bench_training.py).

Measures, at production geometry, fp32 with TF32 off as every step runs:
  * stage a: 1 Mb windows, batch 4 a card, num_1d=32, live BatchNorm,
    recomputed segments (the whole 1 Mb Net trains, so the tower runs the
    plain stages under autograd on cuDNN, no fused kernel);
  * stage b: one 32 Mb window a step, the folded tower frozen (the fused
    conv-chain kernels under no_grad), the pyramid and six decoders trained;
  * stage c: one 256 Mb window a step, the tower and the 32 Mb pyramid
    frozen, the 256 Mb pyramid and four decoders trained;
  * `enc`: the encoder tower's inference and training paths at the stage-a
    shape (`bench_encoder_paths`).

Each function builds its parameters from explicit `torch.Generator` seeds and
its inputs from the JAX script's `np.random.RandomState` seeds, runs one step
(the first step of a process: cuDNN's plan choice, the allocator's pools),
then times `iters` steps, each ended by a host fetch of the loss, and returns
the JAX script's keys. The reference's wall-clock budgets are the original
Orca's published training runs (train/README.md:14), not measurements.

    python -m orca_tpu_torch.bench_training a,b,c,enc

prints one JSON line after each stage (all four by default, as the JAX
script).
"""

from __future__ import annotations

import json
import sys
import time
import traceback

import numpy as np
import torch

from orca_tpu_torch.models import zoo
from orca_tpu_torch.nn import decoders, encoders
from orca_tpu_torch.nn.core import BNUpdates, fold_params
from orca_tpu_torch.ops import nn_ops
from orca_tpu_torch.scripts._common import fetch
from orca_tpu_torch.training.stages import (
    StageAConfig,
    StageBConfig,
    StageCConfig,
    make_stage_a_step,
    make_stage_b_step,
    make_stage_c_step,
)
from orca_tpu_torch.utils import rng as rng_lib
from orca_tpu_torch.utils.config import resolve_device
from orca_tpu_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# the original Orca's training runs (train/README.md:14): steps, days on
# 4x V100
REF_STAGE_A = (480_000, 30.0)
REF_STAGE_B = (150_000, 20.0)
REF_STAGE_C = (36_000, 20.0)
LR = 0.002


def _timeit(fn, iters):
    """(seconds a call over `iters` calls, seconds of the first call); `fn`
    must end in a host fetch."""
    t0 = time.perf_counter()
    fn()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters, first_s


def _packed(rng, shape, device):
    """Quarter-scale uint8 one-hot of uniform random codes, on `device`."""
    codes = rng.randint(0, 4, size=shape)
    return torch.from_numpy((np.eye(4, dtype=np.uint8) * 4)[codes]).to(device)


def bench_stage_a(batch=4, iters=6, dtype="float32", cfg=None, device=None):
    """Batch 4 a card is the reference's own per-device batch (global batch
    16 over 4x V100, train_h1esc_a.py:102), so a 4-card data-parallel run
    takes one global step at about this rate. `cfg` (production StageAConfig
    with num_1d=32 by default) and `device` (None = CUDA) let a test run it
    small on the CPU."""
    device = resolve_device(device)
    cfg = cfg or StageAConfig(num_1d=32)
    opt, step = make_stage_a_step(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tree_map(lambda t: t.to(getattr(torch, dtype)),
                      decoders.init_net(gen, num_1d=cfg.num_1d))
    opt_state = opt.init(params)
    rng = np.random.RandomState(0)
    seq = _packed(rng, (batch, cfg.seq_len), device)
    f = cfg.target_factor
    target = torch.from_numpy(np.abs(
        rng.rand(batch, cfg.crop * f, cfg.crop * f)).astype(np.float32)
    ).to(device)
    target_1d = torch.from_numpy(
        (rng.rand(batch, cfg.crop, cfg.num_1d) > 0.5).astype(np.float32)
    ).to(device)
    normmat = torch.full((cfg.crop, cfg.crop), 0.1, device=device)
    key = rng_lib.key(1)
    state = {"p": params, "o": opt_state}

    def run():
        state["p"], state["o"], m = step(
            state["p"], state["o"], seq, target, target_1d, key, LR,
            normmat, 0.1,
        )
        return float(m["loss"])  # host fetch: the step has finished

    dt, first_s = _timeit(run, iters)
    steps, days = REF_STAGE_A
    # the reference's 480k steps are of global batch 16 = 4x this batch; a
    # 4-card data-parallel run takes one global step per measured step
    global_days_4chip = steps * dt / 86400.0
    return {
        "stage_a_steps_per_s": 1.0 / dt,
        "stage_a_compile_s": first_s,
        "stage_a_batch_per_chip": batch,
        "stage_a_dtype": dtype,
        "stage_a_global16_days_4chip": global_days_4chip,
        "stage_a_vs_ref_days": days / global_days_4chip,
    }


def bench_stage_b(iters=4, cfg=None, device=None):
    """One 32 Mb window a step (production StageBConfig by default)."""
    device = resolve_device(device)
    cfg = cfg or StageBConfig()
    geom = cfg.geometry
    opt, step = make_stage_b_step(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    trainable = {
        "pyramid": encoders.init_pyramid(gen, 5, True),
        "decoders": {lv: decoders.init_decoder(gen) for lv in cfg.levels},
    }
    frozen = {
        "encoder": fold_params(encoders.init_encoder_tower(gen),
                               encoders.encoder_tower_spec()),
        "decoder_1pt": fold_params(decoders.init_decoder1m(gen),
                                   decoders.decoder1m_spec(1)),
    }
    opt_state = opt.init(trainable)
    normmats, epss = zoo._random_normmats(nbins=geom.bins, crop=geom.crop)
    nm = torch.from_numpy(np.stack(
        [normmats[lv] for lv in cfg.levels]).astype(np.float32)).to(device)
    ep = torch.tensor([epss[lv] for lv in cfg.levels], dtype=torch.float32,
                      device=device)
    rng = np.random.RandomState(1)
    seq = _packed(rng, (1, geom.window_bp), device)
    target = torch.from_numpy(np.abs(
        rng.rand(1, geom.bins, geom.bins)).astype(np.float32)).to(device)
    key = rng_lib.key(3)
    state = {"t": trainable, "o": opt_state}

    def run():
        state["t"], state["o"], m = step(
            state["t"], frozen, state["o"], seq, target, key, LR, nm, ep,
        )
        return float(m["loss"])

    dt, first_s = _timeit(run, iters)
    steps, days = REF_STAGE_B
    return {
        "stage_b_seconds_per_step": dt,
        "stage_b_compile_s": first_s,
        "stage_b_run_days_1chip": steps * dt / 86400.0,
        "stage_b_vs_ref_days": days / (steps * dt / 86400.0),
    }


def bench_stage_c(iters=3, cfg=None, device=None):
    """One 256 Mb cross-chromosome window a step (production StageCConfig
    by default)."""
    device = resolve_device(device)
    cfg = cfg or StageCConfig()
    geom = cfg.geometry
    opt, step = make_stage_c_step(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(4)
    trainable = {
        "pyramid": encoders.init_pyramid(gen, 3, True),
        "decoders": {lv: decoders.init_decoder(gen) for lv in cfg.levels},
    }
    frozen = {
        "encoder": fold_params(encoders.init_encoder_tower(gen),
                               encoders.encoder_tower_spec()),
        "pyramid1": fold_params(encoders.init_pyramid(gen, 5, True),
                                encoders.pyramid_spec(5, True)),
    }
    opt_state = opt.init(trainable)
    rng = np.random.RandomState(2)
    seq = _packed(rng, (1, geom.window_bp), device)
    target = torch.from_numpy(np.abs(
        rng.rand(1, geom.bins, geom.bins)).astype(np.float32)).to(device)
    d = np.abs(np.arange(geom.bins)[None, :] - np.arange(geom.bins)[:, None])
    normmat = torch.from_numpy(
        np.exp(-1.2 * np.log1p(d) - 3.0).astype(np.float32)[None]).to(device)
    key = rng_lib.key(5)
    state = {"t": trainable, "o": opt_state}

    def run():
        state["t"], state["o"], m = step(
            state["t"], frozen, state["o"], seq, target, normmat, key, LR,
        )
        return float(m["loss"])

    dt, first_s = _timeit(run, iters)
    steps, days = REF_STAGE_C
    return {
        "stage_c_seconds_per_step": dt,
        "stage_c_compile_s": first_s,
        "stage_c_run_days_1chip": steps * dt / 86400.0,
        "stage_c_vs_ref_days": days / (steps * dt / 86400.0),
    }


def encoder_train_step(params, seq):
    """Stage a's differentiated encoder path on packed `seq`: the plain
    stages with live BatchNorm (batch statistics, `BNUpdates` recorded)
    under autograd, loss mean(out**2). Returns (loss, the gradient's sum
    per leaf, in the parameters' tree; 0 where a leaf takes no gradient,
    as the running statistics)."""
    leaves = tree_leaves(params)
    p = tree_unflatten(params, [t.detach().requires_grad_() for t in leaves])
    with nn_ops.full_fp32():
        out = encoders.apply_encoder_stages(
            p, seq.to(leaves[0].dtype) * 0.25, train=True,
            rng=rng_lib.key(0), bn_updates=BNUpdates(), path="encoder")
        loss = torch.mean(out.to(leaves[0].dtype) ** 2)
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True)
    sums = [torch.zeros((), dtype=t.dtype, device=t.device) if g is None
            else g.sum() for t, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, sums)


def encoder_forward(folded, seq):
    """The serving path: the folded tower on the fused conv-chain kernels
    (their plain versions on the CPU), in 4 Mb blocks with 112 kb halos."""
    return encoders.apply_encoder_tower(folded, seq)


def encoder_forward_stages(folded, seq):
    """The same folded tower as one piece on the plain stages (cuDNN)."""
    return encoders.apply_encoder_stages(folded, seq.float() * 0.25)


def bench_encoder_paths(batch=4, seq_len=1_000_000, iters=6, device=None):
    """The trainable-path encoder gap at the stage-a shape. The fused
    kernels need folded BatchNorm (inference), so training pays the plain
    stages. Three measurements, under the JAX script's keys:
      enc_fwd_pallas_s     the folded tower forward on the fused conv-chain
                           kernels (`encoder_forward`, serving);
      enc_fwd_xla_s        the same folded forward on the plain cuDNN stages
                           (`encoder_forward_stages`);
      enc_train_step_xla_s forward + backward of the unfolded tower with
                           live BatchNorm and `BNUpdates`, what stage a
                           differentiates (`encoder_train_step`);
    and enc_pallas_vs_xla_fwd, the second over the first. Batch 4 a card is
    stage a's (the JAX script's 16 under fp32 autograd without
    recomputation would save ~12 stage-0 activations of 4.1 GB). Each
    path's peak device memory goes to stderr. `device` None = CUDA."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(6)
    params = encoders.init_encoder_tower(gen)
    folded = fold_params(params, encoders.encoder_tower_spec())
    seq = _packed(np.random.RandomState(3), (batch, seq_len), device)

    def fwd():
        with torch.inference_mode():
            return fetch(encoder_forward(folded, seq))

    def fwd_xla():
        with torch.inference_mode():
            return fetch(encoder_forward_stages(folded, seq))

    def train_step():
        return fetch(encoder_train_step(params, seq)[0])

    out = {}
    for key, fn, n in (("enc_fwd_pallas_s", fwd, iters),
                       ("enc_fwd_xla_s", fwd_xla, iters),
                       ("enc_train_step_xla_s", train_step,
                        max(2, iters // 2))):
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        out[key], _ = _timeit(fn, n)
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device) / 2**30
            print(f"bench_training {key}: peak device memory {peak:.2f} GiB",
                  file=sys.stderr, flush=True)
    out["enc_pallas_vs_xla_fwd"] = (out["enc_fwd_xla_s"]
                                    / out["enc_fwd_pallas_s"])
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    which = set((argv[0] if argv else "a,b,c,enc").split(","))
    unknown = which - {"a", "b", "c", "enc"}
    if unknown:
        print(f"unknown stages {sorted(unknown)}: a, b, c and enc",
              file=sys.stderr)
        return 2
    device = resolve_device(None)
    result = {"device": torch.cuda.get_device_name(device)}
    if "a" in which:
        result.update(bench_stage_a())
        print(json.dumps(result), flush=True)
    if "b" in which:
        result.update(bench_stage_b())
        print(json.dumps(result), flush=True)
    if "c" in which:
        try:
            result.update(bench_stage_c())
        except Exception as e:  # noqa: BLE001 — the JAX script's contract
            traceback.print_exc()
            result["stage_c_error"] = f"{type(e).__name__}: {e}"
        print(json.dumps(result), flush=True)
    if "enc" in which:
        result.update(bench_encoder_paths())
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
