"""The JAX package's drivers (its `scripts/` directory) on the CUDA card:
each `scripts/X.py` that drives `orca_tpu` has its counterpart here as
`orca_tpu_torch/scripts/X.py`, run as `python -m orca_tpu_torch.scripts.X`
with the JAX script's defaults, JSON keys and printed labels, plus the
card's name and power limit.

  bench_serve_screen  seconds per variant of a dup/del screen through one
                      warm `serve` process (both 32 Mb models, bf16)
  measure_loader      the prefetch loader's batches/s, packed and float32
  profile_cascade     each step of a bf16 32 Mb request, timed
  probe_two_model     two models in turn against two models stacked
  probe_decoder       one decoder level, its 28 dilated blocks, one conv per
                      dilation and two matmul ceilings
  smoke_e2e           genome -> region and dup screens -> the four PDFs
  bench_256m          the 256 Mb whole-chromosome cascade's throughput

The JAX script's `bench_training.py enc` mode is `python -m
orca_tpu_torch.bench_training enc`.
"""
