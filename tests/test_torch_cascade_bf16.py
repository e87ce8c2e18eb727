"""The port's 32 Mb cascade in bf16 (the serving precision) against the JAX
package's `genomepredict`: zoom starts equal, and the port's maps within
twice the JAX cascade's own bf16-vs-fp32 difference on the same bf16-rounded
parameters.

XLA:CPU has no native bf16 convolutions, so the JAX bf16 cascade compiles and
runs slowly there. The check therefore runs at CascadeGeometry(512_000, 4000,
4), half the fp32 test's window with the same six levels, and compiles the
JAX programs of both precisions concurrently first (`warmup_cascade_32m`).
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from orca_tpu.models import zoo as jzoo
from orca_tpu.predict import multiscale as jms
from orca_tpu_torch.models import zoo as tzoo
from orca_tpu_torch.models.from_jax import bundle_from_numpy
from orca_tpu_torch.predict import multiscale as tms
from test_torch_cascade import jax_bundle, sequence

GEOM_J = jms.CascadeGeometry(512_000, 4000, 4)
GEOM_T = tms.CascadeGeometry(512_000, 4000, 4)
WPOS = GEOM_J.window_bp // 2


def test_genomepredict_bf16_within_bf16_noise():
    jb16 = jzoo.cast_bundle(jax_bundle(seed=1, geom=GEOM_J), "bfloat16")
    # fp32 on the bf16-rounded parameters: the cascade's own rounding noise
    jb32 = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if getattr(a, "dtype", None) == jnp.bfloat16 else a, jb16)
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(jms.warmup_cascade_32m, b, GEOM_J)
                  for b in (jb16, jb32)]:
            f.result()
    host = jax.tree.map(np.asarray, jb32)
    tb16 = tzoo.cast_bundle(bundle_from_numpy(host, "cpu"), "bfloat16")
    seq = sequence(7, GEOM_J)
    mpos = int(GEOM_J.window_bp * 0.3)
    want16 = jms.genomepredict(seq, "c", mpos, WPOS, [jb16], geometry=GEOM_J)
    want32 = jms.genomepredict(seq, "c", mpos, WPOS, [jb32], geometry=GEOM_J)
    got = tms.genomepredict(seq, "c", mpos, WPOS, [tb16], geometry=GEOM_T,
                            device="cpu")
    assert got["start_coords"] == want16["start_coords"]
    assert len(got["predictions"][0]) == 6
    noise = max(np.abs(a - b).max() for a, b in zip(want16["predictions"][0],
                                                     want32["predictions"][0]))
    d = max(np.abs(a - b).max() for a, b in zip(got["predictions"][0],
                                                 want16["predictions"][0]))
    assert noise > 0
    assert d <= 2 * noise, (d, noise)
