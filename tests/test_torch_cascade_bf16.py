"""The port's 32 Mb cascade in bf16 (the serving precision) against the JAX
package's `genomepredict`: zoom starts equal, and the port's maps within
twice the JAX cascade's own bf16-vs-fp32 difference on the same bf16-rounded
parameters.

XLA:CPU has no native bf16 convolutions, so the JAX bf16 cascade compiles and
runs slowly there. The check therefore runs at CascadeGeometry(512_000, 4000,
4), half the fp32 test's window with the same six levels, and compiles the
JAX programs of both precisions concurrently first (`warmup_cascade_32m`),
for the 32 Mb bundle and for a 6-head leukemia bundle (JAX
`random_leukemia_bundle`), which is held to the same bar.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orca_tpu.models import zoo as jzoo
from orca_tpu.predict import multiscale as jms
from orca_tpu_torch.models import zoo as tzoo
from orca_tpu_torch.models.from_jax import bundle_from_numpy
from orca_tpu_torch.predict import multiscale as tms
from test_torch_cascade import jax_bundle, sequence
from test_torch_variants import jax_variant

GEOM_J = jms.CascadeGeometry(512_000, 4000, 4)
GEOM_T = tms.CascadeGeometry(512_000, 4000, 4)
WPOS = GEOM_J.window_bp // 2


def bf16_pair(jbundle):
    """(bf16 JAX bundle, fp32 JAX bundle on the same bf16-rounded
    parameters): the second gives the cascade's own rounding noise."""
    jb16 = jzoo.cast_bundle(jbundle, "bfloat16")
    jb32 = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if getattr(a, "dtype", None) == jnp.bfloat16 else a, jb16)
    return jb16, jb32


@pytest.fixture(scope="module")
def pairs():
    """The 32 Mb and leukemia pairs, all four JAX programs compiled
    concurrently."""
    out = {"32m": bf16_pair(jax_bundle(seed=1, geom=GEOM_J)),
           "leukemia6": bf16_pair(jax_variant("leukemia6", 5, GEOM_J))}
    with ThreadPoolExecutor(4) as ex:
        for f in [ex.submit(jms.warmup_cascade_32m, b, GEOM_J)
                  for pair in out.values() for b in pair]:
            f.result()
    return out


def check_within_bf16_noise(jb16, jb32):
    """The port's bf16 maps (from jb32's parameters cast to bf16) against
    the JAX bf16 cascade; returns the port's maps."""
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
    return got["predictions"][0]


def test_genomepredict_bf16_within_bf16_noise(pairs):
    check_within_bf16_noise(*pairs["32m"])


def test_leukemia_bf16_within_bf16_noise(pairs):
    """6 heads in bf16, the serving precision of the leukemia models."""
    maps = check_within_bf16_noise(*pairs["leukemia6"])
    assert [p.shape for p in maps] == [(6, GEOM_J.crop, GEOM_J.crop)] * 6
