"""The port's product smoke (orca_tpu_torch/scripts/smoke_e2e.py) on the
CPU at a scaled geometry: the pipelines' 32 Mb window radius set to 256 kb
(and passed to `process_region` and `process_dup`) and the cascade's
geometry to CascadeGeometry(512_000, 4000, 4) (monkeypatched,
as tests/test_torch_pipelines.py does), the random bundle at that geometry,
and the encoder tower replaced by seeded features (its parity with the JAX
package is held by test_torch_encoders.py and test_torch_probes.py). The
genome, the region and dup pipelines, the decoders in bf16 and the plots run
for real: with `--plots pdf` the four PDFs are written (matplotlib is here),
with `--plots record` their names are recorded and nothing is drawn. The
record carries the JAX script's keys (read from its source) and the card's
fields; `merge_json` keeps what the file held."""

import ast
import functools
import json
import os
import pathlib

import pytest
import torch

from orca_tpu_torch.models import zoo
from orca_tpu_torch.nn import encoders as tenc
from orca_tpu_torch.predict import multiscale as tms
from orca_tpu_torch.predict import pipelines
from orca_tpu_torch.scripts import smoke_e2e
from test_torch_encoders import share_cpu_with_other_workers

share_cpu_with_other_workers()

REPO = pathlib.Path(__file__).resolve().parent.parent
GEOM = tms.CascadeGeometry(512_000, 4000, 4)


@pytest.fixture
def small(monkeypatch):
    radius = GEOM.window_bp // 2
    monkeypatch.setattr(pipelines, "WR32", radius)
    for name in ("process_region", "process_dup"):
        monkeypatch.setattr(pipelines, name, functools.partial(
            getattr(pipelines, name), window_radius=radius))
    monkeypatch.setattr(pipelines, "genomepredict", functools.partial(
        tms.genomepredict, geometry=GEOM))
    monkeypatch.setattr(zoo, "random_32m_bundle", functools.partial(
        zoo.random_32m_bundle, nbins=GEOM.bins, crop=GEOM.crop))

    def tower(params, x, **kw):
        gen = torch.Generator().manual_seed(int(x[0, :64].sum()))
        return torch.randn(x.shape[0], x.shape[1] // 4000, 128,
                           generator=gen).to(params["lconv"][0][0]["w"].dtype)

    monkeypatch.setattr(tenc, "apply_encoder_tower", tower)


def _jax_record_keys():
    tree = ast.parse((REPO / "scripts" / "smoke_e2e.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name) and n.func.id == "merge_json"
                and len(n.args) == 2)
    return {k.value for k in call.args[1].keys}


@pytest.mark.parametrize("plots", ["pdf", "record"])
def test_smoke_writes_or_records_the_four_pdfs(small, tmp_path, plots):
    out = tmp_path / "out"
    json_path = tmp_path / "record.json"
    json_path.write_text(json.dumps({"earlier": 1}))
    record = smoke_e2e.main(str(out), json_path=str(json_path), plots=plots,
                            device="cpu")
    assert json.loads(json_path.read_text()) == record
    assert record.pop("earlier") == 1
    assert set(record) == _jax_record_keys() | {"power_limit_w",
                                                "smoke_plots"}
    assert record["smoke_pdfs"] == smoke_e2e.PDFS
    assert record["smoke_plots"] == plots
    assert record["smoke_device"] == "cpu" and record["power_limit_w"] is None
    assert record["smoke_region_s_incl_compile"] > 0
    assert record["smoke_dup_screen_s"] > 0
    written = sorted(p for p in os.listdir(out) if p.endswith(".pdf"))
    assert written == (smoke_e2e.PDFS if plots == "pdf" else [])
