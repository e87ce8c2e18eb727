"""What the scripts share: the card's fields of a JSON line, the host fetch
that ends a timed run, and the check that plots can be drawn."""

from __future__ import annotations

import subprocess

import torch

from orca_tpu_torch.utils.tree import tree_leaves


def card_fields(device: torch.device) -> dict:
    """{"device": the card's name (str(device) off the card),
    "power_limit_w": its power limit in W (None off the card)}."""
    # imported here: bench imports bench_training, which imports this module
    from orca_tpu_torch.bench import _power_limit_w

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    return {"device": name, "power_limit_w": _power_limit_w(device)}


def print_card(card: dict) -> None:
    """The probes' last line: the card's name and power limit."""
    print(f"device: {card['device']}, power limit {card['power_limit_w']} W",
          flush=True)


def smi_card_fields(index: int = 0) -> dict:
    """`card_fields` of card `index` read from nvidia-smi alone, for a
    process that must not open CUDA itself."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    name, limit = (s.strip() for s in out.strip().splitlines()[0].split(","))
    return {"device": name, "power_limit_w": float(limit)}


def fetch(out) -> float:
    """End a timed run: wait for the card, then fetch the sum of every
    tensor in `out` (a tensor or a nesting of them) to the host."""
    leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    if any(t.is_cuda for t in leaves):
        torch.cuda.synchronize()
    return float(sum(t.float().sum() for t in leaves))


def require_matplotlib(driver: str) -> None:
    """Raise, naming `--plots record`, when matplotlib cannot be imported:
    the PDFs need it."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            f"{driver}: matplotlib is not importable ({e}), so no PDF can be "
            "drawn; pass --plots record to record the plots' file names "
            "instead") from e
