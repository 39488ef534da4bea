"""The tenant manifest grammar (port of ``parse_manifest``,
``xgboost_tpu/catalog/catalog.py:52``), which ``task=lanes`` reads.
The rest of the catalog (multi-model serving) is ROADMAP.md section 1
item 15."""

from __future__ import annotations

from typing import Dict


def parse_manifest(spec: str) -> Dict[str, str]:
    """``name=path`` entries, inline and comma-separated
    (``a=./a.model,b=./b.model``) or one per line in a manifest file
    (``#`` comments allowed, the grammar of ``parse_config_file``).
    Entry order is kept."""
    if "=" not in spec:
        from xgboost_tpu_torch.config import parse_config_file
        return dict(parse_config_file(spec))
    out: Dict[str, str] = {}
    for p in (p for p in spec.split(",") if p.strip()):
        name, path = p.split("=", 1)
        name, path = name.strip(), path.strip()
        if not name or not path:
            raise ValueError(f"bad catalog manifest entry {p!r} "
                             "(want name=path)")
        out[name] = path
    if not out:
        raise ValueError(f"empty catalog manifest {spec!r}")
    return out
