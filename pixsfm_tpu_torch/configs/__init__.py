"""Named config presets (reference: pixsfm/configs/__init__.py).

Port of ``pixsfm_tpu/configs/__init__.py``: the YAML presets of this
package by name."""

from pathlib import Path

__all__ = ["parse_config_path", "list_configs"]


def parse_config_path(name_or_path) -> Path:
    """An existing path as given, else the preset ``<name>.yaml`` of this
    package; ``FileNotFoundError`` names the presets otherwise."""
    p = Path(str(name_or_path))
    if p.exists():
        return p
    p = Path(__file__).parent / f"{name_or_path}.yaml"
    if p.exists():
        return p
    raise FileNotFoundError(
        f"config {name_or_path!r} not found; available: {list_configs()}")


def list_configs():
    """The preset names, sorted."""
    return sorted(p.stem for p in Path(__file__).parent.glob("*.yaml"))
