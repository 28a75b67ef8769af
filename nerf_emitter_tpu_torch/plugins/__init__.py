"""Plugin registration for external methods and dataparsers (port of
nerf_emitter_tpu/plugins/).

Reference: nerfstudio/plugins/ (registry.py, registry_dataparser.py,
types.py).
"""

from .registry import discover_dataparsers, discover_methods
from .types import DataParserSpecification, MethodSpecification

__all__ = [
    "DataParserSpecification",
    "MethodSpecification",
    "discover_dataparsers",
    "discover_methods",
]
