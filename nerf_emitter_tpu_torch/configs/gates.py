"""Quality-gate defaults, read from the port's own `gates.json` (port of
nerf_emitter_tpu/configs/gates.py).

Performance levers (the distilled light-field emitter cache, the reduced
emitter sample schedule) become method defaults only after an end-task
quality A/B passes. The decision is a committed data file next to this
module, which `configs/methods.py` reads when a method's config is built;
a malformed file or an unknown gate name raises. The file is the port's
copy of the JAX package's; a test holds the two equal, so a gate decided
later is copied on purpose.
"""

from __future__ import annotations

import json
from pathlib import Path

_GATES_PATH = Path(__file__).resolve().parent / "gates.json"


def load_gates() -> dict:
    """Parse gates.json; a missing or malformed file raises."""
    raw = json.loads(_GATES_PATH.read_text())
    for name, entry in raw.items():
        if not isinstance(entry, dict) or "value" not in entry:
            raise ValueError(f"gates.json entry {name!r} must be an object with a 'value' key; got {entry!r}")
    return raw


def gate_default(name: str) -> bool:
    """The gated default for `name`; an unknown name raises KeyError."""
    gates = load_gates()
    if name not in gates:
        raise KeyError(f"unknown gate {name!r}; gates.json defines {sorted(gates)}")
    return bool(gates[name]["value"])


def write_gate(name: str, value: bool, decided_by: str, evidence: str, decided_at: str) -> None:
    """Record a gate decision, overwriting any earlier one for `name`. The
    gate must already exist in the file."""
    gates = load_gates()
    if name not in gates:
        raise KeyError(f"unknown gate {name!r}; add it to gates.json first so the read side exists before any "
                       "decision lands")
    gates[name] = {"value": bool(value), "decided_by": decided_by, "evidence": evidence, "decided_at": decided_at}
    _GATES_PATH.write_text(json.dumps(gates, indent=2) + "\n")
