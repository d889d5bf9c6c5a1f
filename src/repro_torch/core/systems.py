"""Canonical system-name handling.

Port copy of ``repro.core.systems``: the same plain Python (it imports
no JAX, but ``repro``'s package does, so ``repro_torch`` keeps its
own copy).

The paper speaks three dialects for the same two fabrics: the body says
"memristor" and "digital", Tables I–VI say "1t1m" and "digital", and the
SRAM decompositions in §IV.B are keyed "sram". The codebase grew the
same aliases ad hoc (``compile_chip`` accepted ``"1t1m"``,
``specialized_cost`` silently treated anything non-"memristor" as
digital). This module is the one place the aliasing lives: every entry
point normalizes first and passes only canonical names downstream.
"""
from __future__ import annotations

from typing import Tuple

#: The two fabrics everything downstream dispatches on.
CANONICAL_SYSTEMS: Tuple[str, str] = ("memristor", "digital")

#: alias → canonical. "crossbar" / "digital" are also the
#: :class:`repro_torch.core.crossbar_layer.ProgrammedMLP` mode names,
#: so a mode string normalizes too.
SYSTEM_ALIASES = {
    "memristor": "memristor",
    "1t1m": "memristor",
    "crossbar": "memristor",
    "digital": "digital",
    "sram": "digital",
}


def normalize_system(system: str, *, context: str = "system") -> str:
    """Map any accepted system alias to its canonical name
    (``"memristor"`` or ``"digital"``); raise ``ValueError`` with the
    accepted spellings otherwise."""
    try:
        key = system.strip().lower()
    except AttributeError:
        raise TypeError(f"{context}: system must be a string, got "
                        f"{type(system).__name__}") from None
    canon = SYSTEM_ALIASES.get(key)
    if canon is None:
        raise ValueError(
            f"{context}: unknown system {system!r} (accepted: "
            f"{sorted(SYSTEM_ALIASES)})")
    return canon


def system_mode(system: str, *, context: str = "system") -> str:
    """The :func:`repro_torch.core.crossbar_layer.program_mlp` mode for
    a system name: memristor fabrics program crossbar tiles, digital
    fabrics program SRAM images."""
    return "crossbar" if normalize_system(system, context=context) == \
        "memristor" else "digital"
