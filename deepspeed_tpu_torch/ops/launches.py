"""Every kernel wrapper's launch count, in one registry.

A wrapper adds to its kernel's entry of :data:`LAUNCHES` where it launches
the kernel and nowhere else: the plain version a CPU tensor takes counts
nothing. Each kernel module registers its entries at import and keeps
their names in its ``KERNELS``. A captured CUDA graph replays without
calling the wrappers, so :class:`~deepspeed_tpu_torch.utils.graphs.CapturedProgram`
records the whole registry's increase during its capture and adds it on
every replay.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

LAUNCHES: Dict[str, int] = {}


def register(*names: str) -> Tuple[str, ...]:
    """Entries at 0 for ``names`` → ``names`` (a module's ``KERNELS``)."""
    for name in names:
        LAUNCHES.setdefault(name, 0)
    return names


def counts(names: Iterable[str]) -> Dict[str, int]:
    """The entries of ``names`` now, by name."""
    return {name: LAUNCHES[name] for name in names}


def reset(names: Iterable[str] = ()) -> None:
    """Set the entries of ``names`` (every entry when none is given) to 0."""
    for name in tuple(names) or tuple(LAUNCHES):
        LAUNCHES[name] = 0
